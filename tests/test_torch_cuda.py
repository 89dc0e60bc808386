"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version, on
the card. Skips where there is no CUDA device; decided inside the test so
every pytest worker collects the same tests. Imports no JAX, so it runs on
a machine without it:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py:126


def _ids_equal_up_to_near_ties(s_ref, i_ref, s_got, i_got, eps=1e-5):
    """Ids must match, except where the plain version's neighbouring scores
    lie within ``eps``, or, in the last slot, where the kernel's doc scores
    within ``eps`` of the plain version's (the kernel sums in another
    order, so a near-tie may swap, also across the cut)."""
    s_ref, i_ref, s_got, i_got = (np.asarray(x.cpu())
                                  for x in (s_ref, i_ref, s_got, i_got))
    k = s_ref.shape[1]
    for b, j in zip(*np.nonzero(i_ref != i_got)):
        near = [abs(s_ref[b, j] - s_ref[b, jj]) <= eps
                for jj in (j - 1, j + 1) if 0 <= jj < k]
        at_cut = j == k - 1 and abs(s_got[b, j] - s_ref[b, j]) <= eps
        assert any(near) or at_cut, (b, j, s_ref[b, max(j - 1, 0):j + 2])


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import gram, pca_project, topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # gram: ragged n and d, f32 and bf16; n = 10 is one row range (no
    # second pass). Only the upper tiles are computed, then mirrored: the
    # result is exactly symmetric.
    for n, d, dtype in [(1000, 96, torch.float32), (5000, 200, torch.float32),
                        (3001, 128, torch.bfloat16), (10, 300, torch.float32)]:
        D = randn(n, d).to(dtype)
        G = gram.gram_cuda(D)
        torch.testing.assert_close(G, gram.gram_plain(D), rtol=1e-4, atol=1e-3)
        assert torch.equal(G, G.T)

    # pca_project (+ quant epilogue)
    for n, d, m, dtype in [(1000, 96, 48, torch.float32),
                           (777, 130, 200, torch.float32),
                           (513, 64, 32, torch.bfloat16)]:
        D, W = randn(n, d).to(dtype), randn(d, m)
        got = pca_project.pca_project_cuda(D, W)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(),
                                   pca_project.pca_project_plain(D, W).float(),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-4,
                                   atol=1e-2 if dtype == torch.bfloat16 else 1e-4)
        if dtype == torch.float32:
            scale = (D @ W).abs().amax(0) / 127.0
            q = pca_project.pca_project_quant_cuda(D, W, scale)
            want = pca_project.pca_project_quant_plain(D, W, scale)
            diff = (q.int() - want.int()).abs()
            assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.999

    # topk_score: ragged n, k > n, n_valid mid-chunk, shuffled row_ids with
    # masked rows, every storage dtype; m = 130 (not a multiple of 16)
    # takes the chunk kernel's element-wise loader
    for n, m, B, k in [(1000, 64, 8, 10), (5000, 384, 32, 100),
                       (3000, 48, 40, 1000), (700, 16, 3, 1000),
                       (1300, 130, 7, 10), (2100, 130, 33, 1000)]:
        D, Q = randn(n, m), randn(B, m)
        row_ids = torch.randperm(n, generator=g, device=dev).to(torch.int32) + 1000
        row_ids[torch.randperm(n, generator=g, device=dev)[:n // 10]] = -1
        for store in ("f32", "bf16", "int8"):
            Dx, Qx = D, Q
            if store == "bf16":
                Dx = D.to(torch.bfloat16)
            elif store == "int8":
                Dx, scale = quantize_int8_per_dim(D)
                Qx = (Q * scale[None, :]).contiguous()
            for kw in ({}, {"n_valid": n - 300}, {"row_ids": row_ids}):
                s1, i1 = topk_score.topk_score_cuda(Dx, Qx, k=k, **kw)
                s2, i2 = topk_score.topk_score_plain(Dx, Qx, k=k, **kw)
                torch.testing.assert_close(s1, s2, **TOL)
                _ids_equal_up_to_near_ties(s2, i2, s1, i1)

    # all rows tied across chunks: ids are exactly 0..k-1
    row = randn(32)
    D = row[None, :].repeat(2000, 1).contiguous()
    Q = torch.stack([row, 2 * row]).contiguous()
    for k in (9, 100):
        _, ids = topk_score.topk_score_cuda(D, Q, k=k)
        assert (ids.cpu() == torch.arange(k)[None, :]).all()

    # row_ids: non-ascending ids, the smaller tied id sits in a later chunk
    m = 16
    D = torch.zeros(1024, m, device=dev)
    D[:, 0] = torch.linspace(0.5, 2.0, 1024, device=dev)
    D[3, 0] = D[600, 0] = 5.0
    row_ids = torch.arange(1024, dtype=torch.int32, device=dev) + 100
    row_ids[3], row_ids[600], row_ids[10] = 50, 7, -1
    Q = torch.zeros(1, m, device=dev)
    Q[0, 0] = 1.0
    for k in (1, 40):
        s1, i1 = topk_score.topk_score_cuda(D, Q, k=k, row_ids=row_ids)
        s2, i2 = topk_score.topk_score_plain(D, Q, k=k, row_ids=row_ids)
        assert int(i1[0, 0]) == 7 and float(s1[0, 0]) == 5.0
        assert (i1 == i2).all()
        torch.testing.assert_close(s1, s2, **TOL)

    # no k cap: k beyond 1024 takes the radix select, k > n pads
    for k in (1025, 2000):
        s1, i1 = topk_score.topk_score_cuda(D, Q, k=k, row_ids=row_ids)
        s2, i2 = topk_score.topk_score_plain(D, Q, k=k, row_ids=row_ids)
        assert torch.equal(i1, i2)
        torch.testing.assert_close(s1, s2, **TOL)

    # the counters: one call in row_ids mode, and the CUDA launches its C
    # entry reports (the chunk kernel and at least one merge level)
    calls = dict(topk_score.topk_score_cuda.launches)
    cuda = dict(topk_score.topk_score_cuda.cuda_launches)
    topk_score.topk_score_cuda(D, Q, k=40, row_ids=row_ids)
    assert topk_score.topk_score_cuda.launches["row_ids"] == calls["row_ids"] + 1
    assert topk_score.topk_score_cuda.launches["f32"] == calls["f32"]
    assert topk_score.topk_score_cuda.cuda_launches["row_ids"] >= cuda["row_ids"] + 2

    # topk_score_paged: a scrambled pool/tail table with a ragged last page,
    # per-page int8 scales, lo > 0, k beyond the live rows, a carry split
    # (the un-finalized pad ids equal exactly), ids_pool out of order with
    # masked rows; pages below, at and above the kernel's 256/512-row pieces
    paged, paged_plain = topk_score.topk_score_paged_cuda, topk_score.topk_score_paged_plain
    for n, m, R, B, k in [(3000, 384, 256, 32, 10), (1300, 130, 512, 7, 100),
                          (2100, 48, 700, 33, 1000), (200, 16, 8, 3, 300)]:
        npages = -(-n // R)
        phys = npages + 3
        P = phys // 2
        cap = npages + 4
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        pt = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        pt[:npages] = torch.randperm(phys, generator=g, device=dev)[:npages].int()
        nv = torch.zeros(cap, dtype=torch.int32, device=dev)
        nv[:npages] = R
        nv[npages - 1] = n - (npages - 1) * R
        off = torch.zeros(cap, dtype=torch.int32, device=dev)
        off[:npages] = torch.arange(npages, dtype=torch.int32, device=dev) * R
        ids = torch.full((cap, R), -1, dtype=torch.int32, device=dev)
        ids.view(-1)[:npages * R] = torch.randperm(
            npages * R, generator=g, device=dev).int() + 100
        ids.view(-1)[torch.randperm(npages * R, generator=g, device=dev)[:R]] = -1
        for store in ("f32", "bf16", "int8"):
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                     "int8": torch.int8}[store]
            pool = torch.zeros((P, R, m), dtype=dtype, device=dev)
            tail = torch.zeros((phys - P, R, m), dtype=dtype, device=dev)
            scale = torch.zeros((cap, m), device=dev) if store == "int8" else None
            for j in range(npages):
                rows = D[j * R:j * R + int(nv[j])]
                if scale is not None:
                    scale[j] = rows.abs().amax(0).clamp_min(1e-12) / 127.0
                    rows = torch.round(rows / scale[j]).clamp(-127, 127)
                p = int(pt[j])
                (pool[p] if p < P else tail[p - P])[:rows.shape[0]] = rows.to(dtype)
            args = (pool, pt, nv, off)
            kw = dict(k=k, tail=tail, page_scale=scale)
            for lo, extra in ((0, {}), (min(2, npages - 1), {}), (0, {"ids_pool": ids})):
                s1, i1 = paged(*args, lo, npages, Q, **kw, **extra)
                s2, i2 = paged_plain(*args, lo, npages, Q, **kw, **extra)
                torch.testing.assert_close(s1, s2, **TOL)
                _ids_equal_up_to_near_ties(s2, i2, s1, i1)
            split = npages // 2
            h1 = paged(*args, 0, split, Q, **kw, finalize=False)
            h2 = paged_plain(*args, 0, split, Q, **kw, finalize=False)
            pad = torch.isneginf(h2[0])
            assert torch.equal(torch.isneginf(h1[0]), pad)
            assert torch.equal(h1[1][pad], h2[1][pad])
            s1, i1 = paged(*args, split, npages, Q, **kw, carry=h1)
            s2, i2 = paged_plain(*args, split, npages, Q, **kw, carry=h2)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)

    calls = dict(paged.launches)
    paged(*args, 0, npages, Q, k=10, tail=tail, page_scale=scale)
    assert paged.launches["paged_int8"] == calls["paged_int8"] + 1
    torch.cuda.synchronize()


def _paged_view(D: torch.Tensor, R: int, scale: torch.Tensor | None):
    """D's rows in pages of R rows, in order, one scale row per page."""
    n, m = D.shape
    npages = -(-n // R)
    pool = D.new_zeros((npages, R, m))
    pool.view(-1, m)[:n] = D
    dev = D.device
    pt = torch.arange(npages, dtype=torch.int32, device=dev)
    nv = torch.full((npages,), R, dtype=torch.int32, device=dev)
    nv[-1] = n - (npages - 1) * R
    off = pt * R
    ps = None if scale is None else scale[None, :].repeat(npages, 1).contiguous()
    return (pool, pt, nv, off), ps, npages


@pytest.mark.gpu
def test_cuda_kernels_tile_edges():
    """The redesigned chunk and projection kernels at their tile edges: n one
    row either side of the 512-row chunk and 128-row tile, and of several
    chunks per CTA; m off the 16-deep slab, one, two and three query tiles,
    k on both sides of the register / shared-memory select; the dense kernel
    bitwise equal to the paged one on the same contents, and the projection
    of a row range bitwise equal to the same rows of the whole projection
    (no split over d)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import pca_project, topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # the chunk kernel is persistent (one CTA per SM and query tile walks
    # chunks, carrying a running list per query): n of three chunks per SM
    # gives every CTA several chunks, with whole chunks masked by n_valid
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    walk = 3 * sms * 512 + 1
    cases = [(511, 384, 1, 1, 510), (513, 384, 33, 32, 512), (1023, 130, 65, 33, 1022),
             (1025, 16, 33, 1000, 1024), (1536, 130, 1, 33, 1535),
             (2049, 384, 65, 1000, 2048), (512, 16, 65, 32, 511), (1024, 768, 33, 10, 1023)]
    cases += [(walk, 48, B, k, walk // 2 + 37) for B in (1, 33, 65) for k in (1, 32, 33, 100)]
    for n, m, B, k, n_valid in cases:
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        row_ids = torch.randperm(n, generator=g, device=dev).to(torch.int32)
        row_ids[::9] = -1
        for store in ("f32", "bf16", "int8"):
            Dx, Qx = D, Q
            if store == "bf16":
                Dx = D.to(torch.bfloat16)
            elif store == "int8":
                Dx, scale = quantize_int8_per_dim(D)
                Qx = (Q * scale[None, :]).contiguous()
            for kw in ({}, {"n_valid": n_valid}, {"row_ids": row_ids}):
                s1, i1 = topk_score.topk_score_cuda(Dx, Qx, k=k, **kw)
                s2, i2 = topk_score.topk_score_plain(Dx, Qx, k=k, **kw)
                torch.testing.assert_close(s1, s2, **TOL)
                _ids_equal_up_to_near_ties(s2, i2, s1, i1)

    # dense == paged, bitwise: both score with the same fmaf chain over m
    for n, m, R, B, k in [(3001, 384, 256, 32, 10), (1300, 130, 512, 33, 100)]:
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        for store in ("f32", "int8"):
            scale = None
            Dx, Qd = D, Q
            if store == "int8":
                Dx, scale = quantize_int8_per_dim(D)
                Qd = (Q * scale[None, :]).contiguous()
            args, ps, npages = _paged_view(Dx, R, scale)
            dense = topk_score.topk_score_cuda(Dx, Qd, k=k)
            paged = topk_score.topk_score_paged_cuda(*args, 0, npages, Q, k=k,
                                                     page_scale=ps)
            assert torch.equal(dense[0], paged[0]) and torch.equal(dense[1], paged[1])

    # a row range's projection is bitwise those rows of the whole one
    for n, d, m, a, b, dtype in [(4099, 768, 384, 129, 3000, torch.float32),
                                 (1000, 200, 130, 37, 900, torch.float32),
                                 (777, 768, 384, 3, 700, torch.bfloat16)]:
        D, W = randn(n, d).to(dtype), randn(d, m)
        whole = pca_project.pca_project_cuda(D, W)
        part = pca_project.pca_project_cuda(D[a:b].contiguous(), W)
        assert torch.equal(whole[a:b], part)
        torch.testing.assert_close(whole.float(),
                                   pca_project.pca_project_plain(D, W).float(),
                                   rtol=1e-2 if dtype == torch.bfloat16 else 1e-4,
                                   atol=1e-2 if dtype == torch.bfloat16 else 1e-4)
        if dtype == torch.float32:
            scale = (whole.abs().amax(0) / 127.0).contiguous()
            q = pca_project.pca_project_quant_cuda(D, W, scale)
            assert torch.equal(q[a:b], pca_project.pca_project_quant_cuda(
                D[a:b].contiguous(), W, scale))
    torch.cuda.synchronize()


def _scrambled_pages(D, R, g, *, quantize=False, masked=0, scale_block=1):
    """D's rows in pages of R rows over a scrambled pool + tail layout, with
    `masked` table entries naming no page, int8 scales shared by blocks of
    `scale_block` pages (so neighbouring blocks differ) and an ids_pool of
    shuffled ids, a tenth negative. Built without a loop over pages."""
    n, m = D.shape
    dev = D.device
    npages = -(-n // R)
    phys_total = npages + 5
    P = phys_total // 2
    Dp = D.new_zeros((npages * R, m))
    Dp[:n] = D
    pages = Dp.view(npages, R, m)
    scale = None
    if quantize:
        nb = -(-npages // scale_block)
        blocks = pages.new_zeros((nb * scale_block, R, m))
        blocks[:npages] = pages
        amax = blocks.view(nb, scale_block * R, m).abs().amax(1)
        scale = (amax.clamp_min(1e-12) / 127.0).repeat_interleave(scale_block, 0)[:npages]
        scale = scale.contiguous()                                    # (npages, m)
        pages = torch.clamp(torch.round(pages / scale[:, None, :]), -127, 127).to(torch.int8)
    store = pages.new_zeros((phys_total, R, m))
    perm = torch.randperm(phys_total, generator=g, device=dev)[:npages]
    store[perm] = pages
    pt = perm.to(torch.int32)
    if masked:
        hole = torch.randperm(npages, generator=g, device=dev)[:masked]
        pt[hole[: masked // 2]] = -1
        pt[hole[masked // 2:]] = phys_total + 7            # in neither tier
    nv = torch.full((npages,), R, dtype=torch.int32, device=dev)
    nv[-1] = n - (npages - 1) * R
    off = torch.arange(npages, dtype=torch.int32, device=dev) * R
    ids = torch.randperm(npages * R, generator=g, device=dev).to(torch.int32).view(npages, R)
    ids.view(-1)[torch.randperm(npages * R, generator=g, device=dev)[:npages * R // 10]] = -1
    return ((store[:P].contiguous(), pt, nv, off), dict(tail=store[P:].contiguous(),
                                                      page_scale=scale), ids, npages)


@pytest.mark.gpu
def test_cuda_topk_any_k(monkeypatch):
    """k above 32 takes the list-and-radix-select path, with no cap: k in
    {33, 1025, 2048, n, n + 7}, dense and paged, in plain, n_valid, row_ids,
    ids_pool, carry and un-finalized modes, against the plain versions; the
    select alone against its plain version; and across the boundary the top
    32 equal bitwise the first 32 slots of the top 33."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import ref, topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    cuda, plain = topk_score.topk_score_cuda, topk_score.topk_score_plain
    n, m, B = 3000, 48, 33
    D, Q = randn(n, m) / m ** 0.5, randn(B, m)
    row_ids = torch.randperm(n, generator=g, device=dev).to(torch.int32) + 5
    row_ids[::11] = -1
    for store in ("f32", "int8"):
        Dx, Qx = D, Q
        if store == "int8":
            Dx, scale = quantize_int8_per_dim(D)
            Qx = (Q * scale[None, :]).contiguous()
        for k in (33, 1025, 2048, n, n + 7):
            for kw in ({}, {"n_valid": n - 700}, {"row_ids": row_ids}):
                s1, i1 = cuda(Dx, Qx, k=k, **kw)
                s2, i2 = plain(Dx, Qx, k=k, **kw)
                torch.testing.assert_close(s1, s2, **TOL)
                _ids_equal_up_to_near_ties(s2, i2, s1, i1)
        # a call whose scratch passes SCRATCH_BYTES walks its queries in
        # groups of 32-query tiles
        Q3 = torch.cat([Qx, Qx, Qx, Qx[:5]]).contiguous()                # 104 queries
        with monkeypatch.context() as mp:
            mp.setattr(topk_score, "SCRATCH_BYTES", 1 << 20)
            for kw in ({}, {"row_ids": row_ids}):
                s1, i1 = cuda(Dx, Q3, k=1025, **kw)
                s2, i2 = plain(Dx, Q3, k=1025, **kw)
                torch.testing.assert_close(s1, s2, **TOL)
                _ids_equal_up_to_near_ties(s2, i2, s1, i1)
        # the boundary: both paths keep one total order
        s32, i32 = cuda(Dx, Qx, k=32)
        s33, i33 = cuda(Dx, Qx, k=33)
        assert torch.equal(s32, s33[:, :32]) and torch.equal(i32, i33[:, :32])

    # the select alone, on keys with duplicates (masked rows as pads)
    s = randn(5, 20000)
    ids = torch.arange(20000, device=dev, dtype=torch.int32).expand(5, -1)
    s[:, ::3] = float("-inf")
    keys = (ref._keys(s, ids) ^ topk_score._SIGN).contiguous()
    for k in (33, 7000, 20000, 20010):
        for fin in (True, False):
            got = topk_score.topk_select_cuda(keys, k, finalize=fin)
            want = topk_score.topk_select_plain(keys, k, finalize=fin)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    # paged: R off and on the 64-row unit, tail pages, masked entries,
    # per-page int8 scales, ids_pool, a carry and un-finalized pads
    paged, pplain = topk_score.topk_score_paged_cuda, topk_score.topk_score_paged_plain
    for R, m, k in [(100, 48, 1025), (256, 130, 2048), (600, 64, n)]:
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        for quant in (False, True):
            args, kw, ids, npages = _scrambled_pages(D, R, g, quantize=quant, masked=2)
            split = npages // 2
            for k_ in (k, n + 7):
                for extra in ({}, {"ids_pool": ids}):
                    s1, i1 = paged(*args, 0, npages, Q, k=k_, **kw, **extra)
                    s2, i2 = pplain(*args, 0, npages, Q, k=k_, **kw, **extra)
                    torch.testing.assert_close(s1, s2, **TOL)
                    _ids_equal_up_to_near_ties(s2, i2, s1, i1)
                h1 = paged(*args, 0, split, Q, k=k_, **kw, finalize=False)
                h2 = pplain(*args, 0, split, Q, k=k_, **kw, finalize=False)
                pad = torch.isneginf(h2[0])
                assert torch.equal(torch.isneginf(h1[0]), pad)
                assert torch.equal(h1[1][pad], h2[1][pad])
                for fin in (True, False):
                    s1, i1 = paged(*args, split, npages, Q, k=k_, **kw, carry=h1, finalize=fin)
                    s2, i2 = pplain(*args, split, npages, Q, k=k_, **kw, carry=h2, finalize=fin)
                    torch.testing.assert_close(s1, s2, **TOL)
                    _ids_equal_up_to_near_ties(s2, i2, s1, i1)
                    pad = torch.isneginf(s2)
                    assert torch.equal(i1[pad], i2[pad])
    calls = dict(topk_score.topk_select_cuda.launches)
    paged(*args, 0, npages, Q, k=100, **kw)
    assert topk_score.topk_select_cuda.launches["paged_int8"] == calls["paged_int8"] + 1
    # grouped queries in a paged call, with a carry split across groups
    Q3 = torch.cat([Q, Q, Q, Q[:5]]).contiguous()
    with monkeypatch.context() as mp:
        mp.setattr(topk_score, "SCRATCH_BYTES", 1 << 20)
        h1 = paged(*args, 0, split, Q3, k=1025, **kw, finalize=False)
        h2 = pplain(*args, 0, split, Q3, k=1025, **kw, finalize=False)
        s1, i1 = paged(*args, split, npages, Q3, k=1025, **kw, carry=h1)
        s2, i2 = pplain(*args, split, npages, Q3, k=1025, **kw, carry=h2)
        torch.testing.assert_close(s1, s2, **TOL)
        _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_paged_walk():
    """The paged row source under the persistent walk: more chunks than
    CTAs, so every CTA carries its running threshold across many pages;
    R in {100, 256, 600} (units past a page, pages split over chunks),
    masked table entries, tail pages, scale rows that differ between
    neighbours, ragged m; k small and large. With one scale row for every
    page and R = 256 the paged search is bitwise the dense one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 3 * sms * 512 + 77
    paged, pplain = topk_score.topk_score_paged_cuda, topk_score.topk_score_paged_plain
    for R, m in [(100, 48), (256, 130), (600, 48)]:
        D = torch.randn(n, m, generator=g, device=dev) / m ** 0.5
        Q = torch.randn(33, m, generator=g, device=dev)
        # f32; int8 with a scale row per page (every chunk folds at read
        # time) and per block of 7 pages (the tile refolds where it changes)
        for quant, block in ((False, 1), (True, 1), (True, 7)):
            args, kw, ids, npages = _scrambled_pages(D, R, g, quantize=quant, masked=6,
                                                     scale_block=block)
            for k in (1, 10, 32, 100):
                for lo, extra in ((0, {}), (3, {}), (0, {"ids_pool": ids})):
                    s1, i1 = paged(*args, lo, npages, Q, k=k, **kw, **extra)
                    s2, i2 = pplain(*args, lo, npages, Q, k=k, **kw, **extra)
                    torch.testing.assert_close(s1, s2, **TOL)
                    _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    # dense == paged, bitwise, over a walk of many chunks per CTA
    D = torch.randn(n, 384, generator=g, device=dev) / 384 ** 0.5
    Q = torch.randn(32, 384, generator=g, device=dev)
    for store in ("f32", "int8"):
        scale = None
        Dx, Qd = D, Q
        if store == "int8":
            Dx, scale = quantize_int8_per_dim(D)
            Qd = (Q * scale[None, :]).contiguous()
        args, ps, npages = _paged_view(Dx, 256, scale)
        for k in (10, 100, 2000):
            dense = topk_score.topk_score_cuda(Dx, Qd, k=k)
            pg = paged(*args, 0, npages, Q, k=k, page_scale=ps)
            assert torch.equal(dense[0], pg[0]) and torch.equal(dense[1], pg[1])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_topk_any_batch():
    """B = 65,537 queries, past one launch's 65,535 query rows: the dense
    top-k (f32 and int8, k = 10 and the select path at k = 100), the paged
    top-k over the same rows, the select alone and ``DenseIndex.search``
    against their plain versions; the last query's row bitwise equal to a
    one-query call (each group of queries is its own C call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import ref, topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    n, m, B = 4096, 64, 65537
    D = torch.randn(n, m, generator=g, device=dev) / m ** 0.5
    Q = torch.randn(B, m, generator=g, device=dev)
    last = B - 1
    for store in ("f32", "int8"):
        scale = None
        Dx, Qx = D, Q
        if store == "int8":
            Dx, scale = quantize_int8_per_dim(D)
            Qx = (Q * scale[None, :]).contiguous()
        args, ps, npages = _paged_view(Dx, 256, scale)
        for k in (10, 100):
            s1, i1 = topk_score.topk_score_cuda(Dx, Qx, k=k)
            s2, i2 = topk_score.topk_score_plain(Dx, Qx, k=k)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)
            one = topk_score.topk_score_cuda(Dx, Qx[last:], k=k)
            assert torch.equal(s1[last:], one[0]) and torch.equal(i1[last:], one[1])
            s1, i1 = topk_score.topk_score_paged_cuda(*args, 0, npages, Q, k=k, page_scale=ps)
            s2, i2 = topk_score.topk_score_paged_plain(*args, 0, npages, Q, k=k, page_scale=ps)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)
            one = topk_score.topk_score_paged_cuda(*args, 0, npages, Q[last:], k=k,
                                                   page_scale=ps)
            assert torch.equal(s1[last:], one[0]) and torch.equal(i1[last:], one[1])
        index = DenseIndex.build(D, quantize_int8=store == "int8")
        s1, i1 = index.search(Q, k=10)
        s2, i2 = topk_score.topk_score_plain(index.vectors, index._dequeries(Q), k=10)
        torch.testing.assert_close(s1, s2, **TOL)
        _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    # the select alone over 65,537 rows of keys
    s = torch.randn(B, 300, generator=g, device=dev)
    s[:, ::7] = float("-inf")
    ids = torch.arange(300, device=dev, dtype=torch.int32).expand(B, -1)
    keys = (ref._keys(s, ids) ^ topk_score._SIGN).contiguous()
    got = topk_score.topk_select_cuda(keys, 100)
    want = topk_score.topk_select_plain(keys, 100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = topk_score.topk_select_cuda(keys[last:], 100)
    assert torch.equal(got[0][last:], one[0]) and torch.equal(got[1][last:], one[1])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_gram_ranges():
    """gram is bitwise the same run to run, exactly symmetric, and bitwise
    the in-order sum of one-range launches over its row ranges (each range
    one fp32 chain over its rows, the ranges summed in order from 0), for
    f32 and bf16, d on and off the 128-column tile and the 16-byte piece,
    and n within one slab, across a range boundary and over many ranges
    (with d = 16, some of them empty)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import gram

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 200, 768, 300):
            for n in (10, 16385, 40000):
                D = torch.randn(n, d, generator=g, device=dev).to(dtype)
                G = gram.gram_cuda(D)
                assert torch.equal(G, gram.gram_cuda(D))
                assert torch.equal(G, G.T)
                want = torch.zeros((d, d), device=dev)
                for a, b in gram._ranges(D):
                    want += gram._launch(D[a:b].contiguous(), 1)
                assert torch.equal(G, want), (dtype, d, n)
                torch.testing.assert_close(G, gram.gram_plain(D), rtol=1e-4, atol=1e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_topk_duplicate_ids():
    """row_ids and ids_pool with repeated non-negative ids (and rows that
    repeat both content and id, so equal keys): the kernels keep every
    copy, as the plain versions do; k = 10 and the select path at 100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    n, m, B, R = 3000, 48, 33, 256
    D = torch.randn(n, m, generator=g, device=dev) / m ** 0.5
    D[1500:] = D[:1500]
    Q = torch.randn(B, m, generator=g, device=dev)
    row_ids = torch.randint(0, 400, (n // 2,), generator=g, device=dev, dtype=torch.int32)
    row_ids[::13] = -1
    row_ids = torch.cat([row_ids, row_ids])
    for store in ("f32", "int8"):
        scale = None
        Dx, Qx = D, Q
        if store == "int8":
            Dx, scale = quantize_int8_per_dim(D)
            Qx = (Q * scale[None, :]).contiguous()
        args, ps, npages = _paged_view(Dx, R, scale)
        ids_pool = torch.full((npages * R,), -1, dtype=torch.int32, device=dev)
        ids_pool[:n] = row_ids
        ids_pool = ids_pool.view(npages, R)
        for k in (10, 100):
            s1, i1 = topk_score.topk_score_cuda(Dx, Qx, k=k, row_ids=row_ids)
            s2, i2 = topk_score.topk_score_plain(Dx, Qx, k=k, row_ids=row_ids)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)
            # every key of the top k comes twice (the repeated rows)
            assert torch.equal(s1[:, ::2], s1[:, 1::2]) and torch.equal(i1[:, ::2], i1[:, 1::2])
            s1, i1 = topk_score.topk_score_paged_cuda(*args, 0, npages, Q, k=k,
                                                      page_scale=ps, ids_pool=ids_pool)
            s2, i2 = topk_score.topk_score_paged_plain(*args, 0, npages, Q, k=k,
                                                       page_scale=ps, ids_pool=ids_pool)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    torch.cuda.synchronize()


def _live_segmented(g, dev, quantize, n_base=20000, m=384, appended=9000, capacity=4096):
    """A base of ``n_base`` unit rows and ``appended`` more in 64-row blocks
    (one x9 block, so an int8 delta widens) through ``SegmentedIndex``;
    returns the index and the appended rows."""
    import numpy as np
    from repro_torch.core.index import DenseIndex, SegmentedIndex
    D = torch.randn(n_base, m, generator=g, device=dev) / m ** 0.5
    seg = SegmentedIndex.from_index(DenseIndex.build(D, quantize_int8=quantize),
                                    delta_capacity=capacity)
    rows = (torch.randn(appended, m, generator=g, device=dev) / m ** 0.5).cpu().numpy()
    rows[5000:5064] *= 9.0
    for i in range(0, appended, 64):
        seg = seg.append(rows[i:i + 64])
    assert len(seg.deltas) == -(-appended // capacity)
    return seg, D, np.ascontiguousarray(rows)


@pytest.mark.gpu
def test_cuda_segmented_equals_merged_dense():
    """On the card every score's fmaf order is fixed, so the segmented f32
    search (base + fixed-capacity deltas under ``n_valid``) is bitwise the
    merge of a dense search of the base with a dense index over the
    appended rows, ids offset by n; the int8 one (mixed scales) matches the
    f32 search over each segment's dequantised rows up to near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import DenseIndex, _topk_merge
    from repro_torch.kernels import topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    seg, D, rows = _live_segmented(g, dev, quantize=False)
    extra = DenseIndex(torch.as_tensor(rows, device=dev))
    base = DenseIndex(D)
    Q = torch.randn(32, D.shape[1], generator=g, device=dev)
    for k in (10, 100, 1000):
        bs, bi = base.search(Q, k=k)
        es, ei = extra.search(Q, k=k)
        want = _topk_merge(torch.cat([bs, es], 1), torch.cat([bi, ei + base.n], 1), k)
        got = seg.search(Q, k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # each delta's search against its plain version
    for d in seg.deltas:
        for k in (10, 1000):
            s1, i1 = topk_score.topk_score_cuda(d.vectors, Q, k=k, n_valid=d.n_real)
            s2, i2 = topk_score.topk_score_plain(d.vectors, Q, k=k, n_valid=d.n_real)
            torch.testing.assert_close(s1, s2, **TOL)
            _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    seg8, D8, _ = _live_segmented(g, dev, quantize=True)
    assert len({tuple(d.scale.tolist()) for d in seg8.deltas}) == len(seg8.deltas)
    dq = [seg8.base.vectors.float() * seg8.base.scale[None, :]]
    dq += [d.vectors[:d.n_real].float() * d.scale[None, :] for d in seg8.deltas]
    oracle = DenseIndex(torch.cat(dq))
    for k in (10, 1000):
        s1, i1 = seg8.search(Q, k=k)
        s2, i2 = oracle.search(Q, k=k)
        torch.testing.assert_close(s1, s2, **TOL)
        _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_from_segmented_equals_segmented():
    """Paging a live segmented index (base pages in the pool, each delta an
    extent with its own scale) changes no result: bitwise equal, f32 and
    int8, before and after a further append."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.paged import PagedIndex

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    for quantize in (False, True):
        seg, D, rows = _live_segmented(g, dev, quantize=quantize)
        pg = PagedIndex.from_segmented(seg, page_rows=256)
        assert pg.n == seg.n and pg.storage.seal_rows == seg.delta_capacity
        Q = torch.randn(32, D.shape[1], generator=g, device=dev)
        for step in ("adopted", "appended"):
            for k in (10, 1000):
                a, b = seg.search(Q, k=k), pg.search(Q, k=k)
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (step, k)
            seg, pg = seg.append(rows[:100]), pg.append(rows[:100])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_appends_keep_one_kernel_shape(monkeypatch):
    """Appends build and load no kernel module and never change the delta
    search's operands: every call sees the (capacity, m) buffer with a
    growing ``n_valid``, and counts under the ``int8_n_valid`` mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import _build, ops, topk_score

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    seg, D, rows = _live_segmented(g, dev, quantize=True, appended=64)
    Q = torch.randn(32, D.shape[1], generator=g, device=dev)
    seg.search(Q, k=10)
    seg.search(Q, k=1000)
    libs = dict(_build._libs)
    calls = []
    topk = ops.topk_score

    def spy(Dx, Qx, *, k, n_valid=None, row_ids=None):
        calls.append((tuple(Dx.shape), Dx.dtype, n_valid))
        return topk(Dx, Qx, k=k, n_valid=n_valid, row_ids=row_ids)

    def no_build(*a, **kw):
        raise AssertionError("an append built a kernel module")

    monkeypatch.setattr(ops, "topk_score", spy)
    monkeypatch.setattr(_build, "build", no_build)
    before = topk_score.topk_score_cuda.launches["int8_n_valid"]
    for i in range(10):
        seg = seg.append(rows[:64] * 0.5)
        seg.search(Q, k=10)
        seg.search(Q, k=1000)
    assert _build._libs == libs
    deltas = [c for c in calls if c[2] is not None]     # the base's calls have none
    assert len(deltas) == 20
    assert {c[:2] for c in deltas} == {((4096, D.shape[1]), torch.int8)}
    assert sorted({c[2] for c in deltas}) == [64 * (i + 2) for i in range(10)]
    assert topk_score.topk_score_cuda.launches["int8_n_valid"] == before + 20
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_store_round_trip_is_bitwise(tmp_path):
    """Save on the card, load back onto it: dense f32 and int8, the live
    segmented index (mixed int8 scales) and a paged index with host-tier
    pages answer bitwise as before, at k = 10 and 1000, and the loaded
    bytes are the saved ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import DenseIndex, SegmentedIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.store import IndexStore, save_index

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    Q = torch.randn(32, 96, generator=g, device=dev)

    def same(a, b, what):
        for k in (10, 1000):
            x, y = a.search(Q, k=k), b.search(Q, k=k)
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]), (what, k)

    X = torch.randn(20000, 96, generator=g, device=dev)
    for quant in (False, True):
        idx = DenseIndex.build(X, quantize_int8=quant)
        st = save_index(str(tmp_path / f"dense{quant}"), idx, chunk_rows=3000)
        loaded = DenseIndex.load(st)
        assert loaded.device.type == "cuda" and torch.equal(loaded.vectors, idx.vectors)
        same(idx, loaded, f"dense quant={quant}")
    seg, D, rows = _live_segmented(g, dev, quantize=True, appended=5100)
    Qs = torch.randn(32, D.shape[1], generator=g, device=dev)
    st = save_index(str(tmp_path / "seg"), seg)
    seg2 = SegmentedIndex.load(st, delta_capacity=seg.delta_capacity)
    for k in (10, 1000):
        x, y = seg.search(Qs, k=k), seg2.search(Qs, k=k)
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]), ("segmented", k)
    pg = PagedIndex.from_index(DenseIndex.build(X, quantize_int8=True), page_rows=256,
                               pool_pages=60, seal_rows=1024)
    pg = pg.append(torch.randn(700, 96, generator=g, device=dev).cpu().numpy() * 3)
    assert pg.storage.n_host_pages > 0
    pg2 = PagedIndex.load(pg.save(str(tmp_path / "paged")), pool_pages=60)
    assert pg2.storage.n_host_pages == pg.storage.n_host_pages
    for ei in range(len(pg.storage.extents)):
        assert torch.equal(pg.storage.extent_rows(ei), pg2.storage.extent_rows(ei))
    same(pg, pg2, "paged")
    assert IndexStore.open(str(tmp_path / "paged")).manifest["paged"]["page_rows"] == 256
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_build_index_to_matches_cpu(tmp_path):
    """The streaming build from CUDA blocks (pca_project and the on-card
    absmax and quantise) against the same build from CPU tensors through
    the plain versions: already-projected blocks give the same bytes and
    meta; with the projection inside, f32 rows within 1e-5 and int8 bytes
    equal except ±1 on at most 0.1 %; an unfitted pruner (gram kernel)
    fits the same components up to sign."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.core.pruning import StaticPruner
    from repro_torch.core.quantization import quantize_int8_per_dim

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    lam = torch.logspace(0, -2, 128, device=dev)
    X = torch.randn(40000, 128, generator=g, device=dev) * lam.sqrt()
    blocks_dev = [X[i:i + 7000] for i in range(0, X.shape[0], 7000)]
    blocks_cpu = [b.cpu() for b in blocks_dev]
    card = StaticPruner(cutoff=0.5).fit(X)
    host = StaticPruner(cutoff=0.5)
    host.state = dataclasses.replace(
        card.state, **{f: getattr(card.state, f).cpu()
                       for f in ("components", "eigenvalues", "mean")})
    P = card.prune_index(X)
    # the scale is a true f32 divide on the card as on the host
    q_card, s_card = quantize_int8_per_dim(P)
    q_host, s_host = quantize_int8_per_dim(P.cpu())
    assert torch.equal(s_card.cpu(), s_host) and torch.equal(q_card.cpu(), q_host)
    proj_dev = [P[i:i + 7000] for i in range(0, P.shape[0], 7000)]
    for quant in (False, True):
        a = card.build_index_to(str(tmp_path / f"pd{quant}"), proj_dev,
                                quantize_int8=quant, already_projected=True)
        b = host.build_index_to(str(tmp_path / f"ph{quant}"), [p.cpu() for p in proj_dev],
                                quantize_int8=quant, already_projected=True)
        assert a.manifest == b.manifest
        assert torch.equal(a.read_rows(0, a.n, device="cpu"), b.read_rows(0, b.n, device="cpu"))
        a = card.build_index_to(str(tmp_path / f"d{quant}"), blocks_dev, quantize_int8=quant)
        b = host.build_index_to(str(tmp_path / f"h{quant}"), blocks_cpu, quantize_int8=quant)
        ra, rb = a.read_rows(0, a.n, device="cpu"), b.read_rows(0, b.n, device="cpu")
        if quant:
            diff = (ra.int() - rb.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
            np.testing.assert_allclose(a.scale(), b.scale(), rtol=1e-5)
        else:
            torch.testing.assert_close(ra, rb, **TOL)
    fit_card = StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "fit_d"), blocks_dev,
                                                       quantize_int8=True)
    fit_host = StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "fit_h"), blocks_cpu,
                                                       quantize_int8=True, device="cpu")
    Wa = fit_card.load_pca(device="cpu").components[:, :64].numpy()
    Wb = fit_host.load_pca(device="cpu").components[:, :64].numpy()
    signs = np.sign(np.sum(Wa * Wb, axis=0))
    np.testing.assert_allclose(Wa * signs[None, :], Wb, atol=1e-3)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_dense_load_bf16(tmp_path):
    """A bf16 store (uint16 chunks on disk) loads onto the card as bf16,
    bit for bit, and searches as the saved index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.store import save_index

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(33)
    idx = DenseIndex.build(torch.randn(30000, 64, generator=g, device=dev),
                           dtype=torch.bfloat16)
    st = save_index(str(tmp_path / "bf16"), idx, chunk_rows=4096)
    assert st.manifest["dtype"] == "bfloat16"
    loaded = DenseIndex.load(st)
    assert loaded.vectors.dtype == torch.bfloat16 and loaded.device.type == "cuda"
    assert torch.equal(loaded.vectors.view(torch.int16), idx.vectors.view(torch.int16))
    Q = torch.randn(32, 64, generator=g, device=dev)
    for k in (10, 1000):
        a, b = idx.search(Q, k=k), loaded.search(Q, k=k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.cuda.synchronize()


def _cascade_fixture(g, dev, n=6000, d=128, m=96):
    """Pruned f32 rows with a decaying spectrum, a projection and queries,
    all on the card."""
    D = torch.randn(n, m, generator=g, device=dev) * torch.logspace(
        0.5, -1.5, m, device=dev)
    W = torch.randn(d, m, generator=g, device=dev) / d ** 0.5
    Q = torch.randn(32, d, generator=g, device=dev)
    return D, W, Q


@pytest.mark.gpu
def test_cuda_cascade_anchor_is_bitwise():
    """With N·k >= n the shortlist covers the corpus, and the rescore scores
    each row with the top-k kernel's own arithmetic: the cascade is bitwise
    the full-m search, dense, segmented (with deltas) and paged, f32 and
    int8. Below that depth it is held to the CPU cascade (plain versions)
    at the parity bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.cascade import CascadeIndex

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    D, W, Q = _cascade_fixture(g, dev)
    extra = torch.randn(2500, D.shape[1], generator=g, device=dev).cpu().numpy()
    k = 10
    for quant in (False, True):
        n = D.shape[0]
        cas = CascadeIndex.build(D, m_coarse=32, n_factor=-(-n // k), quantize_int8=quant)
        for kk in (k, 1000):
            a, b = cas.search_projected(Q, W, k=kk), cas.full.search_projected(Q, W, k=kk)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (quant, kk)
        seg = CascadeIndex.build(D, m_coarse=32, n_factor=-(-(n + 2500) // k),
                                 quantize_int8=quant).segmented(delta_capacity=1024)
        seg = seg.append(extra)
        want = seg.full.search_projected(Q, W, k=k)
        for got in (seg.search_projected(Q, W, k=k),
                    seg.paged(page_rows=256).search_projected(Q, W, k=k)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), quant
        shallow = CascadeIndex.build(D, m_coarse=32, n_factor=8, quantize_int8=quant)
        host = CascadeIndex.build(D.cpu(), m_coarse=32, n_factor=8, quantize_int8=quant)
        s1, i1 = shallow.search_projected(Q, W, k=k)
        s2, i2 = host.search_projected(Q.cpu(), W.cpu(), k=k)
        torch.testing.assert_close(s1.cpu(), s2, **TOL)
        _ids_equal_up_to_near_ties(s2, i2, s1, i1)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_paged_rescore_equals_segmented():
    """``PagedIndex.rescore`` (shortlist rows gathered off the pool, the
    tail and the host pages, one ``row_ids`` call per int8 extent) is
    bitwise the segmented rescore over the same bytes, resident and with
    both sides oversubscribed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.cascade import CascadeIndex, _shortlist
    from repro_torch.core.index import _project_nofold

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    D, W, Q = _cascade_fixture(g, dev)
    extra = torch.randn(3000, D.shape[1], generator=g, device=dev).cpu().numpy()
    for quant in (False, True):
        seg = CascadeIndex.build(D, m_coarse=32, n_factor=8, quantize_int8=quant
                                 ).segmented(delta_capacity=1024).append(extra)
        qf = _project_nofold(Q, W, None)
        uids = _shortlist(seg.coarse_topk(qf, 80)[1])
        want = seg.rescore(qf, uids, 10)
        for paged in (seg.paged(page_rows=64),
                      seg.paged(page_rows=64, pool_pages=40, coarse_pool_pages=20,
                                wave_pages=8)):
            got = paged.rescore(qf, uids, 10)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), quant
            got = paged.search_projected(Q, W, k=10)
            ref = seg.search_projected(Q, W, k=10)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), quant
    torch.cuda.synchronize()
