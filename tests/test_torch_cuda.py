"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version, on
the card. Skips where there is no CUDA device; decided inside the test so
every pytest worker collects the same tests. Imports no JAX, so it runs on
a machine without it:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import os

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


@pytest.mark.gpu
def test_cuda_sharded_equals_dense():
    """A mesh of slots on the one card: each slot's search is one launch of
    the top-k kernel over a row view of the index, and since a score's sum
    order does not depend on its shard, the flat and hierarchical merges
    are bitwise the dense search, f32 and int8, on (4,) and (2, 2) meshes:
    with a slot that is all padding (n = 5), k above a shard's rows, and
    the radix select (k > 32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import DenseIndex, ShardedDenseIndex
    from repro_torch.kernels import topk_score
    from repro_torch.par.mesh import make_mesh

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(41)
    meshes = [make_mesh((4,), ("data",), dev), make_mesh((2, 2), ("row", "col"), dev)]
    for n, m in [(20003, 384), (20, 64), (5, 48)]:
        D = torch.randn(n, m, generator=g, device=dev)
        D[n - 1] = D[0]                              # a tie across the first and last shard
        Q = torch.randn(32, m, generator=g, device=dev)
        for quant in (False, True):
            dense = DenseIndex.build(D, quantize_int8=quant)
            for mesh in meshes:
                sidx = ShardedDenseIndex.build(D, mesh, quantize_int8=quant)
                if not quant:
                    assert all(t.data_ptr() == D[lo:].data_ptr() for t, lo in
                               zip(sidx.shards, range(0, n, sidx.rows_per)))
                live = sum(1 for t in sidx.shards if t.shape[0])
                for k in (10, 100):
                    want = dense.search(Q, k=k)
                    for merge in ("flat", "hierarchical"):
                        before = sum(topk_score.topk_score_cuda.launches.values())
                        got = sidx.search(Q, k=k, merge=merge)
                        after = sum(topk_score.topk_score_cuda.launches.values())
                        assert after - before == live
                        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                            n, quant, mesh.shape, k, merge)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_gram_distributed_equals_gram():
    """The distributed Gram on a 4-slot mesh of the card (one ``gram``
    launch per strip, summed in slot order) against one ``gram`` call,
    within 1e-5 of max |G|; and the distributed fit's eigenvalues within
    1e-5 of the largest (the PR 18 contract) on a corpus with the
    protocol's decaying spectrum (a flat random one leaves only the fp32
    eigensolver's own noise, about 1e-5 of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.pca import fit_pca, fit_pca_distributed, gram_distributed
    from repro_torch.data.synthetic import corpus_on_device
    from repro_torch.kernels import gram
    from repro_torch.par.mesh import make_mesh

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(42)
    mesh = make_mesh((4,), ("data",), dev)
    for n, d in [(5, 64), (10003, 256)]:
        D = torch.randn(n, d, generator=g, device=dev)
        before = gram.gram_cuda.launches
        G = gram_distributed(D, mesh)
        per = -(-n // 4)
        assert gram.gram_cuda.launches - before == sum(1 for i in range(4) if i * per < n)
        want = gram.gram_cuda(D)
        torch.testing.assert_close(G, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    C = corpus_on_device("tasb", n_docs=10003, d=256, seed=0, device=dev)
    lam = fit_pca(C).eigenvalues
    torch.testing.assert_close(fit_pca_distributed(C, mesh).eigenvalues, lam,
                               rtol=0, atol=1e-5 * float(lam[0]))
    torch.cuda.synchronize()


# the bars of chip_smoke.py phase 13 (a)
ENCODE_F32_TOL = 1e-4       # max |card - CPU| of f32-compute embeddings
ENCODE_BF16_COS = 0.999     # per-row cosine of bf16-compute embeddings


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Entry-wise distance of two bf16 tensors in bf16 ULPs (ordered bits)."""
    def ordered(x):
        i = x.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a.cpu()) - ordered(b.cpu())).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_encode_matches_cpu(compute_dtype):
    """The example's small encoder on the card against the same weights on
    the CPU: f32 compute within 1e-4, bf16 compute at cosine >= 0.999 on
    every row (phase 13 (a)'s bars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.data.tokens import pair_batch
    from repro_torch.launch.encode import SMALL_CFG
    from repro_torch.models.biencoder import encode, init_biencoder

    cfg = dataclasses.replace(SMALL_CFG, compute_dtype=compute_dtype)
    cpu = init_biencoder(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = init_biencoder(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    b = pair_batch(7, 0, batch=16, seq_len=cfg.max_len, vocab=cfg.vocab)
    mask = np.ones_like(b["d_tokens"])
    mask[:, 40:] = 0
    with torch.inference_mode():
        want = encode(cpu, b["d_tokens"], mask)
        got = encode(card, b["d_tokens"], mask)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == want.shape
    got = got.cpu()
    if compute_dtype == "float32":
        assert float((got - want).abs().max()) <= ENCODE_F32_TOL
    else:
        cos = (got * want).sum(1) / got.norm(dim=1) / want.norm(dim=1)
        assert float(cos.min()) >= ENCODE_BF16_COS


@pytest.mark.gpu
def test_cuda_gelu_matches_cpu():
    """The bf16 GELU on the card within one bf16 ULP of the CPU's on every
    entry (CUDA's and the CPU's f32 tanh may differ by an ULP, which can
    move a bf16 rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.layers import gelu

    x = (torch.randn(1024, 3072, generator=torch.Generator().manual_seed(1)) * 2).bfloat16()
    got = gelu(x.cuda())
    assert got.dtype == torch.bfloat16
    assert int(_bf16_ulps(got, gelu(x)).max()) <= 1


@pytest.mark.gpu
def test_cuda_encode_cli_launches_the_kernels(capsys):
    """``launch.encode`` at a small size on the card: the fit, the prune, the
    int8 build and the searches go through the gram, pca_project,
    pca_project_quant and topk_score kernels, and the lines are the
    example's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import gram, pca_project, topk_score
    from repro_torch.launch import encode as encode_cli

    before = (gram.gram_cuda.launches, pca_project.pca_project_cuda.launches,
              dict(topk_score.topk_score_cuda.launches),
              pca_project.pca_project_quant_cuda.launches)
    res = encode_cli.main(["--n-docs", "2000", "--n-queries", "64", "--quantize-int8"])
    torch.cuda.synchronize()
    assert gram.gram_cuda.launches > before[0]
    assert pca_project.pca_project_cuda.launches > before[1]
    assert pca_project.pca_project_quant_cuda.launches > before[3]
    for mode in ("f32", "int8"):
        assert topk_score.topk_score_cuda.launches[mode] > before[2][mode]
    assert res.D.device.type == "cuda" and res.index.dtype == torch.int8
    out = capsys.readouterr().out
    assert "[encode] corpus of 2000 docs" in out and "[serve] MRR@10 full=" in out
    for _, ids in res.results.values():
        assert ids.shape == (64, 10) and bool((ids >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_train_step_matches_cpu(compute_dtype):
    """The smoke config (remat on) on the card against the same weights and
    batch on the CPU: the loss and gradients at the init, then one train
    step each. f32: losses at rtol 1e-4, each gradient leaf within 1e-4 of
    its largest entry; bf16: losses at rtol 1e-2, the flattened gradient at
    cosine >= 0.999 (phase 14 (a)'s bars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.configs import biencoder_msmarco
    from repro_torch.configs.steps import make_train_step, value_and_grad
    from repro_torch.data.tokens import pair_batch
    from repro_torch.models.biencoder import contrastive_loss, init_biencoder

    cfg = dataclasses.replace(biencoder_msmarco.smoke_cfg(), remat=True,
                              compute_dtype=compute_dtype)
    models = [init_biencoder(cfg, generator=torch.Generator().manual_seed(0), device=dev)
              .requires_grad_(True) for dev in ("cpu", "cuda")]
    b = pair_batch(0, 0, batch=8, seq_len=16, vocab=cfg.vocab)
    (l_cpu, g_cpu), (l_card, g_card) = (value_and_grad(contrastive_loss, m, b) for m in models)
    step, opt_init = make_train_step(contrastive_loss)
    opts = [opt_init(m) for m in models]
    stepped = [float(step(m, o, b)["loss"]) for m, o in zip(models, opts)]
    torch.cuda.synchronize()
    assert l_card.device.type == "cuda" and int(opts[1]["step"]) == 1
    rtol = 1e-4 if compute_dtype == "float32" else 1e-2
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=rtol)
    np.testing.assert_allclose(stepped[1], stepped[0], rtol=rtol)
    if compute_dtype == "float32":
        for n, g in g_cpu.items():
            assert float((g_card[n].cpu() - g).abs().max()) <= 1e-4 * float(g.abs().max()), n
    else:
        a = torch.cat([g.flatten() for g in g_cpu.values()])
        c = torch.cat([g_card[n].cpu().flatten() for n in g_cpu])
        assert float(a @ c / a.norm() / c.norm()) >= 0.999


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip(tmp_path):
    """A checkpoint of card tensors (a trained model and its AdamW state)
    restores bitwise onto the card, and its files are the same bytes as the
    CPU copy's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import CheckpointManager, save_pytree
    from repro_torch.configs import biencoder_msmarco
    from repro_torch.configs.steps import make_train_step
    from repro_torch.data.tokens import pair_batch
    from repro_torch.convert import checkpoint_tree
    from repro_torch.models.biencoder import contrastive_loss, init_biencoder

    cfg = biencoder_msmarco.smoke_cfg()
    model = init_biencoder(cfg, generator=torch.Generator().manual_seed(0),
                           device="cuda").requires_grad_(True)
    step, opt_init = make_train_step(contrastive_loss)
    opt = opt_init(model)
    step(model, opt, pair_batch(0, 0, batch=8, seq_len=16, vocab=cfg.vocab))
    tree = checkpoint_tree(model, opt)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, tree)
    mgr.wait()
    back, s = mgr.restore(tree)
    assert s == 1
    flat = lambda t: [x for v in t for x in _leaves(v)]
    for a, b in zip(flat(tree), flat(back)):
        assert b.device.type == "cuda" and torch.equal(a, b)
    cpu_tree = tuple(_tree_map(lambda x: x.detach().cpu(), v) for v in tree)
    save_pytree(str(tmp_path / "cpu"), cpu_tree, extra={"step": 1})
    for f in os.listdir(tmp_path / "cpu"):
        assert (tmp_path / "cpu" / f).read_bytes() == (
            tmp_path / "ck" / "step_0000000001" / f).read_bytes(), f


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _lm_pair(arch, **kw):
    """(config, CPU model, card model): an LM smoke config's seeded weights
    on both devices."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.transformer import init_lm

    cfg = dataclasses.replace(registry.get_smoke_cfg(arch), **kw)
    return cfg, *(init_lm(cfg, generator=torch.Generator().manual_seed(0), device=d)
                  for d in ("cpu", "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b", "arctic-480b"])
def test_cuda_lm_matches_cpu_f32(arch):
    """An LM smoke config (qwen2: QKV bias, tied embeddings; mixtral: MoE,
    sliding window; arctic: dense residual) on the card against its CPU run
    (chip_smoke.py phase 15 (a)): loss and each gradient leaf within 1e-4
    (of the leaf's largest entry), the MoE aux loss within 1e-5, prefill and
    decode logits within 1e-4, the arch's optimizer step from the same
    gradients within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import registry, steps
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as T

    cfg, cpu, card = _lm_pair(arch)
    b = token_batch(0, 0, batch=4, seq_len=32, vocab=cfg.vocab)
    out = [steps.value_and_grad(steps._lm_loss, m.requires_grad_(True), b) for m in (cpu, card)]
    (l_cpu, g_cpu), (l_card, g_card) = out
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-4)
    for n, g in g_cpu.items():
        assert float((g_card[n].cpu() - g).abs().max()) <= 1e-4 * float(g.abs().max()), n
    for m in (cpu, card):
        m.requires_grad_(False)
    with torch.no_grad():
        aux = [float(T.forward_hidden(m, b["tokens"])[1]) for m in (cpu, card)]
    assert abs(aux[1] - aux[0]) <= 1e-5
    logits = []
    for m in (cpu, card):
        pl, cache = T.prefill(m, b["tokens"][:, :24], cache_len=32)
        dl, _ = T.decode_step(m, cache, b["tokens"][:, 24], 24)
        seq = [pl, dl]
        if cfg.sliding_window:
            _, rc = T.prefill(m, b["tokens"], cache_len=cfg.sliding_window)
            seq.append(T.decode_step_sliding(m, rc, b["tokens"][:, 0],
                                             3 * cfg.sliding_window + 5)[0])
        logits.append(seq)
    for x, y in zip(*logits):
        assert y.device.type == "cuda" and float((y.cpu() - x).abs().max()) <= 1e-4
    init, update = steps._opt_pack(registry.get_arch(arch).optimizer)
    for m in (cpu, card):
        m.requires_grad_(True)
        named = dict(m.named_parameters())
        update({n: g.to(named[n].device) for n, g in g_cpu.items()}, init(m), named,
               torch.tensor(1e-2))
    for (n, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert float((q.detach().cpu() - p.detach()).abs().max()) <= 1e-6, n


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_lm_decode_steps_enqueue_without_a_host_sync(arch):
    """An int position reaches the card by a fill, not a blocking copy, so
    a decode step (full cache and rolling window) never waits for the
    previous step's kernels: no synchronizing call under CUDA's sync
    debug mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as T

    cfg, _, card = _lm_pair(arch)
    b = token_batch(0, 0, batch=2, seq_len=32, vocab=cfg.vocab)
    toks = torch.from_numpy(b["tokens"]).cuda()
    with torch.no_grad():
        _, cache = T.prefill(card, toks[:, :24], cache_len=32)
        if cfg.sliding_window:
            _, rc = T.prefill(card, toks, cache_len=cfg.sliding_window)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_step(card, cache, toks[:, 24], 24)
        if cfg.sliding_window:
            T.decode_step_sliding(card, rc, toks[:, 0], 3 * cfg.sliding_window + 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b", "arctic-480b"])
def test_cuda_lm_matches_cpu_bf16(arch):
    """bf16 compute: the loss within 1e-2 relative and the flattened
    gradient at cosine >= 0.999 of the CPU run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import steps
    from repro_torch.data.tokens import token_batch

    cfg, cpu, card = _lm_pair(arch, compute_dtype="bfloat16")
    b = token_batch(0, 1, batch=4, seq_len=32, vocab=cfg.vocab)
    (l_cpu, g_cpu), (l_card, g_card) = (
        steps.value_and_grad(steps._lm_loss, m.requires_grad_(True), b) for m in (cpu, card))
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-2)
    a = torch.cat([g.flatten() for g in g_cpu.values()]).double()
    c = torch.cat([g_card[n].cpu().flatten() for n in g_cpu]).double()
    assert float(a @ c / a.norm() / c.norm()) >= 0.999


@pytest.mark.gpu
def test_cuda_lm_train_step_microbatched():
    """The micro-batched step (K = 4, bf16 accumulation, Adafactor: arctic's
    recipe at its smoke width) on the card against the CPU: the loss within
    1e-4 relative, finite parameters on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import steps
    from repro_torch.data.tokens import token_batch

    cfg, cpu, card = _lm_pair("arctic-480b")
    b = token_batch(0, 2, batch=8, seq_len=32, vocab=cfg.vocab)
    losses = []
    for m in (cpu, card):
        m.requires_grad_(True)
        step, opt_init = steps.make_train_step(steps._lm_loss, "adafactor", microbatch=4,
                                               accum_dtype="bfloat16")
        losses.append(float(step(m, opt_init(m), b)["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert all(bool(torch.isfinite(p).all()) for p in card.parameters())


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["f32", "int8"])
def test_cuda_topk_b1_k100_retrieval(store):
    """``retrieval_cand``'s search shape at a smaller n: one query, k = 100
    (the chunk kernel's list mode and the radix select), f32 at d 256 and m
    128 or int8 at m 128, with and without an n_valid mask (a delta), and
    through ``score_candidates``: ids equal to the plain version's up to
    near-ties, scores at 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import topk_score
    from repro_torch.models import recsys as R

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for n, m in ([(100_000, 256), (100_003, 128)] if store == "f32" else [(100_003, 128)]):
        D = torch.randn(n, m, generator=g, device=dev)
        q = torch.randn(1, m, generator=g, device=dev)
        if store == "int8":
            D, scale = quantize_int8_per_dim(D)
            q = q * scale[None, :]
        for n_valid in (None, n - 77):
            want = topk_score.topk_score_plain(D, q, k=100, n_valid=n_valid)
            got = topk_score.topk_score_cuda(D, q, k=100, n_valid=n_valid)
            torch.testing.assert_close(got[0], want[0], **TOL)
            _ids_equal_up_to_near_ties(*want, *got)
    cfg = R.RecsysConfig(kind="two_tower", embed_dim=32, tower_mlp=(64, 32),
                         user_vocab=64, item_vocab=4096)
    model = R.init_recsys(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        index = R.item_embedding(model, torch.arange(4096, device=dev))
        before = topk_score.topk_score_cuda.launches["f32"]
        got = R.score_candidates(model, torch.tensor([5], device=dev), index, k=100)
        assert topk_score.topk_score_cuda.launches["f32"] == before + 1
        want = topk_score.topk_score_plain(index, R.user_embedding(
            model, torch.tensor([5], device=dev)), k=100)
    torch.testing.assert_close(got[0], want[0], **TOL)
    _ids_equal_up_to_near_ties(*want, *got)


@pytest.mark.gpu
def test_cuda_rowwise_update_in_place_and_deterministic():
    """The rowwise AdaGrad update on the card: in place (the table and the
    accumulator keep their storage), bitwise the same from the same state
    twice (heavy duplicates: no float atomics), equal to the CPU's update
    at 1e-6, and rows outside the batch untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.optim import rowwise as RW

    rng = np.random.default_rng(0)
    V, E, n = 5000, 64, 65536
    table = rng.standard_normal((V, E)).astype(np.float32)
    idx = np.minimum((rng.pareto(1.2, n) * V / 50).astype(np.int64), V - 1).astype(np.int32)
    grad = rng.standard_normal((n, E)).astype(np.float32)
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        t = torch.tensor(table, device=dev)
        a = torch.zeros(V, device=dev)
        ptr = (t.data_ptr(), a.data_ptr())
        RW.rowwise_adagrad_update(t, a, torch.tensor(idx, device=dev),
                                  torch.tensor(grad, device=dev), 0.01)
        assert (t.data_ptr(), a.data_ptr()) == ptr
        out.append((t.cpu(), a.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    torch.testing.assert_close(out[0][0], out[2][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[0][1], out[2][1], rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(V), idx)
    assert torch.equal(out[0][0][untouched], torch.tensor(table)[untouched])


def _gnn_batch(cfg, n=60, e=240, live=50, dup=24, seed=0):
    """A graph with tied messages (repeated edges) and isolated nodes."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, live, e)
    edges = rng.standard_normal((e, cfg.d_edge_in)).astype(np.float32)
    return {"nodes": rng.standard_normal((n, cfg.d_in)).astype(np.float32),
            "edges": np.concatenate([edges, edges[:dup]]),
            "edge_index": np.stack([np.concatenate([src, src[:dup]]),
                                    np.concatenate([dst, dst[:dup]])]).astype(np.int32),
            "edge_mask": (rng.random(e + dup) < 0.8).astype(np.float32),
            "targets": rng.standard_normal((n, cfg.d_out)).astype(np.float32),
            "node_mask": (rng.random(n) < 0.7).astype(np.float32)}


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_cuda_gnn_step_matches_cpu(agg):
    """The smoke config, remat on: loss, every gradient leaf (within 1e-4 of
    its largest entry) and the parameters after one AdamW step (1e-4) on
    the card against the CPU from the same seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.configs import registry, steps
    from repro_torch.models import gnn as G

    cfg = dataclasses.replace(registry.get_smoke_cfg("graphcast"), aggregator=agg, remat=True)
    host = _gnn_batch(cfg)
    out = {}
    for d in ("cpu", "cuda"):
        m = G.init_gnn(cfg, generator=torch.Generator().manual_seed(0), device=d)
        m.requires_grad_(True)
        b = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
        loss, grads = steps.value_and_grad(G.mse_loss, m, b)
        step, init = steps.make_train_step(G.mse_loss, "adamw")
        step(m, init(m), b)
        out[d] = (float(loss), grads, {k: p.detach().cpu() for k, p in m.named_parameters()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-4 * max(abs(lc), 1.0)
    for k in gc:
        scale = max(float(gc[k].abs().max()), 1e-30)
        assert float((gc[k] - gg[k].cpu()).abs().max()) <= 1e-4 * scale, k
        torch.testing.assert_close(pg[k], pc[k], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_gnn_step_is_deterministic():
    """A graphcast-width step (h 512, bf16 compute, remat) on a power-law
    graph whose hubs take thousands of messages, twice from the same state:
    the same loss and parameters, bit for bit (the segment sums run in a
    fixed order; no float atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.configs import registry, steps
    from repro_torch.models import gnn as G

    cfg = dataclasses.replace(registry.get_arch("graphcast").cfg, n_layers=4, d_in=64)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, e = 20_000, 200_000
    w = 1.0 / torch.arange(1, n + 1, device=dev, dtype=torch.float64) ** 0.8
    ei = torch.stack([torch.multinomial(w, e, replacement=True, generator=g)
                      for _ in range(2)]).int()
    batch = {"nodes": torch.randn(n, 64, generator=g, device=dev),
             "edges": torch.randn(e, 4, generator=g, device=dev), "edge_index": ei,
             "edge_mask": torch.ones(e, device=dev),
             "targets": torch.randn(n, cfg.d_out, generator=g, device=dev),
             "node_mask": torch.ones(n, device=dev)}
    model = G.init_gnn(cfg, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    model.requires_grad_(True)
    step, init = steps.make_train_step(G.mse_loss, "adamw")
    opt = init(model)
    state = [t.detach().clone() for t in (*model.parameters(), *opt["mu"].values(),
                                          *opt["nu"].values())]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, v in zip((*model.parameters(), *opt["mu"].values(), *opt["nu"].values()),
                            state):
                t.copy_(v)
        opt["step"] = torch.zeros_like(opt["step"])
        loss = step(model, opt, batch)["loss"]
        runs.append((loss.clone(), [p.detach().clone() for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["f32", "int8"])
def test_cuda_topk_device_count_equals_host_count(store):
    """A 0-d int32 live count on the card gives the host int's result
    bitwise (k 10 and 100, counts 0 .. n and past it, clamped by the
    kernel), in the ``<dtype>_n_valid`` mode, with no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.topk_score import topk_score_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    D = (torch.randn((4096, 384), device=dev, generator=g) * 40)
    D = D.to(torch.int8) if store == "int8" else D
    q = torch.randn((32, 384), device=dev, generator=g)
    for k in (10, 100):
        for nv in (0, 1, 1808, 4095, 4096, 5000, -3):
            want = topk_score_cuda(D, q, k=k, n_valid=nv)
            count = torch.tensor(nv, dtype=torch.int32, device=dev)
            before = topk_score_cuda.launches[f"{store}_n_valid"]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = topk_score_cuda(D, q, k=k, n_valid=count)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert topk_score_cuda.launches[f"{store}_n_valid"] == before + 1
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (k, nv)


@pytest.mark.gpu
def test_cuda_delta_search_replays_in_a_cuda_graph():
    """A delta search captured once in a CUDA graph, its live count a
    device tensor, replays at other counts bitwise equal to eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.index import _delta_topk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    D = (torch.randn((4096, 384), device=dev, generator=g) * 40).to(torch.int8)
    scale = torch.rand(384, device=dev, generator=g) * 0.01
    q = torch.randn((32, 384), device=dev, generator=g)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    for _ in range(2):
        _delta_topk(D, scale, q, count, 1000, 10)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gs, gi = _delta_topk(D, scale, q, count, 1000, 10)
    for live in (1, 1808, 4096, 0):
        count.fill_(live)
        graph.replay()
        es, ei = _delta_topk(D, scale, q, live, 1000, 10)
        torch.cuda.synchronize()
        assert torch.equal(gs, es) and torch.equal(gi, ei), live


@pytest.mark.gpu
def test_cuda_kernel_budget_has_no_gating_finding():
    """Every built kernel within the card's shared memory and registers, the
    query groups within gridDim.y, the vector path only where aligned; the
    ptxas spills are reported as warns and listed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.analysis import kernel_budget

    table = kernel_budget.kernel_table()
    assert len(table) == 36 + 12 + 5 + 8
    findings = kernel_budget.run("cuda")
    assert [f.key for f in findings if f.severity == "error"] == []
    assert {f.check for f in findings} <= {"budget.spill"}


@pytest.mark.gpu
def test_cuda_dispatch_counts_equal_the_cpu_counts():
    """Each entry point makes the same top-k calls on the card as on the
    CPU (where the dense search and the sharded slots call ``_scan_topk``),
    and on the card the gate's dispatch lints and invariants are clean
    modulo the baseline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.analysis import BASELINE_PATH, dispatch_lints, invariants
    from repro_torch.analysis.report import apply_baseline, load_baseline

    cpu = {ep.label: dispatch_lints.run_probed(ep.fn, ep.args).kernel_calls
           for ep in dispatch_lints.serving_entry_points("cpu")}
    card = {ep.label: dispatch_lints.run_probed(ep.fn, ep.args, device="cuda").kernel_calls
            for ep in dispatch_lints.serving_entry_points("cuda")}
    assert card == cpu
    findings = dispatch_lints.run("cuda") + invariants.run("cuda")
    report = apply_baseline(findings, load_baseline(BASELINE_PATH),
                            active_analyzers=["dispatch", "inv"])
    assert report.gating == () and report.stale == ()
