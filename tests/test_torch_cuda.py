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

    with pytest.raises(ValueError, match="outside the kernel's range"):
        topk_score.topk_score_cuda(D, Q, k=topk_score.K_CAP + 1)

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
