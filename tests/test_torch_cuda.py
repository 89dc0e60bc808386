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
    torch.cuda.synchronize()
