"""The port's kernel surface on the CPU (the plain versions) against
``repro``'s kernels in interpret mode, its oracles and its jnp scan.

Every input is made with numpy from a seed and handed to both packages.
Score tolerance is rtol = atol = 1e-5 (tests/test_kernels.py:126): the two
frameworks sum in different orders, so scores agree to an ULP or so, not
bitwise. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _scan_topk as jax_scan_topk
from repro.core.quantization import quantize_int8_per_dim as jax_quantize
from repro.kernels import ops as jops, ref as jref
from repro_torch.core.index import _scan_topk
from repro_torch.core.quantization import quantize_int8_per_dim
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gram import gram_cuda
from repro_torch.kernels.pca_project import pca_project_cuda, pca_project_quant_cuda
from repro_torch.kernels import topk_score as topk_mod
from repro_torch.kernels.topk_score import topk_score_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) and
                      x.dtype == torch.bfloat16 else x)


def _assert_ids_equal_up_to_near_ties(s_ref, i_ref, s_got, i_got, eps=1e-5):
    """Ids equal, except where the reference's neighbouring scores lie
    within ``eps``, or, in the last slot, where the doc that came in from
    past the cut scores within ``eps`` of the one it displaced: sums taken
    in another order may swap such near-ties."""
    s_ref, i_ref, s_got, i_got = map(np.asarray, (s_ref, i_ref, s_got, i_got))
    k = s_ref.shape[1]
    for b, j in zip(*np.nonzero(i_ref != i_got)):
        assert any(abs(s_ref[b, j] - s_ref[b, jj]) <= eps
                   for jj in (j - 1, j + 1) if 0 <= jj < k) or (
            j == k - 1 and abs(s_got[b, j] - s_ref[b, j]) <= eps), (b, j)


def _both(x, dtype="f32"):
    """The same numpy array as (jax array, torch tensor) in ``dtype``."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(64, 16), (257, 64), (1000, 96)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gram_plain_matches_reference(n, d, dtype):
    jD, tD = _both(_rand(np.random.default_rng(n + d), (n, d)), dtype)
    want = np.asarray(jops.gram(jD, block_rows=128, interpret=True))
    got = ops.gram(tD).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.gram_ref(tD).numpy(),
                               np.asarray(jref.gram_ref(jD)), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# topk_score
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,B,k,bn", [
    (128, 16, 1, 5, 64),
    (1000, 64, 8, 10, 256),
    (555, 48, 4, 13, 128),      # ragged strips
])
def test_topk_plain_matches_pallas_interpret(n, m, B, k, bn):
    rng = np.random.default_rng(n * 7 + k)
    jD, tD = _both(_rand(rng, (n, m)))
    jQ, tQ = _both(_rand(rng, (B, m)))
    s1, i1 = jops.topk_score(jD, jQ, k=k, block_n=bn, interpret=True)
    s2, i2 = ops.topk_score(tD, tQ, k=k)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("n,m,B,k", [
    (1000, 64, 8, 10),
    (2048, 128, 16, 100),       # large k
    (3000, 64, 4, 1000),        # the depth AP is evaluated at
    (96, 16, 3, 96),            # k == n
])
def test_topk_plain_and_ref_match_reference_oracle(n, m, B, k):
    rng = np.random.default_rng(n * 7 + k)
    jD, tD = _both(_rand(rng, (n, m)))
    jQ, tQ = _both(_rand(rng, (B, m)))
    s1, i1 = jref.topk_score_ref(jD, jQ, k=k)
    for s2, i2 in (ops.topk_score(tD, tQ, k=k), ref.topk_score_ref(tD, tQ, k=k)):
        _assert_ids_equal_up_to_near_ties(s1, i1, s2.numpy(), i2.numpy())
        np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_topk_plain_dtypes_match_scan(dtype, B):
    rng = np.random.default_rng(B)
    D, Q = _rand(rng, (1000, 64)), _rand(rng, (B, 64))
    if dtype == "int8":
        jq, jscale = jax_quantize(jnp.asarray(D))
        tq, tscale = quantize_int8_per_dim(torch.from_numpy(D))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        jD, tD = jq, tq
        jQ = jnp.asarray(Q) * jscale[None, :]
        tQ = torch.from_numpy(Q) * tscale[None, :]
    else:
        jD, tD = _both(D, dtype)
        jQ, tQ = _both(Q)
    s1, i1 = jax_scan_topk(jD, jQ, 10, block=256)
    s2, i2 = ops.topk_score(tD, tQ, k=10)
    s3, i3 = _scan_topk(tD, tQ, 10, block=256)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_array_equal(i3.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)
    np.testing.assert_allclose(s3.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("n,k,block", [(500, 7, 128), (96, 40, 32), (50, 60, 65536),
                                       (300, 10, 300)])
def test_scan_topk_matches_reference(n, k, block):
    rng = np.random.default_rng(n + k)
    jD, tD = _both(_rand(rng, (n, 32)))
    jQ, tQ = _both(_rand(rng, (5, 32)))
    s1, i1 = jax_scan_topk(jD, jQ, k, block=block)
    s2, i2 = _scan_topk(tD, tQ, k, block=block)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


def test_topk_plain_all_tied_across_strips():
    row = _rand(np.random.default_rng(3), (16,))
    D = np.tile(row, (300, 1))
    Q = np.stack([row, 2 * row])
    _, ids = ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=9)
    _, want = jops.topk_score(jnp.asarray(D), jnp.asarray(Q), k=9, block_n=64,
                              interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert (ids.numpy() == np.arange(9)[None, :]).all()


def test_topk_plain_k_exceeding_n_pads():
    rng = np.random.default_rng(5)
    jD, tD = _both(_rand(rng, (20, 8)))
    jQ, tQ = _both(_rand(rng, (3, 8)))
    s1, i1 = jops.topk_score(jD, jQ, k=32, block_n=8, interpret=True)
    s2, i2 = ops.topk_score(tD, tQ, k=32)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    assert (i2.numpy()[:, 20:] == -1).all()
    assert np.isneginf(s2.numpy()[:, 20:]).all()
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("n_valid", [0, 37, 64, 100])
def test_topk_plain_n_valid_masks_like_reference(n_valid):
    rng = np.random.default_rng(n_valid)
    jD, tD = _both(_rand(rng, (128, 16)))
    jQ, tQ = _both(_rand(rng, (4, 16)))
    s1, i1 = jops.topk_score(jD, jQ, k=5, block_n=64, n_valid=n_valid,
                             interpret=True)
    s2, i2 = ops.topk_score(tD, tQ, k=5, n_valid=n_valid)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)
    assert i2.numpy().max() < max(n_valid, 1)


def test_topk_plain_row_ids_nonascending_tiebreak():
    """A tied max in a later strip carries the smaller id
    (tests/test_kernels.py:233): the min id must win."""
    m = 16
    D = np.zeros((16, m), np.float32)
    D[:, 0] = np.linspace(0.5, 2.0, 16)
    D[3, 0] = 5.0
    D[11, 0] = 5.0
    row_ids = np.asarray([20, 21, 22, 10, 24, 25, 26, 27,
                          28, 29, 30, 7, 32, 33, 34, 35], np.int32)
    Q = np.zeros((1, m), np.float32)
    Q[0, 0] = 1.0
    s, ids = ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=3,
                            row_ids=torch.from_numpy(row_ids))
    s1, i1 = jops.topk_score(jnp.asarray(D), jnp.asarray(Q), k=3, block_n=8,
                             interpret=True, row_ids=jnp.asarray(row_ids))
    assert float(s[0, 0]) == 5.0 and int(ids[0, 0]) == 7
    np.testing.assert_array_equal(ids.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("order", ["ascending", "shuffled_with_sentinels"])
def test_topk_plain_row_ids_matches_reference(order):
    rng = np.random.default_rng(11)
    jD, tD = _both(_rand(rng, (200, 32)))
    jQ, tQ = _both(_rand(rng, (3, 32)))
    ids = np.arange(200, dtype=np.int32) + 1000
    if order != "ascending":
        ids = rng.permutation(ids).astype(np.int32)
        ids[rng.choice(200, 20, replace=False)] = -1
    s1, i1 = jops.topk_score(jD, jQ, k=7, block_n=64, interpret=True,
                             row_ids=jnp.asarray(ids))
    s2, i2 = ops.topk_score(tD, tQ, k=7, row_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("k", [1500, 3005])
@pytest.mark.parametrize("mode", ["plain", "n_valid", "row_ids"])
@pytest.mark.parametrize("store", ["f32", "int8"])
def test_topk_plain_large_k_matches_reference_scan(store, mode, k):
    """k above the old 1024 cap, and past n (pads), through the reference's
    jnp scan: n_valid as the scan over the valid rows (ids are positions),
    row_ids as the scan over the live rows sorted by id (the lowest id wins
    a tie). int8 folds the scale into the query in both packages."""
    n, m, B = 3000, 32, 4
    rng = np.random.default_rng(k + len(mode) + len(store))
    D, Q = _rand(rng, (n, m)) / np.sqrt(m), _rand(rng, (B, m))
    if store == "int8":
        jD, jscale = jax_quantize(jnp.asarray(D))
        tD, tscale = quantize_int8_per_dim(torch.from_numpy(D))
        np.testing.assert_array_equal(tD.numpy(), np.asarray(jD))
        jQ = jnp.asarray(Q) * jscale[None, :]
        tQ = torch.from_numpy(Q) * tscale[None, :]
    else:
        (jD, tD), (jQ, tQ) = _both(D), _both(Q)
    kw = {}
    if mode == "plain":
        s1, i1 = jax_scan_topk(jD, jQ, k, block=1024)
    elif mode == "n_valid":
        kw["n_valid"] = 2100
        s1, i1 = jax_scan_topk(jD[:2100], jQ, k, block=1024)
    else:
        ids = rng.permutation(n).astype(np.int32) + 7
        ids[rng.choice(n, 300, replace=False)] = -1
        kw["row_ids"] = torch.from_numpy(ids)
        order = np.argsort(np.where(ids < 0, np.iinfo(np.int32).max, ids), kind="stable")
        order = order[ids[order] >= 0]
        s1, p1 = jax_scan_topk(jD[jnp.asarray(order)], jQ, k, block=1024)
        p1 = np.asarray(p1)
        i1 = np.where(p1 >= 0, ids[order][np.clip(p1, 0, None)], -1)
    s2, i2 = ops.topk_score(tD, tQ, k=k, **kw)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)
    _assert_ids_equal_up_to_near_ties(np.asarray(s1), np.asarray(i1), s2.numpy(), i2.numpy())
    assert (i2.numpy()[np.isneginf(s2.numpy())] == -1).all()


# ---------------------------------------------------------------------------
# pca_project (+ quant epilogue)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,m", [(100, 32, 8), (513, 96, 48)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_project_plain_matches_reference(n, d, m, dtype):
    rng = np.random.default_rng(n + m)
    jD, tD = _both(_rand(rng, (n, d)), dtype)
    jW, tW = _both(_rand(rng, (d, m)))
    want = np.asarray(jops.pca_project(jD, jW, block_rows=128,
                                       interpret=True).astype(jnp.float32))
    got = ops.pca_project(tD, tW)
    assert got.dtype == tD.dtype
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got), want, **tol)
    np.testing.assert_allclose(_np(ref.pca_project_ref(tD, tW)), want, **tol)


def test_project_quant_plain_matches_reference():
    """The plain epilogue multiplies by the reciprocal as the TPU kernel
    does; both packages' oracles divide. Products summed in another order
    may flip a rounding boundary by ±1 on a tiny fraction
    (tests/test_kernels.py:288-290)."""
    rng = np.random.default_rng(9)
    D, W = _rand(rng, (500, 64)), _rand(rng, (64, 32))
    scale = (np.abs(D @ W).max(0) / 127.0).astype(np.float32)
    pairs = [
        (ops.pca_project_quant(*map(torch.from_numpy, (D, W, scale))),
         jops.pca_project_quant(jnp.asarray(D), jnp.asarray(W),
                                jnp.asarray(scale), block_rows=128,
                                interpret=True)),
        (ref.pca_project_quant_ref(*map(torch.from_numpy, (D, W, scale))),
         jref.pca_project_quant_ref(jnp.asarray(D), jnp.asarray(W),
                                    jnp.asarray(scale))),
    ]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.int8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


@pytest.mark.parametrize("B", [65535, 65536, 65537, 200000])
def test_topk_query_groups_fit_one_launch(B):
    """The card's wrappers split B into C calls of at most 65,504 queries (a
    multiple of the 32-query tile within one launch's 65,535 grid rows)
    that cover every query once, in order."""
    def words_of(b):
        return 64 * b

    G = topk_mod._group(B, words_of)
    assert G % 32 == 0 and G <= topk_mod.MAX_GROUP == 65504
    seen = []

    def call(g0, g1, scratch):
        assert g1 - g0 <= G and scratch.numel() == words_of(G)
        seen.append((g0, g1))
        return 3

    launched = topk_mod._call_groups(B, words_of, call, torch.device("cpu"))
    assert seen[0][0] == 0 and seen[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(seen, seen[1:]))
    assert launched == 3 * len(seen) == 3 * -(-B // G)


# ---------------------------------------------------------------------------
# dispatch: a wrapper never falls back
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    D, W = torch.zeros(8, 4), torch.zeros(4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda(D)
    with pytest.raises(ValueError, match="CUDA"):
        pca_project_cuda(D, W)
    with pytest.raises(ValueError, match="CUDA"):
        pca_project_quant_cuda(D, W, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        topk_score_cuda(D, torch.zeros(1, 4), k=1)


def test_ops_refuse_mixed_or_other_devices():
    with pytest.raises(ValueError, match="on the CPU or all on a CUDA"):
        ops.gram(torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="on the CPU or all on a CUDA"):
        ops.topk_score(torch.zeros(4, 2), torch.zeros(1, 2, device="meta"), k=1)
