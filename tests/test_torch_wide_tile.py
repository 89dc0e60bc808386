"""The top-k at the shapes that walk every operand path of the chunk
kernel's 32-query tile, against ``repro``; and the host helpers of its
yardstick, ``benchmarks/many_queries.py``.

The wide tile (B >= 17) multiplies k-major operands: a query panel and f32
slabs rewritten from raw stages of f32, bf16 or int8 rows. Its paths turn
on m (one slab at 16, the scalar loader at 130, one panel at 384, two at
768), on the dtype, on k (keep mode at 10, list mode at 100) and on the row
source (dense, or paged with a scale row a page). On the card the kernel is
held bitwise to its parent's build (``many_queries.py --src``) and to its
plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
Here, with the plain versions on the CPU, the same inputs go through
``repro``'s oracle (rtol = atol = 1e-5, ids equal up to near-ties: the
port's parity contract), B 33 leaving the second tile one query.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize_int8_per_dim as jax_quantize
from repro.kernels import ref as jref
from repro_torch.benchmarks.many_queries import chunk_label, paged_view
from repro_torch.core.quantization import quantize_int8_per_dim
from repro_torch.kernels import ops
from test_torch_kernels import TOL, _assert_ids_equal_up_to_near_ties, _both

N, B = 1100, 33                 # three 512-row chunks, the last ragged


def _inputs(dtype, m, seed):
    """(jax D, jax Q, torch D, torch Q): int8 rows with the scale folded
    into the query in both packages."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, m)).astype(np.float32) / np.sqrt(m)
    Q = rng.standard_normal((B, m)).astype(np.float32)
    if dtype == "int8":
        jq, jscale = jax_quantize(jnp.asarray(D))
        tq, tscale = quantize_int8_per_dim(torch.from_numpy(D))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        return (jq, jnp.asarray(Q) * jscale[None, :], tq,
                torch.from_numpy(Q) * tscale[None, :])
    jD, tD = _both(D, dtype)
    jQ, tQ = _both(Q)
    return jD, jQ, tD, tQ


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("m", [16, 130, 384, 768])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_wide_tile_shapes_match_reference(dtype, m, k):
    jD, jQ, tD, tQ = _inputs(dtype, m, seed=m + k)
    s1, i1 = jref.topk_score_ref(jD, jQ, k=k)
    s2, i2 = ops.topk_score(tD, tQ, k=k)
    assert s2.shape == i2.shape == (B, k)
    _assert_ids_equal_up_to_near_ties(s1, i1, s2.numpy(), i2.numpy())
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)


@pytest.mark.parametrize("m", [16, 130, 384])
@pytest.mark.parametrize("quantize", [False, True])
def test_paged_view_pages_the_rows(quantize, m):
    """``paged_view``'s pages hold the rows in order (int8: each page
    quantized with its own scale row), and the paged top-k over them
    matches the dense one over the same rows (dequantized for int8)."""
    rng = np.random.default_rng(m)
    D = torch.from_numpy(rng.standard_normal((N, m)).astype(np.float32))
    (pool, table, nvalid, offset), ps = paged_view(D, 256, quantize)
    assert pool.shape == (5, 256, m) and table.tolist() == list(range(5))
    assert nvalid.tolist() == [256] * 4 + [N - 1024] and offset.tolist() == [0, 256, 512, 768, 1024]
    rows = pool.view(-1, m)[:N]
    if quantize:
        assert pool.dtype == torch.int8 and ps.shape == (5, m)
        rows = (pool.float() * ps[:, None, :]).view(-1, m)[:N]
        step = ps.repeat_interleave(256, 0)[:N]
        assert bool(((rows - D).abs() <= step / 2 + 1e-7).all())
        for p in range(5):
            q, s = quantize_int8_per_dim(D[256 * p:256 * (p + 1)])
            assert torch.equal(pool[p, :q.shape[0]], q) and torch.equal(ps[p], s)
    else:
        assert ps is None and torch.equal(rows, D)
    Q = torch.from_numpy(rng.standard_normal((B, m)).astype(np.float32))
    for k in (10, 100):
        s1, i1 = ops.topk_score(rows.contiguous(), Q, k=k)
        s2, i2 = ops.topk_score_paged(pool, table, nvalid, offset, 0, 5, Q, k=k, page_scale=ps)
        _assert_ids_equal_up_to_near_ties(s1.numpy(), i1.numpy(), s2.numpy(), i2.numpy())
        np.testing.assert_allclose(s2.numpy(), s1.numpy(), **TOL)


def _mangled(dtype, vec, mode, src, qn=32):
    """A chunk kernel's mangled name as nvcc gives it (bf16 named once,
    then by its substitution)."""
    d = {"f32": "f", "bf16": "13__nv_bfloat16", "int8": "a"}[dtype]
    inner = {"f32": "f", "bf16": "S1_", "int8": "a"}[dtype]
    s = {"dense": f"8DenseSrcI{inner}EE", "paged": f"8PagedSrcI{inner}Lb0EEE",
         "paged_scaled": f"8PagedSrcI{inner}Lb1EEE"}[src]
    return (f"_ZN46_GLOBAL__N__c86d1eea_13_topk_score_cu_8a8bc7a917topk_chunk_kernelI{d}"
            f"Lb{int(vec)}ELb{int(mode == 'list')}ENS_{s}Li{qn}EEEvT2_PKfiiiiilPmPi")


@pytest.mark.parametrize("src", ["dense", "paged", "paged_scaled"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_chunk_label_names_each_wide_instance(dtype, src):
    for vec in (True, False):
        for mode in ("keep", "list"):
            label = chunk_label(_mangled(dtype, vec, mode, src))
            assert label == f"{dtype},{'vec' if vec else 'scalar'},{mode},{src}"
    if src == "dense":              # the narrow tiles are other kernels
        for qn in (1, 8):
            assert chunk_label(_mangled(dtype, True, "keep", src, qn)) is None


def test_chunk_label_skips_other_kernels():
    assert chunk_label("_ZN46_GLOBAL__N__c86d1eea_13_topk_score_cu_8a8bc7a916topk_unit_kernel"
                       "IfLb1ELb0ENS_8DenseSrcIfEEEEvT2_PKfiiiilPmPi") is None
    assert chunk_label("_ZN46_GLOBAL__N__c86d1eea_13_topk_score_cu_8a8bc7a917topk_merge_kernel"
                       "EPKmiiiiPmPfPii") is None
