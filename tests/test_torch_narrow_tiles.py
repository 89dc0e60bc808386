"""The top-k at one to eight queries: the chunk kernel's narrow query tile
and the two-level select, as the host plans them, and the plain top-k at
such batches against ``repro``.

A dense call of B queries runs the chunk kernel with tiles of
``query_width(B)`` queries (1 at B 1, 8 at B 2 to 16, else 32), over ceil(B
/ width) tiles; a paged call keeps 32. In list mode (k > 32), where one CTA
a query would leave most SMs idle, the select takes two levels over
``select_groups`` groups of each query's segments, each group within the
fused select's limits. These tests hold the plans to that. The kernels
themselves are held bitwise against the 32-query tile and the one-level
select on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
3).

Here, with the plain versions on the CPU: the top-k at B 1, 2, 8 and 9
against ``repro``'s Pallas kernel in interpret mode (k 10 and 100) and its
jnp scan (k 1,000: interpret mode takes minutes at that k), rtol = atol =
1e-5, ids equal up to near-ties (the port's parity contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _scan_topk as jax_scan_topk
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.topk_score import (_FCAP, _FN, ChunkPlan, chunk_plan, dense_plan,
                                            items_plan, makespan, paged_plan, query_width,
                                            select_groups, wave_plan)
from test_torch_kernels import TOL, _assert_ids_equal_up_to_near_ties

SMS = 132                   # an H100 SXM
RETRIEVAL = 1_000_448       # retrieval_cand's candidates
MSMARCO = 8_841_823
SLOT = 250_112              # one slot of retrieval_cand's (2, 2) mesh


@pytest.mark.parametrize("B", range(1, 41))
def test_query_width_and_tiles(B):
    """B 1 takes a 1-query tile, B 2 to 16 8-query tiles, B 17 and up the
    32-query tile; the dense plan walks ceil(B / width) tiles, items over
    segs x tiles, and a paged plan keeps 32 queries a tile."""
    width = 1 if B == 1 else 8 if B <= 16 else 32
    assert query_width(B) == width
    for n in (RETRIEVAL, MSMARCO, 100_000):
        plan = dense_plan(n, B, SMS)
        tiles = -(-B // width)
        assert plan.upc == 8 and plan.qn == width
        assert plan == items_plan(plan.chunks, B, SMS, width)
        assert 1 <= plan.ctas <= min(SMS, plan.segs * tiles)
        assert makespan(plan.chunks, tiles, plan.segs, plan.ctas) >= -(-plan.chunks * tiles // SMS)
        old = wave_plan(plan.chunks, -(-n // 64), B, SMS)
        assert old.qn == width and old.ctas == tiles * old.segs
    assert paged_plan(34_539, 256, B, SMS).qn == 32
    assert chunk_plan(17_270, 8 * 17_270, B, SMS, 32).qn == 32


def test_narrow_plans_at_the_slices_shapes():
    """retrieval_cand at B 1 and a bucketed server's B 8 over MS MARCO: one
    tile, a segment an SM, so the query's chunks split over every SM."""
    assert dense_plan(RETRIEVAL, 1, SMS) == ChunkPlan(8, 1954, 132, 132, 1)
    assert dense_plan(SLOT, 1, SMS) == ChunkPlan(8, 489, 132, 132, 1)
    assert dense_plan(MSMARCO, 8, SMS) == ChunkPlan(8, 17_270, 132, 132, 8)
    assert dense_plan(MSMARCO, 32, SMS) == ChunkPlan(8, 17_270, 132, 132, 32)
    # few rows keep the unit kernel, whose CTAs take 16 queries whatever B
    assert dense_plan(4096, 1, SMS).upc == 1


def _group_bounds(segs: int, groups: int):
    """Segments [a, b) of each group, as the select kernel splits them."""
    return [(g * segs // groups, (g + 1) * segs // groups) for g in range(groups)]


@pytest.mark.parametrize("n", [RETRIEVAL, MSMARCO, SLOT, 100_000, 20_077])
@pytest.mark.parametrize("k", [10, 32, 33, 100, 1000, 8192, 8193])
def test_select_groups_fit_the_fused_select(n, k):
    """Two levels only for k > 32 on the chunk kernel's segments where B
    CTAs would leave most SMs idle (2 B <= SMs) and k fits the fused
    select; then 2 to min(segs, SMs // B) groups that split the segments
    evenly (each once), each group's rows within FCAP listed keys and the
    groups' k keys within FCAP: every CTA of both levels finishes in the
    fused kernel. One level where the most groups would still pass
    FCAP."""
    for B in range(1, 80):
        plan = dense_plan(n, B, SMS)
        groups = select_groups(B, plan, k, SMS)
        if k <= 32 or 2 * B > SMS or plan.upc != 8 or k > _FN:
            assert groups == 0, B
            continue
        sizes = [size for _, size in plan.segments()]
        if groups == 0:
            # one level only where even the most groups would pass FCAP
            most = min(plan.segs, SMS // B)
            assert any(sum(sizes[a:b]) > _FCAP for a, b in _group_bounds(plan.segs, most)), B
            continue
        assert 2 <= groups <= min(plan.segs, SMS // B), B
        assert groups * k <= _FCAP
        bounds = _group_bounds(plan.segs, groups)
        assert bounds[0][0] == 0 and bounds[-1][1] == plan.segs
        assert all(a < b for a, b in bounds)
        assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:]))
        per = [b - a for a, b in bounds]
        assert max(per) - min(per) <= 1
        assert all(sum(sizes[a:b]) <= _FCAP for a, b in bounds)


@pytest.mark.parametrize("n,B,k,groups", [
    (RETRIEVAL, 1, 100, 27), (RETRIEVAL, 8, 100, 15), (SLOT, 1, 100, 22),
    (MSMARCO, 1, 100, 27), (MSMARCO, 8, 100, 15), (MSMARCO, 32, 100, 0),
    (100_000, 1, 1000, 12), (RETRIEVAL, 67, 100, 0), (RETRIEVAL, 1, 10, 0)])
def test_select_groups_at_the_slices_shapes(n, B, k, groups):
    """The groups even out the two levels' keys: retrieval_cand's query lists
    about 534 keys a segment of 7,680 rows at k 100 (k (1 + ln(r / k))),
    132 segments, so about 27 groups of 5 segments and 2,700 keys in the
    second level; at B 8 at most 16 groups a query fill the SMs. At B 32
    over MS MARCO four groups of 33 segments would each hold 2.2M rows,
    past FCAP: one level, as before."""
    assert select_groups(B, dense_plan(n, B, SMS), k, SMS) == groups


def _reference(D, Q, k, n_valid):
    """``repro``'s top-k: its Pallas kernel in interpret mode, or at k 1,000
    its jnp scan over the live rows."""
    jD, jQ = jnp.asarray(D), jnp.asarray(Q)
    if k >= 1000:
        return jax_scan_topk(jD if n_valid is None else jD[:n_valid], jQ, k, block=1024)
    return jops.topk_score(jD, jQ, k=k, block_n=256, n_valid=n_valid, interpret=True)


@pytest.mark.parametrize("B", [1, 2, 8, 9])
@pytest.mark.parametrize("k", [10, 100, 1000])
@pytest.mark.parametrize("n_valid", [None, 1111])
def test_topk_plain_at_few_queries_matches_reference(B, k, n_valid):
    """The port's top-k at B 1, 2, 8 and 9 over 1,300 x 32 rows (not a
    multiple of the 512-row chunk), plain and with an n_valid mask,
    against ``repro``'s."""
    rng = np.random.default_rng(100 * B + k + (n_valid or 0))
    D = rng.standard_normal((1300, 32)).astype(np.float32)
    Q = rng.standard_normal((B, 32)).astype(np.float32)
    s1, i1 = _reference(D, Q, k, n_valid)
    s2, i2 = ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=k, n_valid=n_valid)
    assert s2.shape == i2.shape == (B, k)
    s1, i1 = np.asarray(s1), np.asarray(i1)
    np.testing.assert_allclose(s2.numpy(), s1, **TOL)
    _assert_ids_equal_up_to_near_ties(s1, i1, s2.numpy(), i2.numpy())
    if n_valid is not None:
        assert i2.numpy().max() < n_valid
