"""The plans of the small calls, and the small calls against ``repro``.

On the card, a projection of few rows (a query batch, an appended block)
takes ``pca_project``'s small kernel, and a top-k over few rows (a
shortlist's rescore, a live delta, a small paged pool) takes the unit
kernel: chunks of one 64-row unit. Both choices are plans computed on the
host (``project_path``, ``chunk_plan``), which the kernels take as given;
these tests hold the plans to what the kernels assume. The kernels
themselves are held bitwise to the other path on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

Here, with the plain versions on the CPU: ``transform_queries``,
``add_documents``, a live delta's search and the cascade's ``row_ids``
rescore at small sizes against ``repro`` (rtol = atol = 1e-5, ids equal
up to near-ties: the port's parity contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _delta_topk as ref_delta_topk
from repro.core.pruning import StaticPruner as JaxPruner
from repro.kernels import ops as ref_ops
from repro_torch.core.index import _delta_topk
from repro_torch.kernels import ops
from repro_torch.kernels.pca_project import project_path
from repro_torch.kernels.topk_score import (ChunkPlan, UNIT_CTAS_PER_SM, _listed, chunk_plan,
                                            dense_plan, items_plan, paged_chunks, paged_plan,
                                            unit_plan)
from test_torch_maintenance import _carried, _corpus, _pair
from test_torch_paged import _assert_close

SMS = 132                   # an H100 SXM
TOL = dict(rtol=1e-5, atol=1e-5)

# the small shapes of PERF.md's table: (name, plan)
SMALL = {
    "shortlist_3183": dense_plan(3183, 32, SMS),
    "cascade_rescore_2560": dense_plan(2560, 32, SMS),
    "delta_4096": dense_plan(4096, 32, SMS),
    "delta_4096_b1": dense_plan(4096, 1, SMS),
    "ids_pool_20x256": paged_plan(20, 256, 32, SMS),
    "paged_pages_of_8": paged_plan(38, 8, 3, SMS),
    "paged_pages_of_600": paged_plan(9, 600, 33, SMS),
}
LARGE = {
    "msmarco_8841823": dense_plan(8_841_823, 32, SMS),
    "paged_34539x256": paged_plan(34_539, 256, 32, SMS),
    "shard_2210456": dense_plan(2_210_456, 32, SMS),
    "retrieval_b1_1000448": dense_plan(1_000_448, 1, SMS),
    "encoder_b1000_100000": dense_plan(100_000, 1000, SMS),
}


# -- pca_project's path ------------------------------------------------------

@pytest.mark.parametrize("n,m,path", [
    (1, 384, "small"), (32, 384, "small"), (64, 384, "small"), (129, 384, "small"),
    (1536, 384, "small"), (1537, 384, "tiled"), (262_144, 384, "tiled"),
    (100_000, 384, "tiled"), (1_000_448, 128, "tiled"), (4864, 128, "small"),
    (4865, 128, "tiled"), (7, 130, "small")])
def test_project_path(n, m, path):
    """Small where the 128 x 128 grid would fill at most 29 % of the SMs
    (38 tiles of 132, where the two kernels meet): every query batch and
    appended block, and none of the full-size prunes."""
    assert project_path(n, m, SMS) == path


def test_project_path_is_monotone_in_n():
    for m in (64, 128, 130, 384, 768):
        paths = [project_path(n, m, SMS) for n in range(1, 6000, 37)]
        first_tiled = paths.index("tiled") if "tiled" in paths else len(paths)
        assert set(paths[first_tiled:]) <= {"tiled"}
        assert set(paths[:first_tiled]) <= {"small"}


# -- the top-k's plan ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_plans_are_the_chunk_kernels(name):
    """Indexes whose 512-row chunks fill their SMs keep the chunk kernel's
    plan: at most one CTA an SM, the SMs shared among the query tiles (one
    tile: a segment a CTA; 32 tiles over 100,000 rows: 8 segments a tile,
    128 CTAs, each on one tile)."""
    plan = LARGE[name]
    assert plan.upc == 8 and plan.rows == 512
    assert (plan.segs, plan.ctas) == {"encoder_b1000_100000": (8, 128)}.get(name, (SMS, SMS))


def test_msmarco_plan_is_unchanged():
    """At 8,841,823 rows and B 32: 132 CTAs of 512-row chunks."""
    assert dense_plan(8_841_823, 32, SMS) == ChunkPlan(8, 17_270, 132, 132)
    assert paged_plan(34_539, 256, 32, SMS) == ChunkPlan(8, 17_270, 132, 132)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_plans_fill_the_card(name):
    """Every small shape takes the unit kernel with one CTA a 64-row unit a
    query tile (two, each of 16 queries, for 32 queries)."""
    plan = SMALL[name]
    assert plan.upc == 1 and plan.rows == 64
    assert plan.segs == plan.chunks            # one CTA a unit
    assert plan.segs <= UNIT_CTAS_PER_SM * SMS


@pytest.mark.parametrize("n", [1, 63, 64, 65, 511, 513, 2560, 3183, 4096, 60_000, 67_583,
                               67_584, 67_585, 1_000_000])
@pytest.mark.parametrize("B", [1, 32, 33, 65, 1000])
def test_chunk_plan_switches_where_the_chunks_fill_the_tile(n, B):
    plan = dense_plan(n, B, SMS)
    per_tile = -(-SMS // -(-B // 32))
    big, units = -(-n // 512), -(-n // 64)
    if big >= per_tile or units > UNIT_CTAS_PER_SM * per_tile:
        assert plan == items_plan(big, B, SMS) and plan.upc == 8
        assert plan.segs >= min(big, per_tile) and plan.ctas <= SMS
    else:
        assert plan == ChunkPlan(1, units, units, units * -(-B // 16))


@pytest.mark.parametrize("n,upc", [(2560, 1), (20_000, 1), (25_344, 1), (25_345, 8),
                                   (60_000, 8), (67_583, 8)])
def test_the_unit_kernel_takes_at_most_two_waves(n, upc):
    """At B 32 the unit kernel takes up to 3 x 132 units (25,344 rows): its
    two CTAs a unit then fill at most two waves; above that the chunk
    kernel's plan, as before (60,000 rows: 118 CTAs of one chunk)."""
    plan = dense_plan(n, 32, SMS)
    assert plan.upc == upc
    if upc == 8:
        assert plan.segs == plan.ctas == min(plan.chunks, SMS)


@pytest.mark.parametrize("R", [8, 64, 100, 150, 256, 512, 600, 1024])
def test_paged_chunks_match_the_unit_layout(R):
    """A paged walk's chunks: whole pages a chunk up to upc units, else a
    page over ceil(U / upc) chunks; at upc 1 a chunk is one unit."""
    U = -(-R // 64)
    for slots in (0, 1, 7, 20, 301):
        assert paged_chunks(slots, R, 1) == slots * U
        big = paged_chunks(slots, R, 8)
        assert big == (-(-slots // (8 // U)) if U <= 8 else slots * -(-U // 8))
        assert big * 8 >= slots * U


def _all_plans():
    plans = dict(SMALL, **LARGE)
    plans["ragged"] = chunk_plan(10, 77, 32, SMS)
    plans["walk"] = ChunkPlan(8, 1000, 132, 132)
    plans["empty"] = chunk_plan(0, 0, 32, SMS)
    return plans


@pytest.mark.parametrize("name", sorted(_all_plans()))
def test_every_row_lands_in_one_segment(name):
    """Segment x's item walks chunks x, x + segs, ...: its segment has room
    for every row of them, and the segments tile a query's row of keys in
    order."""
    plan = _all_plans()[name]
    segs = plan.segments()
    assert len(segs) == plan.segs
    pos = 0
    for x, (start, size) in enumerate(segs):
        assert start == pos
        walked = len(range(x, plan.chunks, plan.segs))
        assert size == walked * plan.rows
        pos += size
    assert pos == plan.chunks * plan.rows
    # row r of the walk: chunk r // rows, walked by segment (r // rows) % segs
    if plan.segs:
        for r in {0, plan.rows - 1, plan.rows, plan.chunks * plan.rows - 1}:
            c = r // plan.rows
            x = c % plan.segs
            start, size = segs[x]
            assert start <= start + (c // plan.segs) * plan.rows + r % plan.rows < start + size


@pytest.mark.parametrize("name", ["shortlist_3183", "delta_4096", "ids_pool_20x256",
                                  "paged_pages_of_600", "ragged"])
@pytest.mark.parametrize("extra", [0, 40])
def test_listed_reads_the_plans_segments(name, extra):
    """``_listed`` (what a list-mode call listed, read back from its
    scratch) finds each item's keys at its plan's segment start, with its
    count, then a carry's ``extra`` keys."""
    plan = _all_plans()[name]
    B, base = 3, 5
    ldq = plan.chunks * plan.rows + extra
    rng = np.random.default_rng(0)
    scratch = torch.zeros(base + B * ldq + (B * plan.segs + 1) // 2 + 4, dtype=torch.int64)
    keys = scratch[base:base + B * ldq].view(B, ldq)
    counts = rng.integers(0, 5, size=(B, plan.segs)).astype(np.int32)
    want = []
    for b in range(B):
        row = []
        for x, (start, size) in enumerate(plan.segments()):
            c = min(int(counts[b, x]), size)
            counts[b, x] = c
            vals = torch.arange(c, dtype=torch.int64) + 1000 * (b + 1) + 100 * x + 1
            keys[b, start:start + c] = vals
            row.append(vals)
        tail = torch.arange(extra, dtype=torch.int64) + 7_000_000 + b
        keys[b, plan.chunks * plan.rows:plan.chunks * plan.rows + extra] = tail
        want.append(torch.cat(row + [tail]))
    scratch[base + B * ldq:].view(torch.int32)[:B * plan.segs] = torch.from_numpy(
        counts.reshape(-1))
    got_counts, pack = _listed(scratch, base, B, plan, ldq, extra)
    assert got_counts.tolist() == [int(w.numel()) for w in want]
    packed = pack()
    for b in range(B):
        assert torch.equal(packed[b, :want[b].numel()], want[b])
        assert not packed[b, want[b].numel():].any()


# -- the small calls against repro, on the CPU ---------------------------------

@pytest.mark.parametrize("nq", [1, 7, 32, 64])
def test_transform_queries_matches_reference(nq):
    D = _corpus(n=600)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Q = _corpus(seed=3, n=nq)
    want = np.asarray(jp.transform_queries(jnp.asarray(Q)))
    got = tp.transform_queries(torch.from_numpy(Q))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_add_documents_64_row_blocks_match_reference(quant):
    """Appends in the live path's 64-row blocks, then a search over base and
    delta, against the reference's updater."""
    D = _corpus(n=800)
    jup, tup = _pair(D, quant=quant, delta_capacity=256)
    new = _corpus(seed=0, n=300, domain_seed=1)[:192]
    for i in range(0, len(new), 64):
        jup.add_documents(jnp.asarray(new[i:i + 64]))
        tup.add_documents(torch.from_numpy(new[i:i + 64]))
    assert tup.index.n == jup.index.n
    np.testing.assert_allclose(tup.index.deltas[0].raw, jup.index.deltas[0].raw, **TOL)
    _assert_close(jup.search(jnp.asarray(new[:9]), k=10), tup.search(torch.from_numpy(new[:9]),
                                                                   k=10))


@pytest.mark.parametrize("n_valid", [0, 1, 63, 64, 65, 181, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_delta_search_matches_reference(n_valid, int8):
    """A 256-row delta (four units) at live counts on and off a unit edge."""
    rng = np.random.default_rng(n_valid)
    cap, m, B, k = 256, 24, 5, 10
    if int8:
        D = rng.integers(-127, 128, size=(cap, m)).astype(np.int8)
        scale = (rng.random(m) * 0.05 + 0.01).astype(np.float32)
    else:
        D = rng.standard_normal((cap, m)).astype(np.float32)
        scale = None
    D[n_valid:] = 0
    Q = rng.standard_normal((B, m)).astype(np.float32)
    want = ref_delta_topk(jnp.asarray(D), None if scale is None else jnp.asarray(scale),
                          jnp.asarray(Q), jnp.int32(n_valid), jnp.int32(5000), k)
    got = _delta_topk(torch.from_numpy(D), None if scale is None else torch.from_numpy(scale),
                      torch.from_numpy(Q), torch.tensor(n_valid, dtype=torch.int32), 5000, k)
    _assert_close(want, got)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 100])
def test_row_ids_rescore_matches_reference(k):
    """The cascade's rescore: a gathered shortlist of 320 rows (five units)
    reporting shuffled ids, a tenth masked, through the interpret-mode
    Pallas kernel and the port's ``ops.topk_score``."""
    rng = np.random.default_rng(k)
    U, m, B = 320, 48, 6
    D = rng.standard_normal((U, m)).astype(np.float32) / m ** 0.5
    Q = rng.standard_normal((B, m)).astype(np.float32)
    ids = (rng.permutation(U) + 900).astype(np.int32)
    ids[rng.permutation(U)[:U // 10]] = -1
    want = ref_ops.topk_score(jnp.asarray(D), jnp.asarray(Q), k=k, row_ids=jnp.asarray(ids))
    got = ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=k,
                         row_ids=torch.from_numpy(ids))
    _assert_close(want, got)


# -- the in-turns benchmark's other build and forced kernels --------------------

class _Lib:
    """A stand-in library: an attribute for any C entry."""

    def __getattr__(self, fn):
        entry = type("Entry", (), {})()
        setattr(self, fn, entry)
        return entry


@pytest.mark.parametrize("name", ["pca_project", "topk_score"])
def test_other_build_runs_through_its_own_wrapper(name):
    """``turns.load_other``'s binding: a tree's wrapper module, loaded on
    its own, whose ``_build.load`` returns that build's library with the
    module's own C signatures set, while this tree's wrapper keeps its
    loader."""
    import importlib
    import sys
    from pathlib import Path
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build
    this = importlib.import_module(f"repro_torch.kernels.{name}")
    lib = _Lib()
    other = turns._bound(Path(this.__file__), lib, f"_other_test_{name}")
    assert other is not this and other.__name__ not in sys.modules
    assert other._build.load(name, {}) is lib and other._build.check is _build.check
    for fn, (restype, argtypes) in other._SIGNATURES.items():
        assert getattr(lib, fn).restype is restype and getattr(lib, fn).argtypes == argtypes
    assert this._build is _build


@pytest.mark.parametrize("upc,n,B,paged", [(1, 60_000, 32, False), (8, 2560, 32, False),
                                           (8, 4096, 1, False), (1, 8_841_823, 32, False),
                                           (8, 20, 32, True), (1, 200, 32, True)])
def test_forced_plan_is_the_other_kernels_and_undone(upc, n, B, paged):
    """``small_calls.forced_plan``: inside it every top-k plan is the named
    kernel's (the unit kernel one CTA a unit; the chunk kernel at most a
    tile's SMs), and outside it the plan is ``chunk_plan``'s again."""
    from repro_torch.benchmarks.small_calls import forced_plan

    def plan():
        return paged_plan(n, 256, B, SMS) if paged else dense_plan(n, B, SMS)

    before = plan()
    big, units = ((paged_chunks(n, 256, 8), paged_chunks(n, 256, 1)) if paged
                  else (-(-n // 512), -(-n // 64)))
    with forced_plan(upc):
        got = plan()
    assert got == (unit_plan(units, B) if upc == 1 else items_plan(big, B, SMS))
    assert got.upc == upc
    assert plan() == before


@pytest.mark.parametrize("path", ["small", "tiled"])
def test_forced_path_is_the_named_kernel_and_undone(path):
    from repro_torch.benchmarks.small_calls import forced_path
    from repro_torch.kernels import pca_project
    with forced_path(path):
        assert {pca_project.project_path(n, 384, SMS) for n in (1, 1537, 262_144)} == {path}
    assert pca_project.project_path(1, 384, SMS) == "small"
    assert pca_project.project_path(262_144, 384, SMS) == "tiled"
