"""The chunk kernel's plan over many query tiles, and the top-k at such
batches against ``repro``.

A call of B queries runs ``items_plan``'s persistent CTAs over (segment,
query tile) items: CTA g takes items g, g + ctas, ..., item i being
segment i // tiles of tile i % tiles, and segment x's item walks chunks x,
x + segs, ... These tests walk the plan as the kernel does (``_walk``) and
hold it to what the kernel and the select assume: every (chunk, tile)
pair once, at most one CTA an SM, no CTA far past the even share, the
walk before persistent items (``wave_plan``) wherever that already fills
one wave, and the list mode's segments read back by ``_listed``. The
kernel itself is held bitwise against ``wave_plan``'s walk on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).

Here, with the plain versions on the CPU: the top-k at B 200 and 1,000
against ``repro``'s oracle (rtol = atol = 1e-5, ids equal up to near-ties:
the port's parity contract).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.topk_score import (RESTART, SEG_SPAN, ChunkPlan, _listed, chunk_plan,
                                            dense_plan, items_plan, makespan, paged_plan,
                                            restarts, wave_plan)
from test_torch_kernels import TOL, _assert_ids_equal_up_to_near_ties

# every B to 4,224 (132 tiles), then a stride to the largest group a C call takes
BATCHES = list(range(1, 4225)) + list(range(4225, 65505, 611)) + [65504]
CHUNKS = (196, 4318, 17270)     # 100,000 rows; 2,210,456 (a shard of four); 8,841,823


def _walk(plan: ChunkPlan, B: int):
    """The chunk kernel's items as it takes them: (cta, segment, tile) of
    every item, and the chunks each walks."""
    tiles = -(-B // plan.qn)
    i = np.arange(plan.segs * tiles)
    x = i // tiles
    walked = (plan.chunks - x + plan.segs - 1) // plan.segs
    return i % plan.ctas, x, i % tiles, walked


@functools.lru_cache(maxsize=None)
def _partition(chunks: int, segs: int) -> bool:
    """Segments x, x + segs, ... of range(chunks) cover each chunk once."""
    hits = np.zeros(chunks, dtype=np.int64)
    for x in range(segs):
        hits[x::segs] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_covers_each_chunk_and_tile_once_within_one_wave(sms, chunks):
    """For every B: at most ``sms`` CTAs, every (segment, tile) item once
    and every chunk once within a segment (so every (chunk, tile) pair
    once), ``makespan`` the most chunks a CTA walks, ``restarts`` the
    tiles CTA 0 starts, fewer CTAs than SMs only where each keeps one
    tile, and no CTA more than ceil(chunks / segs) chunks past the even
    share."""
    for B in BATCHES:
        plan = chunk_plan(chunks, 8 * chunks, B, sms)
        tiles = -(-B // plan.qn)
        assert plan.upc == 8 and plan.chunks == chunks
        assert 1 <= plan.segs <= chunks and 1 <= plan.ctas <= min(sms, plan.segs * tiles)
        cta, x, tile, walked = _walk(plan, B)
        items = np.unique(x * tiles + tile)
        assert items.size == x.size == plan.segs * tiles
        assert _partition(chunks, plan.segs)
        assert int(walked.sum()) == chunks * tiles
        loads = np.bincount(cta, weights=walked, minlength=plan.ctas)
        assert (loads > 0).all()
        span = makespan(chunks, tiles, plan.segs, plan.ctas)
        assert loads.max() == span, B
        first = tile[cta == 0]
        assert restarts(tiles, plan.segs, plan.ctas) == 1 + int((first[1:] != first[:-1]).sum())
        if plan.ctas < min(sms, plan.segs * tiles):
            assert plan.ctas % tiles == 0 and (tile == cta % tiles).all(), B
        assert span - tiles * chunks / sms <= -(-chunks // plan.segs), B


@pytest.mark.parametrize("sms", [132, 114])
def test_plan_keeps_the_walk_that_fills_one_wave(sms):
    """Where one CTA a segment and tile fills at most one wave (B <= 32, and
    33 to 128 at 132 SMs), the plan is the walk before persistent items;
    past it the plan never runs more CTAs than SMs, where that walk did."""
    for chunks in CHUNKS:
        for B in range(1, 4225, 7):
            got = chunk_plan(chunks, 8 * chunks, B, sms)
            old = wave_plan(chunks, 8 * chunks, B, sms)
            if old.ctas <= sms:
                assert got == old, (chunks, B)
            else:
                assert got.ctas <= sms < old.ctas
    for B in (1, 32, 33, 64, 65, 100, 128):
        assert chunk_plan(196, 1568, B, 132) == wave_plan(196, 1568, B, 132)


@pytest.mark.parametrize("B,chunks,segs,ctas,span", [
    (200, 196, 36, 126, 11), (200, 17270, 113, 132, 917), (1000, 196, 8, 128, 49),
    (1000, 17270, 33, 132, 4187), (2048, 196, 4, 128, 98), (2048, 17270, 4, 128, 8635),
    (6980, 196, 3, 132, 327), (6980, 17270, 3, 132, 28784)])
def test_plan_makespans(B, chunks, segs, ctas, span):
    """The plans at 132 SMs of the protocol's 200 queries, the encoder's
    1,000, 2,048 and MS MARCO dev's 6,980, over 100,000 and 8,841,823 rows:
    the walk before persistent items took about 1.2 to 2 times these
    makespans (its CTAs past the 132nd in a second wave, as if each SM took
    every 132nd); the least makespan over every SM is at most a chunk or a
    few restarts better, where the plan keeps each CTA on one tile."""
    plan = items_plan(chunks, B, 132)
    tiles = -(-B // 32)
    assert (plan.segs, plan.ctas) == (segs, ctas)
    assert makespan(chunks, tiles, segs, ctas) == span
    old = wave_plan(chunks, 8 * chunks, B, 132)
    assert old.ctas > 132
    assert makespan(chunks, tiles, old.segs, 132) >= 1.19 * span
    assert plan.segs <= SEG_SPAN * old.segs
    cost = span + RESTART * restarts(tiles, segs, ctas)
    for S in range(old.segs, min(chunks, SEG_SPAN * old.segs) + 1):
        G = min(132, tiles * S)
        assert cost <= makespan(chunks, tiles, S, G) + RESTART * restarts(tiles, S, G)


@pytest.mark.parametrize("name,plan,B", [
    ("dense_b200_100000", dense_plan(100_000, 200, 132), 200),
    ("dense_b1000_100000", dense_plan(100_000, 1000, 132), 1000),
    ("paged_b200_4096x256", paged_plan(4096, 256, 200, 132), 200),
    ("dense_b4225_20000", dense_plan(20_000, 4225, 132), 4225)])
@pytest.mark.parametrize("extra", [0, 100])
def test_listed_reads_every_segment_of_a_many_tile_plan(name, plan, B, extra):
    """A list-mode call over many tiles writes B x segs counts: ``_listed``
    finds each item's keys at its segment's start, every row of the walk
    lands in its query's row exactly once, then a carry's ``extra`` keys."""
    assert plan.upc == 8 and plan.segs > -(-132 // -(-B // 32))
    rows = plan.chunks * plan.rows
    ldq = rows + extra
    owner = np.zeros(rows, dtype=np.int64)
    for x, (start, size) in enumerate(plan.segments()):
        for j, c in enumerate(range(x, plan.chunks, plan.segs)):
            owner[start + j * plan.rows:start + (j + 1) * plan.rows] += 1
            assert j * plan.rows < size
    assert (owner == 1).all()
    b = 3                                   # queries of the read-back
    rng = np.random.default_rng(B)
    counts = np.stack([rng.integers(0, size + 1, size=b) for _, size in plan.segments()], 1)
    scratch = torch.zeros(b * ldq + (b * plan.segs + 1) // 2 + 1, dtype=torch.int64)
    keys = scratch[:b * ldq].view(b, ldq)
    want = []
    for q in range(b):
        row = []
        for x, (start, _) in enumerate(plan.segments()):
            vals = torch.arange(int(counts[q, x]), dtype=torch.int64) + 10_000 * x + 1
            keys[q, start:start + vals.numel()] = vals
            row.append(vals)
        tail = torch.arange(extra, dtype=torch.int64) + 9_000_000
        keys[q, rows:rows + extra] = tail
        want.append(torch.cat(row + [tail]))
    scratch[b * ldq:].view(torch.int32)[:b * plan.segs] = torch.from_numpy(
        counts.astype(np.int32).reshape(-1))
    got, pack = _listed(scratch, 0, b, plan, ldq, extra)
    assert got.tolist() == [w.numel() for w in want]
    packed = pack()
    for q in range(b):
        assert torch.equal(packed[q, :want[q].numel()], want[q])


@pytest.mark.parametrize("B", [200, 1000])
@pytest.mark.parametrize("k", [10, 1000])
def test_topk_score_many_tiles_matches_reference(B, k):
    """The port's top-k at B 200 and 1,000 (the protocol's and the
    encoder's batches) over 3,000 x 64 rows against ``repro``'s oracle."""
    rng = np.random.default_rng(B + k)
    D = rng.standard_normal((3000, 64)).astype(np.float32)
    Q = rng.standard_normal((B, 64)).astype(np.float32)
    s1, i1 = jref.topk_score_ref(jnp.asarray(D), jnp.asarray(Q), k=k)
    s2, i2 = ops.topk_score(torch.from_numpy(D), torch.from_numpy(Q), k=k)
    assert s2.shape == i2.shape == (B, k)
    _assert_ids_equal_up_to_near_ties(s1, i1, s2.numpy(), i2.numpy())
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), **TOL)
