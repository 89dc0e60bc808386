"""Exact top-k of ``Q @ D^T``: the CUDA kernels and their plain versions.

Replaces ``repro/kernels/topk_score.py::topk_score_pallas`` in both of its
modes: plain (ids are row positions, rows with id >= ``n_valid`` are
masked) and ``row_ids`` rescore (row j reports ``row_ids[j]``, negative ids
are masked). Outputs are (B, k) f32 scores sorted descending and (B, k)
int32 ids; ties go to the lowest id; slots with no candidate are
(-inf, -1). Any k >= 1 runs.

The kernels (``csrc/topk_score.cu``) split n over CTAs, since at serving
batch sizes one CTA per query tile would leave most of the card idle: at
most one persistent CTA per SM takes (segment, query tile) items, each
walking every S-th 512-row chunk for a tile of 32 queries (dense rows at B
<= 16: 1 or 8, ``query_width``), or, where those chunks are
fewer than the SMs a query tile may have and its 64-row units fit two waves
(a shortlist's rescore, a live delta), a CTA takes each unit (``chunk_plan``
decides and the C entries take its plan). For k <= 32 it
keeps each chunk's top k against a running threshold and a merge kernel
reduces the per-chunk lists; for larger k it lists, compacted into its own
segment of each query's row, only the keys at or above a running
per-query threshold, with a count a segment, and a select that walks the
listed keys takes the top k (one CTA a query where they fit its budget,
in two levels over groups of segments where few queries would leave most
SMs idle, ``select_groups``; else a multi-CTA radix select). Candidates
are compared as (score desc, id asc) keys, so the result does not depend
on visit order nor on which keys below the k-th a threshold skipped. Above
k = 32 the scratch keeps room for one 8-byte key per row and query, so a
call walks its queries in groups whose scratch fits ``SCRATCH_BYTES`` (at
least 32 queries a group). A group also holds at most ``MAX_GROUP`` queries, since one launch
of the merge and select kernels takes at most 65,535: so every wrapper
takes any B.

``topk_score_paged_cuda`` replaces ``topk_score_paged_pallas``: the same
top-k over logical slots [lo, hi) of a page table (pool and tail tiers,
per-page scale, ``page_nvalid`` masks and ``page_offset`` ids, the
``ids_pool`` rescore mode, ``carry`` / ``finalize`` chaining), through the
same chunk kernel with a paged row source and the same select; the carry
is one more list (k <= 32) or k more keys. [lo, hi) may be host ints or
0-d device tensors, as the reference's traced scalars; with tensors the
host never reads the range.

``topk_select_cuda`` is the large-k select alone, over rows of keys as the
chunk kernel lists them, each row optionally cut to a live count;
``topk_select_plain`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

SCRATCH_BYTES = 4 << 30    # scratch of one C call, above which queries are grouped
# queries of one C call: the merge and select kernels put one query on each
# gridDim.y (at most 65,535), so a call takes the largest multiple of the
# 32-query tile below that
MAX_GROUP = 65504
_P = ctypes.c_void_p
_SIGNATURES = {
    "topk_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]),
    "topk_score_f32": (ctypes.c_int, [
        _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5),
    "topk_paged_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int64)]),
    "topk_score_paged_f32": (ctypes.c_int, [_P] * 10 + [ctypes.c_int] * 7 + [_P] * 2
                             + [ctypes.c_int] * 4 + [_P] * 4
                             + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3),
    "topk_select_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int64)]),
    "topk_select_keys": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, _P, _P, _P, _P,
                                        ctypes.POINTER(ctypes.c_int)]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_SIGN = -(1 << 63)         # the CUDA keys are the plain keys with the top bit flipped
# csrc/topk_score.cu's geometry: queries a tile (CQ), rows a chunk of the
# chunk kernel (CR), rows a unit (UNIT: a warp's block, a paged unit, a
# chunk of the unit kernel), units a chunk (UPC), 8-byte words a unit of a
# paged unit table (sizeof(Unit) / 8), k of the register select (SMALL_K),
# queries a CTA of the unit kernel (UCQ)
_CQ, _CR, _UNIT, _UPC, _UNIT_WORDS, _SMALL_K, _UCQ = 32, 512, 64, 8, 3, 32, 16
# the fused select's limits: keys it gathers and sorts (FN), listed keys a
# query (FCAP)
_FN, _FCAP = 8192, 1 << 20
# unit-kernel CTAs an SM holds at once (57 KB of shared memory each at m
# 384: half the query tile and the ring; 128 threads of at most 170
# registers); a 32-query tile takes two CTAs a unit. ``chunk_plan`` gives
# the unit kernel at most this many units a tile's SM: on an H100 the chunk
# kernel overtakes it between 3 and 3.4 units an SM at k 100 (25,344 and
# 28,672 rows at B 32) and near 4.4 at k 10 (36,864 rows), as
# ``benchmarks/small_calls.py`` times them, so neither k loses to the switch
UNIT_CTAS_PER_SM = 3
# segment counts ``items_plan`` tries for the chunk kernel: S0 = min(chunks,
# ceil(sms / tiles)) to SEG_SPAN S0. At 7 tiles (B 200) that reaches a
# segment an SM, which splits any chunk count evenly; wider spans would
# win a chunk or two a CTA at B 2,048 and above, for ten times the
# segments the list mode's select reads
SEG_SPAN = 8
# what ``items_plan`` charges, in 512-row chunks, each time a CTA starts an
# item of another query tile than its last: its running lists and
# thresholds start afresh, so the item's first chunks list and select many
# keys. On an H100 at B 1,000 over 100,000 rows, k 10, that took about 75
# us a restart at m 384 and 768 (a chunk's walk: 56 and 112 us), from
# ``benchmarks/many_queries.py``'s plan (one restart a CTA) against its
# spread_plan (eight). Where a CTA keeps one tile (its CTAs a multiple of
# the tiles), it starts once
RESTART = 1


class ChunkPlan(NamedTuple):
    """A call's walk: chunks of ``upc`` 64-row units (8: the chunk kernel's
    512 rows; 1: the unit kernel's 64), ``chunks`` of them, in ``segs``
    segments a query. Item (x, tile), segment x of a tile of ``qn`` queries
    (the chunk kernel's: 32, or 1 or 8 for dense rows), walks chunks x, x +
    segs, ...; in list mode it owns segment x of each of its queries' row of
    keys. ``ctas`` CTAs run the items: the chunk kernel's persistent CTA g
    takes items i = g, g + ctas, ... (x = i // tiles, tile = i % tiles, tiles
    = ceil(B / qn)); the unit kernel launches one CTA an item and 16
    queries."""
    upc: int
    chunks: int
    segs: int
    ctas: int
    qn: int = _CQ

    @property
    def rows(self) -> int:
        return _UNIT * self.upc

    def segments(self) -> list[tuple[int, int]]:
        """(first key slot, key slots) of each segment of a query's row:
        room for every row of the chunks its item walks."""
        qn, rn = divmod(self.chunks, self.segs) if self.segs else (0, 0)
        return [((x * qn + min(x, rn)) * self.rows, (qn + (x < rn)) * self.rows)
                for x in range(self.segs)]


def makespan(chunks: int, tiles: int, segs: int, ctas: int) -> int:
    """The most chunks one CTA of the chunk kernel walks over ``segs`` x
    ``tiles`` items: CTA 0's. CTA g takes ceil((items - g) / ctas) items,
    and those below item rn x tiles (rn = chunks % segs: segments of one
    chunk more) number ceil((rn x tiles - g) / ctas); both fall with g."""
    qn, rn = divmod(chunks, segs)
    return -(-tiles * segs // ctas) * qn + -(-rn * tiles // ctas)


def query_width(B: int) -> int:
    """The chunk kernel's queries a tile for B dense queries: 1 at B 1, 8 at
    B 2 to 16, else 32. The narrow tiles issue only their queries' FMAs, so
    at B <= 8 the bytes set the pace; at B 9 to 16 two 8-query tiles, whose
    CTAs read the same chunks at once (the second read mostly from L2),
    beat one 32-query tile on an H100 at every measured shape but f32 at B
    9 over 8.8M rows (PERF.md). The width comes from B alone, never
    from a count read on the card, so a captured CUDA graph replays."""
    return 1 if B == 1 else 8 if B <= 16 else _CQ


def _takes_chunks(big_chunks: int, units: int, B: int, sms: int) -> bool:
    """Whether the chunk kernel takes the call: its 512-row chunks fill the
    ceil(sms / tiles) SMs a query tile may have, or the units are more than
    UNIT_CTAS_PER_SM a tile's SM (the unit kernel's two CTAs a unit would
    take more than two waves, and it spends more time a row than the chunk
    kernel)."""
    per_tile = -(-sms // -(-B // _CQ))
    return big_chunks >= per_tile or units > UNIT_CTAS_PER_SM * per_tile


def unit_plan(units: int, B: int) -> ChunkPlan:
    """The unit kernel's walk: a segment a unit, a CTA an item and 16
    queries."""
    return ChunkPlan(1, units, units, units * -(-B // _UCQ))


def restarts(tiles: int, segs: int, ctas: int) -> int:
    """Items of CTA 0 that start on another query tile than its last: one
    where the CTAs are a multiple of the tiles (item i's tile is i %
    tiles, so a CTA keeps its tile), else each of its items."""
    return 1 if ctas % tiles == 0 else -(-tiles * segs // ctas)


def items_plan(chunks: int, B: int, sms: int, qn: int | None = None) -> ChunkPlan:
    """The chunk kernel's walk of B queries over ``chunks`` 512-row chunks
    on a card of ``sms`` SMs, in tiles of ``qn`` queries (default: the dense
    ``query_width(B)``): at most ``sms`` persistent CTAs over ``segs`` x
    tiles items, tiles = ceil(B / qn). The segment counts from S0 =
    min(chunks, ceil(sms / tiles)) to min(chunks, SEG_SPAN S0) are tried
    with min(sms, tiles x segs) CTAs and, where tiles <= sms, with tiles x
    (sms // tiles), which keeps each CTA on one tile; the least
    ``makespan`` plus RESTART a
    ``restarts`` wins, then the fewest segments (the select reads fewer),
    then the most CTAs. Where S0 segments a tile fill one wave (B <= 32,
    and 33 to 128 at 132 SMs) that is S0 with a CTA an item; else no CTA
    walks more than ceil(chunks / segs) chunks past the even share (tiles
    x chunks / sms), where one CTA an item would run a second, nearly empty
    wave."""
    return _items_plan(chunks, B, sms, query_width(B) if qn is None else qn)


@functools.lru_cache(maxsize=4096)
def _items_plan(chunks: int, B: int, sms: int, qn: int) -> ChunkPlan:
    tiles = -(-B // qn)
    s0 = min(chunks, -(-sms // tiles))
    best = None
    for S in range(s0, min(chunks, SEG_SPAN * s0) + 1):
        for G in {min(sms, tiles * S), tiles * (sms // tiles)}:
            if 0 < G <= tiles * S:
                cost = (makespan(chunks, tiles, S, G) + RESTART * restarts(tiles, S, G), S, -G)
                best = min(best or cost, cost)
    return ChunkPlan(_UPC, chunks, best[1], -best[2], qn)


def chunk_plan(big_chunks: int, units: int, B: int, sms: int,
               qn: int | None = None) -> ChunkPlan:
    """The walk of a call of B queries over ``big_chunks`` 512-row chunks
    or ``units`` 64-row units, on a card of ``sms`` SMs: ``items_plan``
    (tiles of ``qn`` queries; default the dense ``query_width(B)``) where
    ``_takes_chunks``, else ``unit_plan``. The plan depends on the capacity
    (n, the planned slots) and B, never on a live count read on the card,
    so a captured CUDA graph replays at any count."""
    if _takes_chunks(big_chunks, units, B, sms):
        return items_plan(big_chunks, B, sms, qn)
    return unit_plan(units, B)


def wave_plan(big_chunks: int, units: int, B: int, sms: int,
              qn: int | None = None) -> ChunkPlan:
    """``chunk_plan`` with the chunk kernel's walk before its persistent
    items: S0 segments a tile and one CTA an item (tiles x S0 CTAs, a
    second wave where that passes ``sms``). The tests and ``chip_smoke.py``
    patch it in for ``chunk_plan`` to hold ``items_plan`` bitwise against
    it on one build."""
    if not _takes_chunks(big_chunks, units, B, sms):
        return unit_plan(units, B)
    qn = query_width(B) if qn is None else qn
    tiles = -(-B // qn)
    s0 = min(big_chunks, -(-sms // tiles))
    return ChunkPlan(_UPC, big_chunks, s0, tiles * s0, qn)


def dense_plan(n: int, B: int, sms: int) -> ChunkPlan:
    """``chunk_plan`` of a dense call over n rows (tiles of
    ``query_width(B)`` queries)."""
    return chunk_plan(-(-n // _CR), -(-n // _UNIT), B, sms)


@functools.lru_cache(maxsize=4096)
def select_groups(B: int, plan: ChunkPlan, k: int, sms: int) -> int:
    """Groups of a query's segments for the list mode's select in two
    levels (``csrc/topk_score.cu::run_select``), or 0 for one level. Two
    levels where one CTA a query would leave most of the ``sms`` SMs idle
    (2 B <= sms) on the chunk kernel's segments at k > 32: B x groups CTAs
    each keep the top k of a group of segments, then one CTA a query the
    top k of the groups' keys. The groups even out the two levels' keys
    (listed / groups against groups x k): a segment of r rows lists about
    k (1 + ln(r / k)) keys under the running threshold, or all r at k > 512
    or r <= k; at most sms // B groups a query, the segments split evenly,
    and more groups where a group's rows would pass FCAP.
    The C side's ``two_level_ok`` holds each group and the second level
    to the fused select's limits (keys within FCAP, k within FN), as
    here."""
    if k <= _SMALL_K or plan.upc != _UPC or 2 * B > sms or k > _FN:
        return 0
    rows = -(-plan.chunks // plan.segs) * plan.rows       # rows a segment holds, at most
    listed = rows if k > _CR or rows <= k else k * (1 + math.log(rows / k))
    most = min(plan.segs, sms // B)
    sizes = [size for _, size in plan.segments()]
    for want in range(max(2, min(most, round(math.sqrt(plan.segs * listed / k)))), most + 1):
        groups = -(-plan.segs // -(-plan.segs // want))   # ceil(segs / want) segments a group
        if groups * k > _FCAP:
            break
        if all(sum(sizes[g * plan.segs // groups:(g + 1) * plan.segs // groups]) <= _FCAP
               for g in range(groups)):
            return groups
    return 0


def paged_chunks(slots: int, R: int, upc: int) -> int:
    """Chunks of ``upc`` units of a paged walk over ``slots`` slots of R
    rows (the C side's paged_geom): a chunk holds upc // U whole pages of
    U = ceil(R / 64) units, or a page spans ceil(U / upc) chunks."""
    U = -(-R // _UNIT)
    return -(-slots // (upc // U)) if U <= upc else slots * -(-U // upc)


def paged_plan(slots: int, R: int, B: int, sms: int) -> ChunkPlan:
    """``chunk_plan`` of a paged call over ``slots`` slots of R rows (tiles
    of 32 queries)."""
    return chunk_plan(paged_chunks(slots, R, _UPC), paged_chunks(slots, R, 1), B, sms, _CQ)


# the plain versions are the oracles themselves
topk_score_plain = ref.topk_score_ref
topk_score_paged_plain = ref.topk_score_paged_ref


@functools.lru_cache(maxsize=4096)
def _plan(fn: str, *args) -> tuple[int, bool]:
    """(scratch words, takes the radix select) from a C plan entry."""
    lib = _build.load("topk_score", _SIGNATURES)
    out = (ctypes.c_int64 * 2)()
    _build.check(getattr(lib, fn)(*args, out), fn)
    return int(out[0]), bool(out[1])


def _sms() -> int:
    return _build.sm_count(torch.device("cuda"))


def topk_plan(n: int, k: int, B: int, sms: int | None = None) -> tuple[int, bool]:
    """(8-byte words of scratch, takes the radix select) of a dense call,
    planned for a card of ``sms`` SMs (default: the current device's)."""
    sms = _sms() if sms is None else sms
    plan = dense_plan(n, B, sms)
    return _plan("topk_plan", n, k, B, plan.upc, select_groups(B, plan, k, sms))


def _group(B: int, words_of) -> int:
    """Queries per C call: a multiple of the 32-query tile whose scratch
    fits SCRATCH_BYTES, at most MAX_GROUP, or all of B. Each query's top-k
    is independent of the others, so grouping changes no result."""
    g = 32 * max(1, SCRATCH_BYTES // (8 * words_of(min(B, 32))))
    return min(B, g, MAX_GROUP)


def _listed(scratch: torch.Tensor, base: int, B: int, plan: ChunkPlan, ldq: int, extra: int):
    """What a list-mode call of B queries listed, read from its scratch
    (from word ``base``): the (B,) int64 counts a query, and a function that
    packs the listed keys into (B, max count) CUDA-order keys, each query's
    at the front and 0 past its count. The segments are the plan's
    (``ChunkPlan.segments``: one per item of a query tile), then the carry's
    ``extra`` keys. ``pack`` reads the scratch when called, so before the
    call's next group of queries overwrites it."""
    S = plan.segs
    keys = scratch[base:base + B * ldq].view(B, ldq)
    per = scratch[base + B * ldq:].view(torch.int32)[:B * S].view(B, S).clamp_min(0).tolist()
    starts = [st for st, _ in plan.segments()]
    tail = plan.chunks * plan.rows
    counts = torch.tensor([sum(c) + extra for c in per], dtype=torch.int64)

    def pack() -> torch.Tensor:
        out = torch.zeros((B, max(1, int(counts.max()))), dtype=torch.int64,
                          device=scratch.device)
        for b in range(B):
            row = torch.cat([keys[b, st:st + c] for st, c in zip(starts, per[b])]
                            + [keys[b, tail:tail + extra]])
            out[b, :row.numel()] = row
        return out

    return counts, pack


def _call_groups(B: int, words_of, call, device: torch.device) -> int:
    """Run ``call(g0, g1, scratch)`` over groups of queries sharing one
    scratch tensor (sized for the largest group and the last, whose plans
    may differ); returns the CUDA launches the C side reported."""
    G = _group(B, words_of)
    last = B - (B - 1) // G * G
    words = words_of(G) if last == G else max(words_of(G), words_of(last))
    scratch = torch.empty(words, dtype=torch.int64, device=device)
    launched = 0
    for g0 in range(0, B, G):
        launched += call(g0, min(B, g0 + G), scratch)
    return launched


def topk_score_cuda(D: torch.Tensor, Q: torch.Tensor, *, k: int,
                    n_valid: int | torch.Tensor | None = None,
                    row_ids: torch.Tensor | None = None, on_lists=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k on the card; arguments as ``topk_score_plain``.

    D: (n, m) f32, bf16 or int8 (an int8 scale must already be folded into
    Q); Q: (B, m) f32; row_ids: (n,) int32; n_valid: a host int, or a 0-d
    int32 tensor on D's device that the chunk kernel reads and clamps to
    [0, n] itself, so the host never reads it and a CUDA graph captured
    once replays at any live count. A group of queries launches the chunk
    kernel once, then for k <= 32 the merge kernel once per level, else
    the select's kernels. ``launches`` counts calls and ``cuda_launches``
    the CUDA launches the C side reports, both keyed by mode: the storage
    dtype in plain mode (``<dtype>_n_valid`` when ``n_valid`` masks rows,
    as a live delta segment's search does: always for a tensor count, since
    the host cannot tell whether it is below n without reading it), else
    ``"row_ids"``; ``unit_launches`` counts, by mode, the C calls whose
    plan ran the unit kernel (few rows), and ``narrow_launches``, as
    ``qn1`` / ``qn8``, those whose chunk kernel ran a 1- or 8-query tile; a
    call with k > 32 also counts in ``topk_select_cuda.launches`` under its
    mode, and each C call whose select took two levels in
    ``topk_select_cuda.two_level_launches``. ``on_lists(g0, counts,
    pack)``, a measurement aid, is called for k > 32 after each group of
    queries from g0 with what the list mode listed (``_listed``); it reads
    the scratch back on the host.
    """
    nv_dev = n_valid if isinstance(n_valid, torch.Tensor) else None
    tensors = [D, Q] + ([] if row_ids is None else [row_ids])
    tensors += [] if nv_dev is None else [nv_dev]
    if D.device.type != "cuda" or any(t.device != D.device for t in tensors):
        raise ValueError(f"topk_score_cuda needs all operands on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if D.dim() != 2 or D.dtype not in _DTYPES or not D.is_contiguous():
        raise ValueError(f"topk_score: D must be a contiguous 2-D "
                         f"f32/bf16/int8 tensor, got {tuple(D.shape)} {D.dtype}")
    n, m = D.shape
    if (Q.dim() != 2 or Q.dtype != torch.float32 or not Q.is_contiguous()
            or Q.shape[1] != m):
        raise ValueError(f"topk_score: Q must be a contiguous (B, {m}) f32 "
                         f"tensor, got {tuple(Q.shape)} {Q.dtype}")
    if row_ids is not None and (row_ids.dtype != torch.int32
                                or tuple(row_ids.shape) != (n,)
                                or not row_ids.is_contiguous()):
        raise ValueError(f"topk_score: row_ids must be a contiguous ({n},) "
                         f"int32 tensor, got {tuple(row_ids.shape)} "
                         f"{row_ids.dtype}")
    if nv_dev is not None and (nv_dev.dtype != torch.int32 or nv_dev.dim() != 0):
        raise ValueError(f"topk_score: a tensor n_valid must be a 0-d int32 tensor, "
                         f"got {tuple(nv_dev.shape)} {nv_dev.dtype}")
    B = Q.shape[0]
    if k < 1 or n < 1 or m < 1 or B < 1:
        raise ValueError(f"topk_score: needs k, n, m, B >= 1, "
                         f"got k={k} n={n} m={m} B={B}")
    lib = _build.load("topk_score", _SIGNATURES)
    dev = D.device
    select = k > _SMALL_K
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    nv = n if n_valid is None or nv_dev is not None else max(0, min(int(n_valid), n))
    mode = ("row_ids" if row_ids is not None
            else _STORE[D.dtype] + ("_n_valid" if nv < n or nv_dev is not None else ""))
    vec = m % 16 == 0 and D.data_ptr() % 16 == 0
    stream = _build.raw_stream(dev)
    sms = _build.sm_count(dev)
    q_ptr, s_ptr, i_ptr = Q.data_ptr(), out_s.data_ptr(), out_i.data_ptr()
    units = 0

    def call(g0, g1, scratch):
        nonlocal units
        b = g1 - g0
        plan = dense_plan(n, b, sms)
        groups = select_groups(b, plan, k, sms)
        launched = ctypes.c_int(0)
        err = lib.topk_score_f32(
            D.data_ptr(), q_ptr + 4 * g0 * m,
            None if row_ids is None else row_ids.data_ptr(), n, m, b, nv,
            None if nv_dev is None else nv_dev.data_ptr(), k,
            _DTYPES[D.dtype], int(vec), scratch.data_ptr(), s_ptr + 4 * g0 * k,
            i_ptr + 4 * g0 * k, stream, ctypes.byref(launched), plan.upc, plan.segs, plan.ctas,
            plan.qn, groups)
        _build.check(err, "topk_score")
        units += plan.upc == 1
        if plan.upc == _UPC and plan.qn != _CQ:
            topk_score_cuda.narrow_launches[f"qn{plan.qn}"] += 1
        if groups:
            topk_select_cuda.two_level_launches[mode] += 1
        if on_lists is not None and select:
            on_lists(g0, *_listed(scratch, 0, b, plan, plan.chunks * plan.rows, 0))
        return launched.value

    with _build.on_device(dev):
        launched = _call_groups(B, lambda b: topk_plan(n, k, b, sms)[0], call, dev)
    topk_score_cuda.launches[mode] += 1
    topk_score_cuda.cuda_launches[mode] += launched
    topk_score_cuda.unit_launches[mode] += units
    if select:
        topk_select_cuda.launches[mode] += 1
    return out_s, out_i


_DENSE_MODES = ("f32", "bf16", "int8", "f32_n_valid", "bf16_n_valid", "int8_n_valid",
                "row_ids")
topk_score_cuda.launches = dict.fromkeys(_DENSE_MODES, 0)
topk_score_cuda.cuda_launches = dict.fromkeys(_DENSE_MODES, 0)
topk_score_cuda.unit_launches = dict.fromkeys(_DENSE_MODES, 0)
topk_score_cuda.narrow_launches = {"qn1": 0, "qn8": 0}


def topk_paged_plan(slots: int, page_rows: int, k: int, carry: bool, B: int,
                    device_range: bool = False, sms: int | None = None) -> tuple[int, bool]:
    """(8-byte words of scratch, takes the radix select) of a paged call
    over ``slots`` slots (``device_range``: a range within them that the
    kernels read on the device), planned for a card of ``sms`` SMs."""
    plan = paged_plan(slots, page_rows, B, _sms() if sms is None else sms)
    return _plan("topk_paged_plan", slots, page_rows, k, int(carry), int(device_range), B,
                 plan.upc)


def _int32_vector(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
        raise ValueError(f"topk_score_paged: {name} must be a contiguous int32 "
                         f"vector of at least {n} entries, got {tuple(t.shape)} {t.dtype}")


def topk_score_paged_cuda(pool: torch.Tensor, page_table: torch.Tensor,
                          page_nvalid: torch.Tensor, page_offset: torch.Tensor,
                          lo: int | torch.Tensor, hi: int | torch.Tensor, Q: torch.Tensor, *,
                          k: int,
                          tail: torch.Tensor | None = None,
                          page_scale: torch.Tensor | None = None,
                          ids_pool: torch.Tensor | None = None,
                          carry: tuple[torch.Tensor, torch.Tensor] | None = None,
                          finalize: bool = True, on_lists=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paged score + top-k on the card; arguments as
    ``topk_score_paged_plain``.

    pool (P, R, m) and tail (T, R, m) f32, bf16 or int8 of one dtype;
    page_table, page_nvalid, page_offset (>= hi,) int32; page_scale
    (>= hi, m) f32; ids_pool (>= hi, R) int32; Q (B, m) f32; carry (B, k)
    f32 and int32. ``lo`` and ``hi`` are host ints with 0 <= lo and hi <=
    the table's length, or both 0-d int32 tensors on the pool's device
    (anything else raises ``ValueError``). Host ints plan the walk by hi -
    lo. Tensors are never read by the host: the call is planned for the
    table's capacity, ``page_table.shape[0]`` (the scratch of the k > 32
    path grows with it), the kernels read the bounds once a block and
    clamp them to [0, capacity], and the chunk kernel walks the chunks
    that cover the range and lists the rest as pads. So the call does not
    synchronize, and a CUDA graph captured once replays bitwise as pages
    are written into preallocated tables and ``hi`` grows in place; the
    metadata tensors then need the capacity's entries. ``launches`` counts
    calls and ``cuda_launches`` the CUDA launches the C side reports, keyed
    by mode: ``paged_<storage dtype>``, or ``paged_ids`` with ``ids_pool``;
    ``_dev`` ends the mode of a call with tensor bounds; ``unit_launches``
    and ``on_lists`` as for ``topk_score_cuda``.
    """
    dev_range = ref.paged_bounds(lo, hi, pool.device)
    cap = page_table.shape[0]
    if not dev_range:
        lo, hi = int(lo), int(hi)
    tensors = [pool, page_table, page_nvalid, page_offset, Q]
    tensors += [t for t in (tail, page_scale, ids_pool) if t is not None]
    if carry is not None:
        tensors += list(carry)
    if pool.device.type != "cuda" or any(t.device != pool.device for t in tensors):
        raise ValueError(f"topk_score_paged_cuda needs all operands on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if pool.dim() != 3 or pool.dtype not in _DTYPES or not pool.is_contiguous():
        raise ValueError(f"topk_score_paged: pool must be a contiguous (P, R, m) "
                         f"f32/bf16/int8 tensor, got {tuple(pool.shape)} {pool.dtype}")
    P, R, m = pool.shape
    if tail is not None and (tail.dtype != pool.dtype or tail.dim() != 3
                             or tuple(tail.shape[1:]) != (R, m)
                             or not tail.is_contiguous()):
        raise ValueError(f"topk_score_paged: tail must be a contiguous (T, {R}, {m}) "
                         f"{pool.dtype} tensor, got {tuple(tail.shape)} {tail.dtype}")
    if (Q.dim() != 2 or Q.dtype != torch.float32 or not Q.is_contiguous()
            or Q.shape[1] != m):
        raise ValueError(f"topk_score_paged: Q must be a contiguous (B, {m}) f32 "
                         f"tensor, got {tuple(Q.shape)} {Q.dtype}")
    B = Q.shape[0]
    if k < 1:
        raise ValueError(f"topk_score_paged: needs k >= 1, got k={k}")
    if B < 1 or (not dev_range and (lo < 0 or hi > cap)):
        raise ValueError(f"topk_score_paged: needs B >= 1 and "
                         f"0 <= lo, hi <= {cap}, got B={B} "
                         f"lo={lo} hi={hi}")
    # the planned [plo, phi) and the table rows the kernels may read
    plo, phi = (0, cap) if dev_range else (lo, max(hi, lo))
    need = cap if dev_range else max(hi, 0)
    for name, t in (("page_table", page_table), ("page_nvalid", page_nvalid),
                    ("page_offset", page_offset)):
        _int32_vector(name, t, need)
    if page_scale is not None and (page_scale.dtype != torch.float32
                                   or page_scale.dim() != 2
                                   or page_scale.shape[0] < need
                                   or page_scale.shape[1] != m
                                   or not page_scale.is_contiguous()):
        raise ValueError(f"topk_score_paged: page_scale must be a contiguous "
                         f"(>= {need}, {m}) f32 tensor, got "
                         f"{tuple(page_scale.shape)} {page_scale.dtype}")
    if ids_pool is not None and (ids_pool.dtype != torch.int32 or ids_pool.dim() != 2
                                 or ids_pool.shape[0] < need or ids_pool.shape[1] != R
                                 or not ids_pool.is_contiguous()):
        raise ValueError(f"topk_score_paged: ids_pool must be a contiguous "
                         f"(>= {need}, {R}) int32 tensor, got "
                         f"{tuple(ids_pool.shape)} {ids_pool.dtype}")
    if carry is not None:
        cs, ci = carry
        if (cs.dtype != torch.float32 or ci.dtype != torch.int32
                or tuple(cs.shape) != (B, k) or tuple(ci.shape) != (B, k)
                or not cs.is_contiguous() or not ci.is_contiguous()):
            raise ValueError(f"topk_score_paged: carry must be contiguous ({B}, {k}) "
                             f"f32 scores and int32 ids")
    dev = pool.device
    if phi <= plo and carry is None:
        # an empty walk (with tensor bounds: an empty table): every slot is a pad
        j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)
        return (torch.full((B, k), float("-inf"), device=dev),
                torch.full((B, k), -1, dtype=torch.int32, device=dev)
                if finalize else (-(j + 2)).contiguous())
    lib = _build.load("topk_score", _SIGNATURES)
    slots = phi - plo
    select = k > _SMALL_K
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    vec = (m % 16 == 0 and pool.data_ptr() % 16 == 0
           and (tail is None or tail.data_ptr() % 16 == 0)
           and (page_scale is None or page_scale.data_ptr() % 16 == 0))
    stream = _build.raw_stream(dev)
    sms = _build.sm_count(dev)
    units = 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call(g0, g1, scratch):
        nonlocal units
        b = g1 - g0
        plan = paged_plan(slots, R, b, sms)
        launched = ctypes.c_int(0)
        err = lib.topk_score_paged_f32(
            pool.data_ptr(), ptr(tail), page_table.data_ptr(),
            page_nvalid.data_ptr(), page_offset.data_ptr(), ptr(page_scale),
            ptr(ids_pool), Q.data_ptr() + 4 * g0 * m,
            None if carry is None else carry[0].data_ptr() + 4 * g0 * k,
            None if carry is None else carry[1].data_ptr() + 4 * g0 * k, P,
            0 if tail is None else tail.shape[0], R, m, b, plo, phi,
            lo.data_ptr() if dev_range else None, hi.data_ptr() if dev_range else None, k,
            _DTYPES[pool.dtype], int(vec), int(finalize), scratch.data_ptr(),
            out_s.data_ptr() + 4 * g0 * k, out_i.data_ptr() + 4 * g0 * k, stream,
            ctypes.byref(launched), plan.upc, plan.segs, plan.ctas)
        _build.check(err, "topk_score_paged")
        units += plan.upc == 1 and plan.chunks > 0
        if on_lists is not None and select:
            extra = 0 if carry is None else k
            base = plan.chunks * plan.upc * _UNIT_WORDS + plan.chunks + int(dev_range)
            on_lists(g0, *_listed(scratch, base, b, plan, plan.chunks * plan.rows + extra,
                                  extra))
        return launched.value

    with _build.on_device(dev):
        launched = _call_groups(
            B, lambda b: topk_paged_plan(slots, R, k, carry is not None, b, dev_range, sms)[0],
            call, dev)
    mode = "paged_ids" if ids_pool is not None else f"paged_{_STORE[pool.dtype]}"
    mode += "_dev" if dev_range else ""
    topk_score_paged_cuda.launches[mode] += 1
    topk_score_paged_cuda.cuda_launches[mode] += launched
    topk_score_paged_cuda.unit_launches[mode] += units
    if select:
        topk_select_cuda.launches[mode] += 1
    return out_s, out_i


_PAGED_MODES = tuple(f"paged_{st}{how}" for how in ("", "_dev")
                     for st in ("f32", "bf16", "int8", "ids"))
topk_score_paged_cuda.launches = dict.fromkeys(_PAGED_MODES, 0)
topk_score_paged_cuda.cuda_launches = dict.fromkeys(_PAGED_MODES, 0)
topk_score_paged_cuda.unit_launches = dict.fromkeys(_PAGED_MODES, 0)


def topk_select_plain(keys: torch.Tensor, k: int, finalize: bool = True,
                      counts: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row of CUDA-order keys (B, L) int64, as scores and
    ids: the plain version of ``topk_select_cuda``. With ``counts`` (B,)
    only the first ``counts[b]`` keys of row b take part (clamped to [0,
    L]). Slots past the live keys, and keys whose score is -inf, are (-inf,
    -1); un-finalized, slot j after c finite slots gets id -(j - c + 2)."""
    B, L = keys.shape
    if counts is not None:
        live = torch.arange(L, device=keys.device)[None, :] < counts.to(keys.device)[:, None]
        keys = torch.where(live, keys, 0)          # key 0: below every key, a pad
    plain = keys ^ _SIGN                       # signed order = the CUDA unsigned order
    top = torch.topk(plain, min(k, L), dim=1).values
    if k > L:
        fill = ref._keys(torch.full((B, k - L), float("-inf"), device=keys.device),
                         torch.full((B, k - L), -1, dtype=torch.int32, device=keys.device))
        top = torch.cat([top, fill], 1)
    scores, ids = ref._unkeys(top)
    pad = torch.isneginf(scores) | torch.isnan(scores)
    scores = scores.masked_fill(pad, float("-inf"))
    if finalize:
        ids = torch.where(pad, -1, ids)
    else:
        c = (~pad).sum(1, keepdim=True)
        j = torch.arange(k, device=keys.device)[None, :]
        ids = torch.where(pad, -(j - c + 2), ids)
    return scores, ids.to(torch.int32)


def topk_select_cuda(keys: torch.Tensor, k: int, finalize: bool = True,
                     counts: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The large-k select alone on the card: the top k of each row of
    ``keys`` (B, L) int64 in the CUDA order (the plain ``ref._keys`` with
    the top bit flipped), by the fused or the multi-CTA select and write
    that ``topk_score_cuda`` runs for k > 32. ``counts``, a (B,) int32
    tensor on the card, keeps the first ``counts[b]`` keys of row b live
    (clamped by the kernels to [0, L]; the rest are not read), as the chunk
    kernel's segment counts do; the host never reads it. ``launches``
    counts select runs keyed by the caller's mode (``keys`` for direct
    calls); ``cuda_launches["keys"]`` the CUDA launches of direct calls."""
    if keys.device.type != "cuda":
        raise ValueError(f"topk_select_cuda needs a CUDA tensor, got {keys.device}")
    if keys.dim() != 2 or keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError(f"topk_select: keys must be a contiguous (B, L) int64 "
                         f"tensor, got {tuple(keys.shape)} {keys.dtype}")
    B, L = keys.shape
    if k < 1 or L < 1 or B < 1:
        raise ValueError(f"topk_select: needs k, L, B >= 1, got k={k} L={L} B={B}")
    if counts is not None and (counts.dtype != torch.int32 or tuple(counts.shape) != (B,)
                               or counts.device != keys.device
                               or not counts.is_contiguous()):
        raise ValueError(f"topk_select: counts must be a contiguous ({B},) int32 tensor "
                         f"on {keys.device}, got {tuple(counts.shape)} {counts.dtype} "
                         f"on {counts.device}")
    lib = _build.load("topk_score", _SIGNATURES)
    dev = keys.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(g0, g1, scratch):
        launched = ctypes.c_int(0)
        err = lib.topk_select_keys(keys[g0:g1].data_ptr(),
                                   None if counts is None else counts[g0:g1].data_ptr(),
                                   g1 - g0, L, k, int(finalize),
                                   scratch.data_ptr(), out_s[g0:g1].data_ptr(),
                                   out_i[g0:g1].data_ptr(), stream, ctypes.byref(launched))
        _build.check(err, "topk_select")
        return launched.value

    with torch.cuda.device(dev):
        launched = _call_groups(B, lambda b: _plan("topk_select_plan", L, k, b)[0],
                                call, dev)
    topk_select_cuda.launches["keys"] += 1
    topk_select_cuda.cuda_launches["keys"] += launched
    return out_s, out_i


topk_select_cuda.launches = dict.fromkeys((*_DENSE_MODES, *_PAGED_MODES, "keys"), 0)
topk_select_cuda.cuda_launches = {"keys": 0}
topk_select_cuda.two_level_launches = dict.fromkeys(_DENSE_MODES, 0)
