"""Exact top-k of ``Q @ D^T``: the CUDA kernels and their plain versions.

Replaces ``repro/kernels/topk_score.py::topk_score_pallas`` in both of its
modes: plain (ids are row positions, rows with id >= ``n_valid`` are
masked) and ``row_ids`` rescore (row j reports ``row_ids[j]``, negative ids
are masked). Outputs are (B, k) f32 scores sorted descending and (B, k)
int32 ids; ties go to the lowest id; slots with no candidate are
(-inf, -1). Any k >= 1 runs.

The kernels (``csrc/topk_score.cu``) split n over CTAs, since at serving
batch sizes one CTA per query tile would leave most of the card idle: one
persistent CTA per SM walks 512-row chunks for 32 queries. For k <= 32 it
keeps each chunk's top k against a running threshold and a merge kernel
reduces the per-chunk lists; for larger k it lists every row's key and a
radix select, a gather and a bitonic sort take the top k. Candidates are
compared as (score desc, id asc) keys, so the result does not depend on
visit order. Above k = 32 the scratch is one 8-byte key per row and query,
so a call walks its queries in groups whose scratch fits
``SCRATCH_BYTES`` (at least one 32-query tile a group). A group also holds
at most ``MAX_GROUP`` queries, since one launch of the merge and select
kernels takes at most 65,535: so every wrapper takes any B.

``topk_score_paged_cuda`` replaces ``topk_score_paged_pallas``: the same
top-k over logical slots [lo, hi) of a page table (pool and tail tiers,
per-page scale, ``page_nvalid`` masks and ``page_offset`` ids, the
``ids_pool`` rescore mode, ``carry`` / ``finalize`` chaining), through the
same chunk kernel with a paged row source and the same select; the carry
is one more list (k <= 32) or k more keys.

``topk_select_cuda`` is the large-k select alone, over rows of keys as the
chunk kernel lists them; ``topk_select_plain`` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

SCRATCH_BYTES = 4 << 30    # scratch of one C call, above which queries are grouped
# queries of one C call: the merge and select kernels put one query on each
# gridDim.y (at most 65,535), so a call takes the largest multiple of the
# 32-query tile below that
MAX_GROUP = 65504
_P = ctypes.c_void_p
_SIGNATURES = {
    "topk_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int64)]),
    "topk_score_f32": (ctypes.c_int, [
        _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
        ctypes.POINTER(ctypes.c_int)]),
    "topk_paged_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int64)]),
    "topk_score_paged_f32": (ctypes.c_int, [_P] * 10 + [ctypes.c_int] * 11
                             + [_P] * 4 + [ctypes.POINTER(ctypes.c_int)]),
    "topk_select_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int64)]),
    "topk_select_keys": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, _P, _P, _P, _P,
                                        ctypes.POINTER(ctypes.c_int)]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_SIGN = -(1 << 63)         # the CUDA keys are the plain keys with the top bit flipped


# the plain versions are the oracles themselves
topk_score_plain = ref.topk_score_ref
topk_score_paged_plain = ref.topk_score_paged_ref


def _plan(fn: str, *args) -> tuple[int, bool]:
    """(scratch words, takes the radix select) from a C plan entry."""
    lib = _build.load("topk_score", _SIGNATURES)
    out = (ctypes.c_int64 * 2)()
    _build.check(getattr(lib, fn)(*args, out), fn)
    return int(out[0]), bool(out[1])


def topk_plan(n: int, k: int, B: int) -> tuple[int, bool]:
    """(8-byte words of scratch, takes the radix select) of a dense call."""
    return _plan("topk_plan", n, k, B)


def _group(B: int, words_of) -> int:
    """Queries per C call: a multiple of the 32-query tile whose scratch
    fits SCRATCH_BYTES, at most MAX_GROUP, or all of B. Each query's top-k
    is independent of the others, so grouping changes no result."""
    g = 32 * max(1, SCRATCH_BYTES // (8 * words_of(min(B, 32))))
    return min(B, g, MAX_GROUP)


def _call_groups(B: int, words_of, call, device: torch.device) -> int:
    """Run ``call(g0, g1, scratch)`` over groups of queries sharing one
    scratch tensor; returns the CUDA launches the C side reported."""
    G = _group(B, words_of)
    scratch = torch.empty(words_of(G), dtype=torch.int64, device=device)
    launched = 0
    for g0 in range(0, B, G):
        launched += call(g0, min(B, g0 + G), scratch)
    return launched


def topk_score_cuda(D: torch.Tensor, Q: torch.Tensor, *, k: int,
                    n_valid: int | torch.Tensor | None = None,
                    row_ids: torch.Tensor | None = None
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
    ``"row_ids"``; a call with k > 32 also counts in
    ``topk_select_cuda.launches`` under its mode.
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
    select = topk_plan(n, k, B)[1]
    out_s = torch.empty((B, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=D.device)
    nv = n if n_valid is None or nv_dev is not None else max(0, min(int(n_valid), n))
    vec = m % 16 == 0 and D.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(D.device).cuda_stream

    def call(g0, g1, scratch):
        launched = ctypes.c_int(0)
        err = lib.topk_score_f32(
            D.data_ptr(), Q[g0:g1].data_ptr(),
            None if row_ids is None else row_ids.data_ptr(), n, m, g1 - g0, nv,
            None if nv_dev is None else nv_dev.data_ptr(), k,
            _DTYPES[D.dtype], int(vec), scratch.data_ptr(), out_s[g0:g1].data_ptr(),
            out_i[g0:g1].data_ptr(), stream, ctypes.byref(launched))
        _build.check(err, "topk_score")
        return launched.value

    with torch.cuda.device(D.device):
        launched = _call_groups(B, lambda b: topk_plan(n, k, b)[0], call, D.device)
    mode = ("row_ids" if row_ids is not None
            else _STORE[D.dtype] + ("_n_valid" if nv < n or nv_dev is not None else ""))
    topk_score_cuda.launches[mode] += 1
    topk_score_cuda.cuda_launches[mode] += launched
    if select:
        topk_select_cuda.launches[mode] += 1
    return out_s, out_i


_DENSE_MODES = ("f32", "bf16", "int8", "f32_n_valid", "bf16_n_valid", "int8_n_valid",
                "row_ids")
topk_score_cuda.launches = dict.fromkeys(_DENSE_MODES, 0)
topk_score_cuda.cuda_launches = dict.fromkeys(_DENSE_MODES, 0)


def topk_paged_plan(slots: int, page_rows: int, k: int, carry: bool, B: int
                    ) -> tuple[int, bool]:
    """(8-byte words of scratch, takes the radix select) of a paged call."""
    return _plan("topk_paged_plan", slots, page_rows, k, int(carry), B)


def _int32_vector(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] < n or not t.is_contiguous():
        raise ValueError(f"topk_score_paged: {name} must be a contiguous int32 "
                         f"vector of at least {n} entries, got {tuple(t.shape)} {t.dtype}")


def topk_score_paged_cuda(pool: torch.Tensor, page_table: torch.Tensor,
                          page_nvalid: torch.Tensor, page_offset: torch.Tensor,
                          lo: int, hi: int, Q: torch.Tensor, *, k: int,
                          tail: torch.Tensor | None = None,
                          page_scale: torch.Tensor | None = None,
                          ids_pool: torch.Tensor | None = None,
                          carry: tuple[torch.Tensor, torch.Tensor] | None = None,
                          finalize: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paged score + top-k on the card; arguments as
    ``topk_score_paged_plain``.

    pool (P, R, m) and tail (T, R, m) f32, bf16 or int8 of one dtype;
    page_table, page_nvalid, page_offset (>= hi,) int32; page_scale
    (>= hi, m) f32; ids_pool (>= hi, R) int32; Q (B, m) f32; carry (B, k)
    f32 and int32. ``lo`` and ``hi`` are host ints. ``launches`` counts
    calls and ``cuda_launches`` the CUDA launches the C side reports, keyed
    by mode: ``paged_<storage dtype>``, or ``paged_ids`` with ``ids_pool``.
    """
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
    if B < 1 or lo < 0 or hi > page_table.shape[0]:
        raise ValueError(f"topk_score_paged: needs B >= 1 and "
                         f"0 <= lo, hi <= {page_table.shape[0]}, got B={B} "
                         f"lo={lo} hi={hi}")
    for name, t in (("page_table", page_table), ("page_nvalid", page_nvalid),
                    ("page_offset", page_offset)):
        _int32_vector(name, t, max(hi, 0))
    if page_scale is not None and (page_scale.dtype != torch.float32
                                   or page_scale.dim() != 2
                                   or page_scale.shape[0] < hi
                                   or page_scale.shape[1] != m
                                   or not page_scale.is_contiguous()):
        raise ValueError(f"topk_score_paged: page_scale must be a contiguous "
                         f"(>= {hi}, {m}) f32 tensor, got "
                         f"{tuple(page_scale.shape)} {page_scale.dtype}")
    if ids_pool is not None and (ids_pool.dtype != torch.int32 or ids_pool.dim() != 2
                                 or ids_pool.shape[0] < hi or ids_pool.shape[1] != R
                                 or not ids_pool.is_contiguous()):
        raise ValueError(f"topk_score_paged: ids_pool must be a contiguous "
                         f"(>= {hi}, {R}) int32 tensor, got "
                         f"{tuple(ids_pool.shape)} {ids_pool.dtype}")
    if carry is not None:
        cs, ci = carry
        if (cs.dtype != torch.float32 or ci.dtype != torch.int32
                or tuple(cs.shape) != (B, k) or tuple(ci.shape) != (B, k)
                or not cs.is_contiguous() or not ci.is_contiguous()):
            raise ValueError(f"topk_score_paged: carry must be contiguous ({B}, {k}) "
                             f"f32 scores and int32 ids")
    dev = pool.device
    if hi <= lo and carry is None:
        # an empty walk: every slot is a pad
        j = torch.arange(k, dtype=torch.int32, device=dev).expand(B, k)
        return (torch.full((B, k), float("-inf"), device=dev),
                torch.full((B, k), -1, dtype=torch.int32, device=dev)
                if finalize else (-(j + 2)).contiguous())
    lib = _build.load("topk_score", _SIGNATURES)
    slots = max(hi - lo, 0)
    select = topk_paged_plan(slots, R, k, carry is not None, B)[1]
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    vec = (m % 16 == 0 and pool.data_ptr() % 16 == 0
           and (tail is None or tail.data_ptr() % 16 == 0)
           and (page_scale is None or page_scale.data_ptr() % 16 == 0))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call(g0, g1, scratch):
        launched = ctypes.c_int(0)
        err = lib.topk_score_paged_f32(
            pool.data_ptr(), ptr(tail), page_table.data_ptr(),
            page_nvalid.data_ptr(), page_offset.data_ptr(), ptr(page_scale),
            ptr(ids_pool), Q[g0:g1].data_ptr(),
            None if carry is None else carry[0][g0:g1].data_ptr(),
            None if carry is None else carry[1][g0:g1].data_ptr(), P,
            0 if tail is None else tail.shape[0], R, m, g1 - g0, lo, max(hi, lo), k,
            _DTYPES[pool.dtype], int(vec), int(finalize), scratch.data_ptr(),
            out_s[g0:g1].data_ptr(), out_i[g0:g1].data_ptr(), stream,
            ctypes.byref(launched))
        _build.check(err, "topk_score_paged")
        return launched.value

    with torch.cuda.device(dev):
        launched = _call_groups(
            B, lambda b: topk_paged_plan(slots, R, k, carry is not None, b)[0], call, dev)
    mode = "paged_ids" if ids_pool is not None else f"paged_{_STORE[pool.dtype]}"
    topk_score_paged_cuda.launches[mode] += 1
    topk_score_paged_cuda.cuda_launches[mode] += launched
    if select:
        topk_select_cuda.launches[mode] += 1
    return out_s, out_i


_PAGED_MODES = ("paged_f32", "paged_bf16", "paged_int8", "paged_ids")
topk_score_paged_cuda.launches = dict.fromkeys(_PAGED_MODES, 0)
topk_score_paged_cuda.cuda_launches = dict.fromkeys(_PAGED_MODES, 0)


def topk_select_plain(keys: torch.Tensor, k: int, finalize: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of each row of CUDA-order keys (B, L) int64, as scores and
    ids: the plain version of ``topk_select_cuda``. Slots past L, and keys
    whose score is -inf, are (-inf, -1); un-finalized, slot j after c
    finite slots gets id -(j - c + 2)."""
    B, L = keys.shape
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


def topk_select_cuda(keys: torch.Tensor, k: int, finalize: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The large-k select alone on the card: the top k of each row of
    ``keys`` (B, L) int64 in the CUDA order (the plain ``ref._keys`` with
    the top bit flipped), by the radix select, gather, sort and write that
    ``topk_score_cuda`` runs for k > 32. ``launches`` counts select runs
    keyed by the caller's mode (``keys`` for direct calls);
    ``cuda_launches["keys"]`` the CUDA launches of direct calls."""
    if keys.device.type != "cuda":
        raise ValueError(f"topk_select_cuda needs a CUDA tensor, got {keys.device}")
    if keys.dim() != 2 or keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError(f"topk_select: keys must be a contiguous (B, L) int64 "
                         f"tensor, got {tuple(keys.shape)} {keys.dtype}")
    B, L = keys.shape
    if k < 1 or L < 1 or B < 1:
        raise ValueError(f"topk_select: needs k, L, B >= 1, got k={k} L={L} B={B}")
    lib = _build.load("topk_score", _SIGNATURES)
    dev = keys.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(g0, g1, scratch):
        launched = ctypes.c_int(0)
        err = lib.topk_select_keys(keys[g0:g1].data_ptr(), g1 - g0, L, k, int(finalize),
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
