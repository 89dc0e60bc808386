"""Exact top-k of ``Q @ D^T``: the CUDA kernel and its plain version.

Replaces ``repro/kernels/topk_score.py::topk_score_pallas`` in both of its
modes: plain (ids are row positions, rows with id >= ``n_valid`` are
masked) and ``row_ids`` rescore (row j reports ``row_ids[j]``, negative ids
are masked). Outputs are (B, k) f32 scores sorted descending and (B, k)
int32 ids; ties go to the lowest id; slots with no candidate are
(-inf, -1).

The kernel (``csrc/topk_score.cu``) splits n over CTAs, since at serving
batch sizes one CTA per query tile would leave most of the card idle: each
CTA scores a 512-row chunk for 32 queries and keeps the chunk's top k, and
a merge kernel reduces the per-chunk lists, launched until one list is
left. Candidates are compared as (score desc, id asc) keys, so the result
does not depend on visit order. k is capped at ``K_CAP``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

K_CAP = 1024   # largest k the merge's shared-memory sort takes
_SIGNATURES = {
    "topk_plan": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int64)]),
    "topk_score_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STORE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


# the plain version is the oracle itself
topk_score_plain = ref.topk_score_ref


def topk_plan(n: int, k: int) -> tuple[int, int, int]:
    """(chunks, lists merged per warp, lists after the first merge)."""
    lib = _build.load("topk_score", _SIGNATURES)
    out = (ctypes.c_int64 * 3)()
    _build.check(lib.topk_plan(n, k, out), "topk_plan")
    return int(out[0]), int(out[1]), int(out[2])


def topk_score_cuda(D: torch.Tensor, Q: torch.Tensor, *, k: int,
                    n_valid: int | None = None,
                    row_ids: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k on the card; arguments as ``topk_score_plain``.

    D: (n, m) f32, bf16 or int8 (an int8 scale must already be folded into
    Q); Q: (B, m) f32; row_ids: (n,) int32. Each call launches the chunk
    kernel once and the merge kernel once per level. ``launches`` counts
    calls and ``cuda_launches`` the CUDA launches the C side reports, both
    keyed by mode: the storage dtype in plain mode, else ``"row_ids"``.
    """
    tensors = [D, Q] + ([] if row_ids is None else [row_ids])
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
    B = Q.shape[0]
    if not 1 <= k <= K_CAP:
        raise ValueError(f"topk_score: k = {k} is outside the kernel's range "
                         f"1..{K_CAP}")
    if n < 1 or m < 1 or not 1 <= B <= 65535:
        raise ValueError(f"topk_score: needs n, m >= 1 and 1 <= B <= 65535, "
                         f"got n={n} m={m} B={B}")
    lib = _build.load("topk_score", _SIGNATURES)
    chunks, _, lists1 = topk_plan(n, k)
    scratch_a = torch.empty(B * chunks * k, dtype=torch.int64, device=D.device)
    scratch_b = torch.empty(B * lists1 * k, dtype=torch.int64, device=D.device)
    out_s = torch.empty((B, k), dtype=torch.float32, device=D.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=D.device)
    nv = n if n_valid is None else max(0, min(int(n_valid), n))
    vec = m % 16 == 0 and D.data_ptr() % 16 == 0
    launched = ctypes.c_int(0)
    with torch.cuda.device(D.device):
        err = lib.topk_score_f32(
            D.data_ptr(), Q.data_ptr(),
            None if row_ids is None else row_ids.data_ptr(), n, m, B, nv, k,
            _DTYPES[D.dtype], int(vec), scratch_a.data_ptr(),
            scratch_b.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    _build.check(err, "topk_score")
    mode = "row_ids" if row_ids is not None else _STORE[D.dtype]
    topk_score_cuda.launches[mode] += 1
    topk_score_cuda.cuda_launches[mode] += launched.value
    return out_s, out_i


topk_score_cuda.launches = dict.fromkeys(("f32", "bf16", "int8", "row_ids"), 0)
topk_score_cuda.cuda_launches = dict.fromkeys(("f32", "bf16", "int8", "row_ids"), 0)
