"""Gram matrix ``D^T D`` in fp32: the CUDA kernel and its plain version.

Replaces ``repro/kernels/gram.py::gram_pallas``. The kernel
(``csrc/gram.cu``) is bound by fp32 FMAs (192 FLOP per byte read at
d = 768). G is symmetric, so it computes only the 128 x 128 output tiles on
or above the diagonal, one set of CTAs per tile, each a cp.async-pipelined
mainloop over 16-row slabs. The rows are split into ranges of at most
16,384 (at least about two CTAs per SM), and a second pass sums the
ranges' partial Grams in a fixed order and mirrors the upper tiles: the
result is the same from run to run, exactly symmetric, and no fp32 sum
chain is longer than a range. ``_ranges`` and ``_launch`` expose that
decomposition to the tests: G is bitwise the in-order sum of one-range
launches over each range's rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_SIGNATURES = {
    "gram_splits": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int]),
    "gram_range_rows": (ctypes.c_int64, [ctypes.c_int64, ctypes.c_int]),
    "gram_f32": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int)]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the plain version is the oracle itself: same arithmetic, fp32 accumulate
gram_plain = ref.gram_ref


def gram_cuda(D: torch.Tensor) -> torch.Tensor:
    """``D^T D`` (d, d) f32 from an (n, d) f32 or bf16 CUDA tensor.
    ``launches`` counts calls, ``cuda_launches`` the CUDA launches the C
    side reports (one with one row range, else two)."""
    _check(D)
    return _launch(D, _splits(D))


def _check(D: torch.Tensor) -> None:
    if D.device.type != "cuda":
        raise ValueError(f"gram_cuda needs a CUDA tensor, got {D.device}")
    if D.dim() != 2 or D.dtype not in _DTYPES or not D.is_contiguous():
        raise ValueError(f"gram_cuda takes a contiguous 2-D f32/bf16 tensor, "
                         f"got {tuple(D.shape)} {D.dtype} "
                         f"contiguous={D.is_contiguous()}")
    if D.shape[0] < 1 or D.shape[1] < 1:
        raise ValueError(f"gram_cuda needs n, d >= 1, got {tuple(D.shape)}")


def _splits(D: torch.Tensor) -> int:
    """How many row ranges ``gram_cuda`` splits D into on its card."""
    n, d = D.shape
    sms = torch.cuda.get_device_properties(D.device).multi_processor_count
    return _build.load("gram", _SIGNATURES).gram_splits(n, d, sms)


def _ranges(D: torch.Tensor) -> list[tuple[int, int]]:
    """The non-empty row ranges ``gram_cuda`` splits D into, in order."""
    _check(D)
    n, splits = D.shape[0], _splits(D)
    r = _build.load("gram", _SIGNATURES).gram_range_rows(n, splits)
    return [(p * r, min((p + 1) * r, n)) for p in range(splits) if p * r < n]


def _launch(D: torch.Tensor, splits: int) -> torch.Tensor:
    """The kernel over D's rows split ``splits`` ways (1: one range); D
    as ``_check`` takes it."""
    n, d = D.shape
    lib = _build.load("gram", _SIGNATURES)
    out = torch.empty((d, d), dtype=torch.float32, device=D.device)
    partial = (torch.empty((splits, d, d), dtype=torch.float32, device=D.device)
               if splits > 1 else out)
    launched = ctypes.c_int(0)
    with torch.cuda.device(D.device):
        err = lib.gram_f32(D.data_ptr(), n, d, _DTYPES[D.dtype], splits,
                           partial.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream,
                           ctypes.byref(launched))
    _build.check(err, "gram")
    gram_cuda.launches += 1
    gram_cuda.cuda_launches += launched.value
    return out


gram_cuda.launches = 0
gram_cuda.cuda_launches = 0
