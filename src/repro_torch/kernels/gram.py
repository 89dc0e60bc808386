"""Gram matrix ``D^T D`` in fp32: the CUDA kernel and its plain version.

Replaces ``repro/kernels/gram.py::gram_pallas``. The kernel
(``csrc/gram.cu``) is bound by fp32 FMAs (192 FLOP per byte read at
d = 768). G is symmetric, so it computes only the 128 x 128 output tiles on
or above the diagonal, one set of CTAs per tile, and mirrors them. The rows
are split into ranges of at most 16,384 (at least about two CTAs per SM),
and a second pass sums the ranges' partial Grams in a fixed order: the
result is the same from run to run, and no fp32 sum chain is longer than
a range.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_SIGNATURES = {
    "gram_splits": (ctypes.c_int, [ctypes.c_int64, ctypes.c_int, ctypes.c_int]),
    "gram_f32": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the plain version is the oracle itself: same arithmetic, fp32 accumulate
gram_plain = ref.gram_ref


def gram_cuda(D: torch.Tensor) -> torch.Tensor:
    """``D^T D`` (d, d) f32 from an (n, d) f32 or bf16 CUDA tensor."""
    if D.device.type != "cuda":
        raise ValueError(f"gram_cuda needs a CUDA tensor, got {D.device}")
    if D.dim() != 2 or D.dtype not in _DTYPES or not D.is_contiguous():
        raise ValueError(f"gram_cuda takes a contiguous 2-D f32/bf16 tensor, "
                         f"got {tuple(D.shape)} {D.dtype} "
                         f"contiguous={D.is_contiguous()}")
    n, d = D.shape
    if n < 1 or d < 1:
        raise ValueError(f"gram_cuda needs n, d >= 1, got {tuple(D.shape)}")
    lib = _build.load("gram", _SIGNATURES)
    sms = torch.cuda.get_device_properties(D.device).multi_processor_count
    splits = lib.gram_splits(n, d, sms)
    out = torch.empty((d, d), dtype=torch.float32, device=D.device)
    partial = (torch.empty((splits, d, d), dtype=torch.float32, device=D.device)
               if splits > 1 else out)
    with torch.cuda.device(D.device):
        err = lib.gram_f32(D.data_ptr(), n, d, _DTYPES[D.dtype], splits,
                           partial.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gram")
    gram_cuda.launches += 1
    return out


gram_cuda.launches = 0
