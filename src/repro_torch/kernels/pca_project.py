"""PCA projection ``D @ W_m``, plain and with a fused int8 epilogue: the CUDA
kernels and their plain versions.

Replaces ``repro/kernels/pca_project.py::pca_project_pallas`` and
``::pca_project_quant_pallas``. The kernel (``csrc/pca_project.cu``) is
bound by fp32 FMAs (about 256 FLOP per byte at d = 768, m = 384). It splits
the (n, m) output over CTAs by 128 x 128 tile and loops over d inside the
CTA; the quant epilogue multiplies by ``1 / max(scale, 1e-12)`` exactly as
the TPU kernel does, so no f32 index reaches device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_SIGNATURES = {
    "pca_project_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the plain version is the oracle itself: same arithmetic, fp32 accumulate
pca_project_plain = ref.pca_project_ref


def pca_project_quant_plain(D: torch.Tensor, W: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """The fused epilogue's arithmetic: multiply by the reciprocal scale."""
    t = D.float() @ W.float()
    inv = 1.0 / torch.clamp_min(scale.float(), 1e-12)
    return torch.clamp(torch.round(t * inv[None, :]), -127, 127).to(torch.int8)


def _check(D: torch.Tensor, W: torch.Tensor, scale: torch.Tensor | None,
           what: str) -> None:
    tensors = [D, W] + ([] if scale is None else [scale])
    if any(t.device != D.device for t in tensors) or D.device.type != "cuda":
        raise ValueError(f"{what} needs all operands on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if D.dim() != 2 or D.dtype not in _DTYPES or not D.is_contiguous():
        raise ValueError(f"{what}: D must be a contiguous 2-D f32/bf16 tensor, "
                         f"got {tuple(D.shape)} {D.dtype}")
    if (W.dim() != 2 or W.dtype != torch.float32 or not W.is_contiguous()
            or W.shape[0] != D.shape[1]):
        raise ValueError(f"{what}: W must be a contiguous ({D.shape[1]}, m) "
                         f"f32 tensor, got {tuple(W.shape)} {W.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or tuple(scale.shape) != (W.shape[1],)
                              or not scale.is_contiguous()):
        raise ValueError(f"{what}: scale must be a contiguous ({W.shape[1]},) "
                         f"f32 tensor, got {tuple(scale.shape)} {scale.dtype}")
    if D.shape[0] < 1 or D.shape[1] < 1 or W.shape[1] < 1:
        raise ValueError(f"{what}: empty operand {tuple(D.shape)} x "
                         f"{tuple(W.shape)}")


def _launch(D, W, scale, out, what: str) -> None:
    lib = _build.load("pca_project", _SIGNATURES)
    n, d = D.shape
    with torch.cuda.device(D.device):
        err = lib.pca_project_f32(
            D.data_ptr(), W.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            n, d, W.shape[1], _DTYPES[D.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, what)


def pca_project_cuda(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(n, m) ``D @ W`` in D's dtype, fp32 accumulate."""
    _check(D, W, None, "pca_project")
    out = torch.empty((D.shape[0], W.shape[1]), dtype=D.dtype, device=D.device)
    _launch(D, W, None, out, "pca_project")
    pca_project_cuda.launches += 1
    return out


def pca_project_quant_cuda(D: torch.Tensor, W: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """(n, m) int8 ``clip(round((D @ W) * (1 / max(scale, 1e-12))), ±127)``."""
    _check(D, W, scale, "pca_project_quant")
    out = torch.empty((D.shape[0], W.shape[1]), dtype=torch.int8,
                      device=D.device)
    _launch(D, W, scale, out, "pca_project_quant")
    pca_project_quant_cuda.launches += 1
    return out


pca_project_cuda.launches = 0
pca_project_quant_cuda.launches = 0
