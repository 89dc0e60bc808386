"""PCA projection ``D @ W_m``, plain and with a fused int8 epilogue: the CUDA
kernels and their plain versions.

Replaces ``repro/kernels/pca_project.py::pca_project_pallas`` and
``::pca_project_quant_pallas``. Two kernels (``csrc/pca_project.cu``) give
the same bits for the same rows. The tiled kernel, bound by fp32 FMAs
(about 256 FLOP per byte at d = 768, m = 384), splits the (n, m) output
over CTAs by 128 x 128 tile and loops over d inside the CTA. The small
kernel takes calls of few rows (a query batch, an appended block), where
that grid would leave most SMs idle: a CTA owns 32 columns by 8 rows and a
thread one chain a row. ``project_path`` chooses. The quant epilogue
multiplies by ``1 / max(scale, 1e-12)`` exactly as the TPU kernel does, so
no f32 index reaches device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_SIGNATURES = {
    "pca_project_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"tiled": 0, "small": 1}   # the C entry's path argument
TILE = 128              # rows and columns of the tiled kernel's output tile
# the small kernel takes a call whose tiled grid fills at most this share of
# the SMs (38 tiles of an H100's 132): there the two kernels take the same
# device time at 256 -> 128 (4,864 rows), and at 768 -> 384 they cross
# between 39 and 42 tiles (1,664 and 1,792 rows), as
# ``benchmarks/small_calls.py`` times them
FILL_SHARE = 0.29


def project_path(n: int, m: int, sms: int) -> str:
    """The kernel an (n, d) x (d, m) projection takes on a card of ``sms``
    SMs: ``"small"`` where the tiled grid of ceil(n / 128) ceil(m / 128)
    CTAs fills at most ``FILL_SHARE`` of the SMs, else ``"tiled"``. Both
    give the same bits, so the choice is one of speed only."""
    tiles = -(-n // TILE) * -(-m // TILE)
    return "small" if tiles <= FILL_SHARE * sms else "tiled"


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


def _launch(D, W, scale, out, what: str) -> bool:
    """Launch on D's device and stream; True where the small kernel ran."""
    lib = _build.load("pca_project", _SIGNATURES)
    n, d = D.shape
    m = W.shape[1]
    dev = D.device
    path = project_path(n, m, _build.sm_count(dev))
    with _build.on_device(dev):
        err = lib.pca_project_f32(
            D.data_ptr(), W.data_ptr(), None if scale is None else scale.data_ptr(),
            out.data_ptr(), n, d, m, _DTYPES[D.dtype],
            _build.raw_stream(dev), _PATHS[path])
    _build.check(err, what)
    return path == "small"


def pca_project_cuda(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(n, m) ``D @ W`` in D's dtype, fp32 accumulate, through the kernel
    ``project_path`` chooses. ``launches`` counts calls, ``small_launches``
    those that ran the small kernel."""
    _check(D, W, None, "pca_project")
    out = torch.empty((D.shape[0], W.shape[1]), dtype=D.dtype, device=D.device)
    if _launch(D, W, None, out, "pca_project"):
        pca_project_cuda.small_launches += 1
    pca_project_cuda.launches += 1
    return out


def pca_project_quant_cuda(D: torch.Tensor, W: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """(n, m) int8 ``clip(round((D @ W) * (1 / max(scale, 1e-12))), ±127)``;
    the kernel and the counts as ``pca_project_cuda``."""
    _check(D, W, scale, "pca_project_quant")
    out = torch.empty((D.shape[0], W.shape[1]), dtype=torch.int8,
                      device=D.device)
    if _launch(D, W, scale, out, "pca_project_quant"):
        pca_project_quant_cuda.small_launches += 1
    pca_project_quant_cuda.launches += 1
    return out


pca_project_cuda.launches = 0
pca_project_cuda.small_launches = 0
pca_project_quant_cuda.launches = 0
pca_project_quant_cuda.small_launches = 0
