"""Symmetric per-dimension int8 quantisation of an index (port of
``repro/core/quantization.py``).

Scores fold the scale into the query: (D_int8 diag(s)) q = D_int8 (s * q),
so the index stays int8 end to end. The int8 bytes equal the reference's
exactly: an f32 divide by the scale, round half to even, clip to ±127.
"""
from __future__ import annotations

import numpy as np
import torch


def quantize_with_scale(X: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host-side symmetric int8 under a given per-dim scale."""
    return np.clip(np.round(np.asarray(X, np.float32) / scale[None, :]),
                   -127, 127).astype(np.int8)


def scale_for(X: np.ndarray) -> np.ndarray:
    """Per-dim symmetric scale covering X's absmax (host-side)."""
    return (np.maximum(np.abs(np.asarray(X, np.float32)).max(axis=0), 1e-12)
            / 127.0).astype(np.float32)


def quantize_int8_per_dim(X: torch.Tensor, *, block_rows: int = 1 << 20
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column int8: (q (n, m) int8, scale (m,) f32).

    Works in row blocks of ``block_rows`` (one pass for the absmax, one to
    quantise), so the transient f32 copies stay the size of a block even
    for an index of many GB.
    """
    n, m = X.shape
    absmax = torch.zeros(m, dtype=torch.float32, device=X.device)
    for i in range(0, n, block_rows):
        absmax = torch.maximum(absmax, X[i:i + block_rows].float().abs().amax(0))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.empty((n, m), dtype=torch.int8, device=X.device)
    for i in range(0, n, block_rows):
        blk = X[i:i + block_rows].float() / scale[None, :]
        q[i:i + block_rows] = torch.clamp(torch.round(blk), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[None, :]


def quantization_error(X: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius reconstruction error of the int8 round trip."""
    q, s = quantize_int8_per_dim(X)
    err = dequantize_int8(q, s) - X.float()
    return torch.linalg.norm(err) / torch.clamp_min(torch.linalg.norm(X.float()), 1e-12)
