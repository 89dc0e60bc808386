"""Public entry points for the kernels, mirroring ``repro/kernels/ops.py``.

Where ``repro`` takes ``interpret``, the port takes the tensors' device: a
CUDA tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor runs the plain PyTorch version. There is no other fallback. Block
sizes are not arguments: the CUDA kernels fix their tiles for the card and
the plain versions need none. ``topk_score_paged`` is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram import gram_cuda, gram_plain
from repro_torch.kernels.pca_project import (
    pca_project_cuda,
    pca_project_plain,
    pca_project_quant_cuda,
    pca_project_quant_plain,
)
from repro_torch.kernels.topk_score import topk_score_cuda, topk_score_plain


def _on_card(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all be on the CPU or all on a CUDA "
                     f"device, got {[str(t.device) for t in tensors]}")


def gram(D: torch.Tensor) -> torch.Tensor:
    """``D^T D`` (fp32)."""
    return gram_cuda(D) if _on_card(D) else gram_plain(D)


def topk_score(D: torch.Tensor, Q: torch.Tensor, *, k: int,
               n_valid: int | None = None,
               row_ids: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k over a document index.

    The index is read in its storage dtype (an int8 dequant scale must be
    folded into ``Q``); ``n_valid`` masks trailing rows; ``row_ids``
    switches to shortlist-rescore mode, where each row reports its gathered
    doc id and negative ids are masked out.
    """
    operands = (D, Q) if row_ids is None else (D, Q, row_ids)
    if _on_card(*operands):
        return topk_score_cuda(D, Q, k=k, n_valid=n_valid, row_ids=row_ids)
    return topk_score_plain(D, Q, k=k, n_valid=n_valid, row_ids=row_ids)


def pca_project(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``D @ W_m`` index build, output in D's dtype."""
    return pca_project_cuda(D, W) if _on_card(D, W) else pca_project_plain(D, W)


def pca_project_quant(D: torch.Tensor, W: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``D @ W_m`` with the fused int8 quantisation epilogue."""
    if _on_card(D, W, scale):
        return pca_project_quant_cuda(D, W, scale)
    return pca_project_quant_plain(D, W, scale)
