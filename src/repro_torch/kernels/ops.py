"""Public entry points for the kernels, mirroring ``repro/kernels/ops.py``.

Where ``repro`` takes ``interpret``, the port takes the tensors' device: a
CUDA tensor launches the hand-written kernel (or the wrapper raises), a CPU
tensor runs the plain PyTorch version. There is no other fallback. Block
sizes are not arguments: the CUDA kernels fix their tiles for the card and
the plain versions need none.
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
from repro_torch.kernels.topk_score import (
    topk_score_cuda,
    topk_score_paged_cuda,
    topk_score_paged_plain,
    topk_score_plain,
)


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
               n_valid: int | torch.Tensor | None = None,
               row_ids: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k over a document index.

    The index is read in its storage dtype (an int8 dequant scale must be
    folded into ``Q``); ``n_valid`` (a host int, or a 0-d int32 tensor on
    D's device that the host never reads) masks trailing rows; ``row_ids``
    switches to shortlist-rescore mode, where each row reports its gathered
    doc id and negative ids are masked out.
    """
    operands = [D, Q] + [t for t in (row_ids, n_valid) if isinstance(t, torch.Tensor)]
    if _on_card(*operands):
        return topk_score_cuda(D, Q, k=k, n_valid=n_valid, row_ids=row_ids)
    return topk_score_plain(D, Q, k=k, n_valid=n_valid, row_ids=row_ids)


def topk_score_paged(pool: torch.Tensor, page_table: torch.Tensor,
                     page_nvalid: torch.Tensor, page_offset: torch.Tensor,
                     lo: int, hi: int, Q: torch.Tensor, *, k: int,
                     tail: torch.Tensor | None = None,
                     page_scale: torch.Tensor | None = None,
                     ids_pool: torch.Tensor | None = None,
                     carry: tuple[torch.Tensor, torch.Tensor] | None = None,
                     finalize: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k over a paged index: logical slots [lo, hi) of
    ``page_table``, whose entries address the stable ``pool`` or, at and
    beyond its page count, the append ``tail``. Pages are read in their
    storage dtype; ``page_scale`` folds per-page int8 scales into the
    query; ``ids_pool`` switches to the rescore mode; ``carry`` /
    ``finalize=False`` chain runs and host-tier waves (pass the un-clamped
    ids of a ``finalize=False`` call back in).
    """
    operands = [pool, page_table, page_nvalid, page_offset, Q]
    operands += [t for t in (tail, page_scale, ids_pool) if t is not None]
    if carry is not None:
        operands += list(carry)
    fn = topk_score_paged_cuda if _on_card(*operands) else topk_score_paged_plain
    return fn(pool, page_table, page_nvalid, page_offset, lo, hi, Q, k=k,
              tail=tail, page_scale=page_scale, ids_pool=ids_pool, carry=carry,
              finalize=finalize)


def pca_project(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``D @ W_m`` index build, output in D's dtype."""
    return pca_project_cuda(D, W) if _on_card(D, W) else pca_project_plain(D, W)


def pca_project_quant(D: torch.Tensor, W: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``D @ W_m`` with the fused int8 quantisation epilogue."""
    if _on_card(D, W, scale):
        return pca_project_quant_cuda(D, W, scale)
    return pca_project_quant_plain(D, W, scale)
