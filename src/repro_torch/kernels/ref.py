"""Plain PyTorch oracles, one per kernel, mirroring ``repro/kernels/ref.py``.

Each kernel module takes its plain version (what a CPU tensor runs) from
here, except ``pca_project_quant_plain``: the fused epilogue multiplies by
the reciprocal scale as the TPU kernel does, while the oracle here divides,
as the reference's oracle and the default int8 build do. The two may
differ by ±1 on a rounding boundary.

The top-k breaks ties toward the lowest id (the first occurrence, as
``jax.lax.top_k`` does): ``torch.topk`` promises no order among ties, so it
sorts with ``stable=True`` instead.
"""
from __future__ import annotations

import torch


def gram_ref(D: torch.Tensor) -> torch.Tensor:
    Df = D.float()
    return Df.T @ Df


def topk_score_ref(D: torch.Tensor, Q: torch.Tensor, *, k: int,
                   n_valid: int | None = None,
                   row_ids: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every row, then one stable sort under (score desc, id asc).

    k pad candidates (-inf, -1) go first, so they win every -inf tie as the
    TPU kernel's initial running list does; a slot left at -inf reports -1.
    """
    n = D.shape[0]
    B = Q.shape[0]
    s = Q.float() @ D.float().T                                  # (B, n)
    if row_ids is None:
        ids = torch.arange(n, dtype=torch.int64, device=D.device)
        valid = ids < (n if n_valid is None else n_valid)
    else:
        ids = row_ids.to(torch.int64)
        valid = ids >= 0
    s = s.masked_fill(~valid[None, :], float("-inf"))
    s = torch.cat([torch.full((B, k), float("-inf"), device=s.device), s], 1)
    ids = torch.cat([torch.full((k,), -1, dtype=torch.int64, device=s.device),
                     ids])
    if row_ids is not None:
        # ascending ids first, so the stable sort below breaks ties by id
        order = torch.sort(ids, stable=True).indices
        s, ids = s[:, order], ids[order]
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    out_ids = torch.where(torch.isneginf(vals), -1, ids[idx[:, :k]])
    return vals, out_ids.to(torch.int32)


def pca_project_ref(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return (D.float() @ W.float()).to(D.dtype)


def pca_project_quant_ref(D: torch.Tensor, W: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    t = D.float() @ W.float()
    q = torch.clamp(torch.round(t / torch.clamp_min(scale[None, :], 1e-12)),
                    -127, 127)
    return q.to(torch.int8)
