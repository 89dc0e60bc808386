"""Invariant fixtures: each rescore breaks exactly one value contract that
the invariant tests hold the live pipeline to (counterpart of
``repro/analysis/fixtures/bad_invariants.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def unsorted_rescore(D: torch.Tensor, q: torch.Tensor, cids: torch.Tensor, k: int = 5):
    """Skips ``_shortlist``: the gathered ids reach the rescore in raw
    coarse order, never sorted. Trips exactly ``inv.rowids-order``."""
    uids = cids.reshape(-1)
    rows = D[uids.clamp_min(0)]
    return ops.topk_score(rows, q.contiguous(), k=k, row_ids=uids.int().contiguous())


def swapped_dedup_rescore(D: torch.Tensor, q: torch.Tensor, cids: torch.Tensor,
                          k: int = 5):
    """The dedup select with its branches swapped: it keeps the repeats and
    sets each first occurrence to -1, so the ids are sorted but not
    distinct. Trips exactly ``inv.dedup-tiebreak``."""
    flat = torch.sort(cids.reshape(-1)).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[1:] = flat[1:] == flat[:-1]
    uids = torch.where(dup, flat, torch.full_like(flat, -1))     # branches swapped
    rows = D[uids.clamp_min(0)]
    return ops.topk_score(rows, q.contiguous(), k=k, row_ids=uids.int().contiguous())


def unmasked_rescore(D: torch.Tensor, q: torch.Tensor, cids: torch.Tensor, k: int = 5):
    """A correct shortlist whose -1 lanes are never masked before its own
    top-k: a lane gathers row 0 and competes as a document. Trips exactly
    ``inv.sentinel-mask``."""
    flat = torch.sort(cids.reshape(-1)).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[1:] = flat[1:] == flat[:-1]
    uids = torch.where(dup, torch.full_like(flat, -1), flat)     # correct dedup
    rows = D[uids.clamp_min(0)].float()
    s = q @ rows.T                                               # missing the mask
    top, j = torch.topk(s, k, dim=1)
    return top, uids[None, :].expand_as(s).gather(1, j).int()


def overlapping_segments(D1: torch.Tensor, D2: torch.Tensor, scale: torch.Tensor,
                         q: torch.Tensor, k: int = 5):
    """Two delta searches whose [offset, offset + capacity) id intervals
    collide: two documents share an id. Trips exactly
    ``inv.segment-offsets``."""
    from repro_torch.core import index
    a = index._delta_topk(D1, scale, q, D1.shape[0], 100, k)
    b = index._delta_topk(D2, scale, q, D2.shape[0], 132, k)
    return a, b
