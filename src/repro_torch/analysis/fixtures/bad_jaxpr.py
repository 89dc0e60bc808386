"""Dispatch-lint fixtures: each function breaks one hot-path invariant on
purpose (counterpart of ``repro/analysis/fixtures/bad_jaxpr.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def upcasting_search(D_int8: torch.Tensor, scale: torch.Tensor, q: torch.Tensor,
                     k: int = 10):
    """Dequantise the whole int8 corpus to f32 before the top-k: a 4x
    shadow copy instead of streaming the index in its storage dtype.
    Trips ``dispatch.upcast``."""
    Df = D_int8.float() * scale[None, :]
    return ops.topk_score(Df, q.contiguous(), k=k)


def chatty_search(D: torch.Tensor, q: torch.Tensor, k: int = 10):
    """Reads a score back to the host inside the search: every search waits
    for the card. Trips ``dispatch.host-sync``."""
    s, i = ops.topk_score(D, q.contiguous(), k=k)
    if float(s[0, 0]) > 1e30:
        raise OverflowError("score out of range")
    return s, i


def two_call_search(D: torch.Tensor, q: torch.Tensor, k: int = 10):
    """The rows searched in two top-k calls and merged, where the contract
    says one: a second pass over the candidates. Trips
    ``dispatch.extra-dispatch``."""
    h = D.shape[0] // 2
    a = ops.topk_score(D[:h].contiguous(), q.contiguous(), k=k)
    b = ops.topk_score(D[h:].contiguous(), q.contiguous(), k=k)
    s = torch.cat([a[0], b[0]], 1)
    ids = torch.cat([a[1], torch.where(b[1] >= 0, b[1] + h, b[1])], 1)
    top, j = torch.sort(s, dim=1, descending=True, stable=True)
    return top[:, :k], torch.gather(ids, 1, j[:, :k])


class RecompilingSearcher:
    """Slices the index to its live rows before the top-k, so the call's
    operand shape follows the live count: a captured graph could not replay
    as the index grows. Trips ``dispatch.recompile``."""

    def __init__(self, D: torch.Tensor, q: torch.Tensor):
        self.D = D
        self.q = q.contiguous()

    def search(self, n_valid: int):
        return ops.topk_score(self.D[:n_valid].contiguous(), self.q, k=5)
