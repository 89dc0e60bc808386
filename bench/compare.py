"""The comparison that decides ``correct``.

Each sampled reply is judged by what it says, against the reference
(``reference.py``) over the same drawn corpus and query:

- ``unanswered``: requests of the window that got no reply, or an error,
  within a minute of the window's close (exact: limit 0);
- ``malformed``: sampled replies that are not a top-k list: an id outside
  the corpus or repeated, a score that is not finite, scores not
  descending, or equal scores whose ids are not ascending (exact: limit 0);
- ``score_gap``: the widest gap between a served score and the
  reference's score of the same id;
- ``rank_gap``: the widest gap by which the reference's score of the j-th
  served id lies below the reference's j-th best score, over every
  position j of every sampled reply (0 where the list is the reference's).

Both are taken under the judged side's own ``W_m`` (``reference.py``), so
that ``W_m`` is judged on its own, against the fp64 eigendecomposition of
the corpus (``reference.Spectrum``):

- ``shortfall``: the share of the leading eigenvalues' sum that it misses;
- ``leak``: its span past the boundary's nearly equal eigenvectors.

The configuration file holds the limits of the last four (``limits``), set
from the program's readings over many seeds and the control's or, for the
fit's two, a fit over half the rows (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch

EXACT = ("unanswered", "malformed")


def malformed(scores: np.ndarray, ids: np.ndarray, n: int) -> int:
    """How many rows of (S, k) replies are not a well-formed top-k list."""
    bad = ~np.isfinite(scores).all(1) | ((ids < 0) | (ids >= n)).any(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    ds = np.diff(scores, axis=1)
    bad |= (ds > 0).any(1)
    bad |= ((ds == 0) & (np.diff(ids, axis=1) < 0)).any(1)
    return int(bad.sum())


def readings(scores: np.ndarray, ids: np.ndarray, Q: torch.Tensor, ref, k: int
             ) -> dict[str, float]:
    """``malformed``, ``score_gap`` and ``rank_gap`` of the served (S, k)
    ``scores`` / ``ids`` for the queries ``Q`` against ``ref``. Where the
    reference's score is an interval (an int8 level that may round either
    way), a gap counts from the interval's nearer end."""
    n = ref.D.shape[0]
    best_lo, _ = ref.topk(Q, k, low=True)
    lo, hi = ref.bounds(Q, torch.as_tensor(ids, device=ref.D.device))
    best_lo, lo, hi = (t.double().cpu().numpy() for t in (best_lo, lo, hi))
    served = scores.astype(np.float64)
    with np.errstate(invalid="ignore"):
        score_gap = np.maximum(np.maximum(lo - served, served - hi), 0.0)
        rank_gap = best_lo - hi
    score_gap = float(np.max(np.where(np.isnan(score_gap), np.inf, score_gap)))
    rank_gap = float(max(0.0, np.max(np.where(np.isnan(rank_gap), np.inf, rank_gap))))
    return dict(malformed=malformed(scores, ids, n), score_gap=score_gap,
                rank_gap=rank_gap)


def verdict(values: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict[str, dict]]:
    """(correct, each number with its limit). A number with no limit fails."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = 0 if name in EXACT else limits.get(name)
        passed = limit is not None and np.isfinite(value) and value <= limit
        ok &= bool(passed)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
