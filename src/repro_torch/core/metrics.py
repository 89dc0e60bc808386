"""IR effectiveness metrics + significance testing.

Mirrors the paper's evaluation: AP, nDCG@10, MRR@10 (``ir_measures``
conventions) and a two-tailed paired Wilcoxon signed-rank test at α=0.05.

Run format: for each query, a ranked array of doc ids (descending score).
Qrels format: ``dict[qid] -> dict[docid] -> int grade`` (TREC-style), or the
dense array helpers below for synthetic benchmarks.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
from scipy import stats


# ---------------------------------------------------------------------------
# Per-query metrics (numpy — evaluation is host-side, tiny)
# ---------------------------------------------------------------------------


def dcg(grades: np.ndarray) -> float:
    """DCG with the standard (2^g - 1)/log2(rank+1) gain used by TREC DL."""
    if grades.size == 0:
        return 0.0
    ranks = np.arange(1, grades.size + 1)
    return float(np.sum((np.exp2(grades) - 1.0) / np.log2(ranks + 1.0)))


def ndcg_at_k(ranked_ids: Sequence[int], qrel: Mapping[int, int], k: int = 10) -> float:
    grades = np.array([qrel.get(int(d), 0) for d in ranked_ids[:k]], dtype=np.float64)
    ideal = np.sort(np.array(list(qrel.values()), dtype=np.float64))[::-1][:k]
    idcg = dcg(ideal)
    return dcg(grades) / idcg if idcg > 0 else 0.0


def average_precision(ranked_ids: Sequence[int], qrel: Mapping[int, int],
                      rel_threshold: int = 1, k: int | None = None) -> float:
    """AP over the full ranking (ir_measures AP; binarised at rel>=threshold)."""
    rel_total = sum(1 for g in qrel.values() if g >= rel_threshold)
    if rel_total == 0:
        return 0.0
    ids = ranked_ids if k is None else ranked_ids[:k]
    hits = 0
    score = 0.0
    for rank, d in enumerate(ids, start=1):
        if qrel.get(int(d), 0) >= rel_threshold:
            hits += 1
            score += hits / rank
    return score / rel_total


def mrr_at_k(ranked_ids: Sequence[int], qrel: Mapping[int, int],
             k: int = 10, rel_threshold: int = 1) -> float:
    for rank, d in enumerate(ranked_ids[:k], start=1):
        if qrel.get(int(d), 0) >= rel_threshold:
            return 1.0 / rank
    return 0.0


def recall_at_k(ranked_ids: Sequence[int], qrel: Mapping[int, int],
                k: int = 100, rel_threshold: int = 1) -> float:
    rel = {d for d, g in qrel.items() if g >= rel_threshold}
    if not rel:
        return 0.0
    return len(rel.intersection(int(d) for d in ranked_ids[:k])) / len(rel)


# ---------------------------------------------------------------------------
# Corpus-level evaluation
# ---------------------------------------------------------------------------

METRICS = {
    "AP": lambda r, q: average_precision(r, q),
    "MRR@10": lambda r, q: mrr_at_k(r, q, 10),
    "nDCG@10": lambda r, q: ndcg_at_k(r, q, 10),
}


def evaluate_run(run: Mapping[int, Sequence[int]],
                 qrels: Mapping[int, Mapping[int, int]],
                 metrics: Sequence[str] = ("AP", "MRR@10", "nDCG@10"),
                 ) -> dict[str, np.ndarray]:
    """Per-query metric vectors for every query present in ``qrels``.

    Queries missing from the run score 0 (TREC convention). Returns
    ``{metric: vector aligned with sorted(qrels)}`` so paired significance
    tests line up across systems.
    """
    qids = sorted(qrels)
    out: dict[str, np.ndarray] = {}
    for name in metrics:
        fn = METRICS[name]
        out[name] = np.array([fn(run.get(q, ()), qrels[q]) for q in qids], dtype=np.float64)
    return out


def mean_metrics(per_query: Mapping[str, np.ndarray]) -> dict[str, float]:
    return {k: float(v.mean()) if v.size else 0.0 for k, v in per_query.items()}


# ---------------------------------------------------------------------------
# Significance (paper: two-tailed paired Wilcoxon signed-rank, α = 0.05)
# ---------------------------------------------------------------------------


def wilcoxon_significant(baseline: np.ndarray, system: np.ndarray,
                         alpha: float = 0.05) -> tuple[bool, float]:
    """Paired two-tailed Wilcoxon signed-rank test.

    Returns ``(significant, p_value)``. All-zero differences ⇒ not
    significant (p=1.0), matching the paper's ANCE@25% "identical run" rows.
    """
    diff = np.asarray(system, dtype=np.float64) - np.asarray(baseline, dtype=np.float64)
    if np.allclose(diff, 0.0):
        return False, 1.0
    try:
        res = stats.wilcoxon(system, baseline, zero_method="wilcox",
                             alternative="two-sided", method="auto")
        p = float(res.pvalue)
    except ValueError:  # degenerate (e.g. < 1 nonzero pair)
        return False, 1.0
    return bool(p < alpha), p
