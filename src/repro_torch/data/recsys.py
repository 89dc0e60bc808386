"""Synthetic recsys batches (Criteo-shaped), deterministic per (seed, step)
(a numpy copy of ``repro/data/recsys.py``: the same ``(seed, step)`` gives
the same arrays, bit for bit)."""
from __future__ import annotations

import numpy as np


def ctr_batch(seed: int, step: int, *, batch: int, vocab_sizes, n_dense: int = 0
              ) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 11]))
    # zipf-ish skew: real CTR ids are heavy-tailed
    sparse = np.stack([
        np.minimum((rng.pareto(1.2, size=batch) * (v / 50)).astype(np.int64), v - 1)
        for v in vocab_sizes], axis=1).astype(np.int32)
    out = {"sparse": sparse,
           "label": (rng.random(batch) < 0.25).astype(np.float32)}
    if n_dense:
        out["dense"] = rng.standard_normal((batch, n_dense)).astype(np.float32)
    return out


def two_tower_batch(seed: int, step: int, *, batch: int, user_vocab: int,
                    item_vocab: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 13]))
    item_ids = np.minimum((rng.pareto(1.1, size=batch) * (item_vocab / 50)
                           ).astype(np.int64), item_vocab - 1).astype(np.int32)
    # logQ correction: popularity-proportional sampling probability
    freq = 1.0 / (1.0 + item_ids.astype(np.float64))
    logq = np.log(freq / freq.sum() * batch).astype(np.float32)
    return {"user_ids": rng.integers(0, user_vocab, batch).astype(np.int32),
            "item_ids": item_ids,
            "item_logq": logq}
