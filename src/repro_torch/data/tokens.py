"""Deterministic synthetic token pipeline with background prefetch (a numpy
copy of ``repro/data/tokens.py``: the same ``(seed, step)`` gives the same
arrays, bit for bit).

Determinism contract (fault tolerance): batch ``t`` is a pure function of
``(seed, t)`` — a restarted or re-scaled job replays the identical global
batch sequence from any step, so checkpoint-resume is bit-reproducible and
stragglers can be re-issued idempotently.

Prefetch: a daemon thread keeps a bounded queue of host batches ahead of
the training loop (straggler mitigation at the input layer — device steps
never wait on host-side generation).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def token_batch(seed: int, step: int, *, batch: int, seq_len: int,
                vocab: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic LM batch: tokens + next-token labels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # mixture of a few 'topics' so the LM has learnable structure
    n_topics = 16
    topic = rng.integers(0, n_topics, size=(batch, 1))
    base = (topic * (vocab // n_topics)) % vocab
    drift = rng.integers(0, max(vocab // n_topics, 2), size=(batch, seq_len))
    tokens = ((base + drift) % vocab).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    return {"tokens": tokens, "labels": labels}


def pair_batch(seed: int, step: int, *, batch: int, seq_len: int,
               vocab: int) -> dict[str, np.ndarray]:
    """Query/positive-document pairs for contrastive bi-encoder training.

    A pair shares a topic prefix; negatives are implicit (in-batch)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    n_topics = 64
    topic = rng.integers(0, n_topics, size=(batch, 1))
    span = max(vocab // n_topics, 2)

    def draw(noise):
        drift = rng.integers(0, span, size=(batch, seq_len))
        flip = rng.random((batch, seq_len)) < noise
        rand = rng.integers(0, vocab, size=(batch, seq_len))
        toks = (topic * span + drift) % vocab
        return np.where(flip, rand, toks).astype(np.int32)

    q_tokens = draw(0.3)
    d_tokens = draw(0.1)
    ones = np.ones((batch, seq_len), np.int32)
    return {"q_tokens": q_tokens, "q_mask": ones,
            "d_tokens": d_tokens, "d_mask": ones}


class Prefetcher:
    """Bounded background prefetch over a step-indexed batch function."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 4):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
