"""The controls (the reference one precision below the configuration's) and
the faults a served cell can have must each come out not correct; the
program's own output at the same size comes out correct
(``test_bench_rehearsal.py``)."""
from __future__ import annotations

import pytest
import torch

from bench import control, harness, spec


@pytest.mark.parametrize("store", ["float32", "int8"])
@pytest.mark.parametrize("mix", ["open-k10", "open-k1000"])
@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_the_control_is_not_correct(tiny_root, cpu, store, mix, seed):
    cell = spec.load_cell(f"tiny-{store}.{mix}", tiny_root)
    sides = control.readings(cell, seed, cpu)
    assert [o["side"] for o in sides] == [*control.CONTROLS[store], "half_rows"]
    for out in sides:
        assert out["correct"] is False, (out["side"], out["checks"])


class HalfBatch:
    """Half of each batch's live (non-padding) queries left out: they get
    the other half's answers."""

    def __init__(self, index):
        self._index = index

    def search_projected(self, queries, components, k=10, *, mean=None):
        live = int((queries.abs().sum(1) > 0).sum())
        h = max(1, (live + 1) // 2)
        s, i = self._index.search_projected(queries[:h], components, k=k, mean=mean)
        take = torch.arange(queries.shape[0]) % h
        return s[take], i[take]

    def __getattr__(self, name):
        return getattr(self._index, name)


class AlteredAnswer(HalfBatch):
    """One answer of each batch altered where it is produced: the first
    query's best id points at the next row."""

    def search_projected(self, queries, components, k=10, *, mean=None):
        s, i = self._index.search_projected(queries, components, k=k, mean=mean)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % self._index.n
        return s, i


@pytest.mark.parametrize("fault", [HalfBatch, AlteredAnswer])
@pytest.mark.parametrize("cell", ["tiny-float32.open-k10", "tiny-int8.open-k10",
                                  "tiny-int8.open-k1000"])
def test_a_broken_timed_path_is_not_correct(tiny_root, cpu, fault, cell):
    out = harness.run_cell(cell, 7, 1.0, False, root=tiny_root, device=cpu, wrap=fault)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["unanswered"]["value"] == 0


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_a_fit_over_half_the_rows_is_not_correct(tiny_root, cpu, store):
    # the search matches a reference under the same wrong W_m: only the
    # fit's own numbers can catch it
    out = harness.run_cell(f"tiny-{store}.open-k10", 7, 1.0, False, root=tiny_root,
                           device=cpu, fit_rows=lambda D: D[: D.shape[0] // 2])
    assert out["correct"] is False, out["checks"]
    checks = out["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("unanswered", "malformed", "score_gap", "rank_gap")), checks
    assert all(checks[k]["value"] > checks[k]["limit"] for k in ("shortfall", "leak")), checks
