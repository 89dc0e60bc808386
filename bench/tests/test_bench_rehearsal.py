"""A whole run of a cell on the CPU at a tiny size: the harness's control
flow, the result's keys, and the comparison on sound output."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench import harness, spec

SEED = 2**31 + 977     # larger than 32 signed bits hold


@pytest.mark.parametrize("store", ["float32", "int8"])
@pytest.mark.parametrize("mix", ["open-k10", "open-k1000"])
def test_cell_runs_and_is_correct(tiny_root, cpu, store, mix):
    cell = f"tiny-{store}.{mix}"
    out = harness.run_cell(cell, SEED, 1.0, False, root=tiny_root, device=cpu)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "host",
                         "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 300 and out["failed"] == 0
    want = {m.name: m.unit for m in spec.load_cell(cell, tiny_root).end_to_end}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    assert list(out["checks"]) == ["unanswered", "malformed", "score_gap", "rank_gap",
                                   "shortfall", "leak"]
    json.dumps(out, allow_nan=False)


def test_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root, cpu):
    out = harness.run_cell("tiny-int8.open-k1000", SEED, 2.5, True, root=tiny_root,
                           device=cpu)
    assert out["correct"] is True, out["checks"]
    # the CPU has no device trace and no CUDA launches: those readers return nothing
    assert set(out["metrics"]) == {"gen_late_ms", "batch_ms", "mean_batch"}
    assert 1 <= out["metrics"]["mean_batch"]["value"] <= 32


def test_same_seed_same_inputs(tiny_root, cpu):
    import torch

    from bench import data, traffic
    cell = spec.load_cell("tiny-float32.open-k10", tiny_root)
    a = data.corpus(cell.config, data.generator(SEED, cpu), cpu)
    b = data.corpus(cell.config, data.generator(SEED, cpu), cpu)
    assert torch.equal(a, b)
    t1 = traffic.arrivals(cell.traffic, 300.0, 2.0, SEED)
    t2 = traffic.arrivals(cell.traffic, 300.0, 2.0, SEED)
    t3 = traffic.arrivals(cell.traffic, 300.0, 2.0, SEED + 1)
    assert np.array_equal(t1, t2) and not np.array_equal(t1, t3)
    assert len(t1) == len(t3) == 600 and np.all(np.diff(t1) >= 0)
    assert 0 <= t1[0] and t1[-1] < 2.0


def test_onoff_arrivals_keep_the_count_and_burst():
    from bench import traffic
    mix = dict(arrivals="onoff", on_s=0.5, off_s=1.5, off_share=0.1)
    t = traffic.arrivals(mix, 1000.0, 8.0, 5)
    assert len(t) == 8000
    on = np.mean((t % 2.0) < 0.5)
    # the on phases take a quarter of the time and 0.5 / (0.5 + 0.15) of the load
    assert 0.74 < on < 0.80


def test_tail_reads_the_requests_before_the_profiled_slice(tiny_root, cpu):
    from types import SimpleNamespace
    read = spec.Metric("tail_p95_ms", "ms").reader(tiny_root)
    sched = np.linspace(0.0, 2.0, 400, endpoint=False)
    done = sched + np.where(sched < 0.5, 0.010, 0.500)     # the slice's stall from 0.5 s
    rec = SimpleNamespace(sched=sched, t0=0.0, done=done, profiled=(0.5, 1.5))
    assert read(rec) == pytest.approx(10.0)
    assert read(SimpleNamespace(**{**vars(rec), "profiled": None})) == pytest.approx(500.0)
    out = harness.run_cell("tiny-int8.open-k10", SEED, 2.5, True, root=tiny_root, device=cpu)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["tail_p95_ms"]["value"] > 0
