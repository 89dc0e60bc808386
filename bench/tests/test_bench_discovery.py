"""A later cell, traffic mix or metric is a new file found by its name: the
harness runs it with no file of ``bench/`` edited."""
from __future__ import annotations

import hashlib
import json

from bench import harness


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_new_cell_mix_and_metric_are_found_by_name(tiny_root, cpu):
    before = digests(tiny_root)
    bench = tiny_root / "bench"
    (bench / "traffic" / "bursty-k20.json").write_text(json.dumps(
        dict(arrivals="onoff", on_s=0.25, off_s=0.25, off_share=0.2, k=20, query_noise=0.5)))
    (bench / "cells" / "tiny-int8.bursty-k20.json").write_text(json.dumps(dict(
        config="tiny-int8", traffic="bursty-k20", rate=250, chips=1, why="bursts",
        server=dict(max_batch=16, pipeline_depth=2, bucket_batches=True))))
    (bench / "metrics" / "answered_share.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    return 100.0 * float(np.mean(~np.isnan(rec.done)))\n")
    (bench / "metrics" / "p99_ms.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    return float(np.percentile(rec.done - (rec.t0 + rec.sched), 99)) * 1e3\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="tiny-int8.bursty-k20", config="tiny-int8",
                                  traffic="bursty-k20", chips=1, why="bursts"))
    next(m for m in spec["end_to_end"] if m["name"] == "p95_ms")["workloads"].append(
        "tiny-int8.bursty-k20")
    spec["end_to_end"].append(dict(name="p99_ms", unit="ms", better="lower", bound=0.1,
                                   source="host_clock", workloads=["tiny-int8.bursty-k20"]))
    spec["per_layer"].append(dict(name="answered_share", unit="%", better="higher",
                                  source="host_clock", layer="load generator",
                                  moves="p99_ms", workloads=["tiny-int8.bursty-k20"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    out = harness.run_cell("tiny-int8.bursty-k20", 31, 2.0, False, root=tiny_root, device=cpu)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 500
    assert set(out["metrics"]) == {"p50_ms", "p95_ms", "qps", "setup_s", "p99_ms"}
    traced = harness.run_cell("tiny-int8.bursty-k20", 32, 2.0, True, root=tiny_root,
                              device=cpu)
    assert traced["metrics"]["answered_share"]["value"] == 100.0
    # an existing cell does not report the new cell's metrics
    other = harness.run_cell("tiny-int8.open-k10", 33, 1.0, False, root=tiny_root, device=cpu)
    assert "p99_ms" not in other["metrics"]

    after = digests(tiny_root)
    assert {p: h for p, h in after.items() if p in before} == before
