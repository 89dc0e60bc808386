"""On the card (skips without one): a cell at the published widths over a
smaller corpus runs correct through the CUDA kernels, and its traced run
reads every per-layer metric from the device trace.

    python -m pytest -m gpu bench/tests/test_bench_card.py

Each run is a process of its own, as the benchmark's runs are: a second
traced window in one process lost the server threads' ranges (on the card,
torch 2.11), so its calls could not be found in the trace.
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench.spec import load_cell
from bench.tests.conftest import ROOT, add_tiny, copy_checkout


def run_cell(root, cell: str, seed: int, seconds: float, trace: bool) -> dict:
    code = ("import json, sys, torch; sys.path[:0] = [%r, %r]; from bench import harness; "
            "print(json.dumps(harness.run_cell(%r, %d, %r, %r, root=%r, "
            "device=torch.device('cuda', 0))))"
            % (str(ROOT), str(ROOT / "src"), cell, seed, seconds, trace, str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("store", ["float32", "int8"])
def test_cell_on_the_card(tmp_path, cuda, store):
    root = copy_checkout(tmp_path)
    names = add_tiny(root, rate=1500.0)
    cfg_path = root / "bench" / "configs" / f"{names[store]}.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["corpus"].update(n_docs=262_144, d=768)
    cfg["m"] = 384
    cfg_path.write_text(json.dumps(cfg))
    cell = f"{names[store]}.open-k10"
    out = run_cell(root, cell, 2**31 + 5, 3.0, False)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    traced = run_cell(root, cell, 2**31 + 6, 4.0, True)
    assert traced["correct"] is True, traced["checks"]
    assert set(traced["metrics"]) == {m.name for m in load_cell(cell, root).per_layer}
    assert {"search_ms", "search_roofline", "launches_per_batch", "device_idle"} <= set(
        traced["metrics"])
    assert 0 < traced["metrics"]["search_roofline"]["value"] <= 100
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
