"""Fixtures for the benchmark's CPU tests.

``tiny_root`` copies ``BENCHMARK.json`` and ``bench/`` into a temporary
checkout and adds, as data files only, a tiny copy of each configuration
(20,000 x 64, m 32, the real configuration's limits) with a cell for each of
the benchmark's traffic mixes, which reports the metrics of the benchmark's
cell of its store and mix: the harness then runs a whole cell on the CPU in a
couple of seconds.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(n_docs=20000, d=64, m=32)
MIXES = {"open-k10": False, "open-k1000": True}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def copy_checkout(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def add_tiny(root: Path, rate: float = 300.0) -> dict[str, str]:
    """Tiny configurations and their cells in the checkout ``root``; returns
    {store: config name}."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    stores = {c["name"]: json.loads((root / c["file"]).read_text())["store"]
              for c in spec["configs"]}
    real = list(spec["workloads"])
    names = {}
    for entry in list(spec["configs"]):
        cfg = json.loads((root / entry["file"]).read_text())
        name = f"tiny-{cfg['store']}"
        names[cfg["store"]] = name
        cfg.update(name=name, m=TINY["m"])
        cfg["corpus"].update(n_docs=TINY["n_docs"], d=TINY["d"])
        (root / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(entry, name=name, file=f"bench/configs/{name}.json"))
        for mix, bucket in MIXES.items():
            cell = f"{name}.{mix}"
            (root / "bench" / "cells" / f"{cell}.json").write_text(json.dumps(dict(
                config=name, traffic=mix, rate=rate, chips=1, why="CPU rehearsal",
                server=dict(max_batch=32, pipeline_depth=3, bucket_batches=bucket))))
            twin = mirrored(real, stores, cfg["store"], mix)
            spec["workloads"].append(dict(name=cell, config=name, traffic=mix, chips=1,
                                          why="CPU rehearsal"))
            for metric in spec["end_to_end"] + spec["per_layer"]:
                if twin in metric.get("workloads", ()):
                    metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return names


def mirrored(cells: list, stores: dict, store: str, mix: str) -> str:
    """The benchmark's cell whose metrics a tiny cell reports: the one of the
    same store and mix, else the first of the same mix."""
    same = [w for w in cells if w["traffic"] == mix]
    alike = [w for w in same if stores[w["config"]] == store]
    return (alike or same)[0]["name"]


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_checkout(tmp_path)
    add_tiny(root)
    return root


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def cuda_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
