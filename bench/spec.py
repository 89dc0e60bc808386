"""What one cell is, read from data files by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Everything that belongs to one of them sits in a
file of its own under ``bench/``:

- ``configs/<config>.json``: the deployment (corpus sizes, spectrum, cutoff,
  storage), named by the configuration's ``file``;
- ``traffic/<mix>.json``: the traffic mix that ``traffic.py`` reads;
- ``cells/<cell>.json``: the cell's fixed arrival rate and server settings;
- ``metrics/<metric>.py``: one reader, ``read(rec)``, of the run's record.

A later cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class SpecError(ValueError):
    """A cell, configuration, mix or metric that the files do not define."""


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str

    def reader(self, root: Path):
        """The metric's ``read(rec)``, loaded from ``metrics/<name>.py``."""
        path = root / "bench" / "metrics" / f"{self.name}.py"
        if not path.is_file():
            raise SpecError(f"metric {self.name!r} has no reader at {path}")
        mod_spec = importlib.util.spec_from_file_location(
            f"bench_metric_{self.name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    rate: float          # offered arrivals a second
    server: dict         # RetrievalServer settings
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]
    root: Path


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file at {path}")
    return json.loads(path.read_text())


def _metrics(entries: list, cell: str) -> tuple[Metric, ...]:
    """The metrics of ``entries`` that ``cell`` reports."""
    return tuple(Metric(e["name"], e["unit"])
                 for e in entries if cell in e.get("workloads", [cell]))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` under ``root``."""
    root = Path(root)
    spec = _read_json(root / "BENCHMARK.json", "benchmark")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"unknown workload {name!r}; known: {sorted(cells)}")
    wl = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(root / configs[wl["config"]]["file"], f"config {wl['config']}")
    traffic = _read_json(root / "bench" / "traffic" / f"{wl['traffic']}.json",
                         f"traffic {wl['traffic']}")
    cellfile = _read_json(root / "bench" / "cells" / f"{name}.json", f"cell {name}")
    for key, want in (("config", wl["config"]), ("traffic", wl["traffic"])):
        if cellfile[key] != want:
            raise SpecError(f"cell {name}: its file says {key} {cellfile[key]!r}, "
                            f"BENCHMARK.json {want!r}")
    return Cell(name=name, chips=int(wl["chips"]), config=config, traffic=traffic,
                rate=float(cellfile["rate"]), server=dict(cellfile["server"]),
                end_to_end=_metrics(spec["end_to_end"], name),
                per_layer=_metrics(spec["per_layer"], name), root=root)
