"""Shared benchmark plumbing (port of ``benchmarks/common.py``): datasets,
retrieval, significance marking, and the command line every driver takes.

    python -m repro_torch.benchmarks.<name> [--device cpu] [--out PATH]
                                            [--n-docs N] [--dim D]

Each driver prints the reference's Markdown table and writes its results
as JSON to ``--out``, by default ``build/benchmarks/<name>.json`` at the
repository root (git-ignored). It runs on the card unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from repro_torch.core.index import DenseIndex
from repro_torch.core.metrics import evaluate_run, wilcoxon_significant
from repro_torch.data.synthetic import make_dataset
from repro_torch.util import as_tensor, default_device

ENCODERS = ("tasb", "contriever", "ance")
QUERY_SETS = ("dl19", "dl20", "dlhard", "devsmall", "covid")
CUTOFFS = (0.25, 0.50, 0.75)
METRICS = ("AP", "MRR@10", "nDCG@10")

# benchmark scale (paper: 8.8M docs, d=768; here the reference's CPU-sized
# corpus at the same d and protocol)
N_DOCS = 20000
DIM = 768

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "benchmarks"


def retrieve(D: torch.Tensor, Q: torch.Tensor, k: int = 1000) -> dict:
    _, ids = DenseIndex.build(D).search(Q, k=min(k, D.shape[0]))
    ids = ids.cpu().numpy()
    return {i: ids[i].tolist() for i in range(ids.shape[0])}


def eval_system(D: torch.Tensor, queries: dict, qrels: dict, pruner=None) -> dict:
    """Per-query metric vectors for one system over all query sets; ``D``
    and the pruner's state live on the device the system runs on."""
    out = {}
    Dx = pruner.prune_index(D) if pruner else D
    for qs, Q in queries.items():
        Qt = as_tensor(Q, D.device)
        Qx = pruner.transform_queries(Qt) if pruner else Qt
        out[qs] = evaluate_run(retrieve(Dx, Qx), qrels[qs], metrics=METRICS)
    return out


def fmt_cell(val: float, sig: bool) -> str:
    return f"{val:.4f}{'†' if sig else ' '}"


def emit_table(emit, title: str, rows: dict) -> None:
    """Tables 1 and 2: one row per cutoff (and the baseline) of per-set
    metric means, † where the paired Wilcoxon test vs the baseline is
    significant."""
    base = rows["baseline"]
    emit(f"\n### {title}")
    emit("| c (%) | " + " | ".join(
        f"{qs}:{m}" for qs in QUERY_SETS for m in METRICS) + " |")
    emit("|" + "---|" * (len(QUERY_SETS) * len(METRICS) + 1))
    for label, row in rows.items():
        cells = []
        for qs in QUERY_SETS:
            for m in METRICS:
                v = float(row[qs][m].mean())
                if label == "baseline":
                    cells.append(f"{v:.4f} ")
                else:
                    sig, _ = wilcoxon_significant(base[qs][m], row[qs][m])
                    cells.append(fmt_cell(v, sig))
        name = "-" if label == "baseline" else f"{int(label*100)}"
        emit(f"| {name} | " + " | ".join(cells) + " |")


def load_all_datasets(n_docs: int = N_DOCS, d: int = DIM, seed: int = 0) -> dict:
    return {enc: make_dataset(enc, n_docs=n_docs, d=d, seed=seed,
                              query_sets=QUERY_SETS)
            for enc in ENCODERS}


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def main(name: str, run, argv: list[str] | None = None, *,
         datasets: bool = True) -> dict:
    """Parse the common command line, run ``run(datasets, device=...)`` (or
    ``run(device=..., n_docs=..., dim=...)`` when the driver builds its own
    data) and write the results as JSON."""
    ap = argparse.ArgumentParser(prog=f"python -m repro_torch.benchmarks.{name}")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: cuda; raises when there "
                         "is no CUDA device)")
    ap.add_argument("--out", default=None,
                    help=f"JSON results path (default: {OUT_DIR}/{name}.json)")
    ap.add_argument("--n-docs", type=int, default=None,
                    help="corpus rows (default: the driver's own)")
    ap.add_argument("--dim", type=int, default=None,
                    help="embedding width (default: the driver's own)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    size = {k: v for k, v in (("n_docs", args.n_docs), ("dim", args.dim))
            if v is not None}
    if datasets:
        size = {"n_docs": N_DOCS, "dim": DIM, **size}
        results = run(load_all_datasets(size["n_docs"], size["dim"]), device=device)
    else:
        results = run(device=device, **size)
    out = pathlib.Path(args.out) if args.out else OUT_DIR / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(_jsonable(dict(device=str(device), **size,
                                             results=results)), indent=1) + "\n")
    print(f"# wrote {out}")
    return results
