"""Fig 1 — effectiveness on DL19 vs pruning cutoff (fine sweep, 3 encoders;
port of ``benchmarks/fig1_cutoff.py``)."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import METRICS, eval_system, load_all_datasets, main
from repro_torch.core.metrics import wilcoxon_significant
from repro_torch.core.pruning import StaticPruner
from repro_torch.util import default_device

CUTOFF_SWEEP = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def run(datasets=None, emit=print, device=None) -> dict:
    dev = default_device(device)
    datasets = datasets or load_all_datasets()
    results = {}
    emit("\n### Fig 1 — DL19 effectiveness vs cutoff "
         "(* = significant vs baseline)")
    emit("| encoder | metric | base | " +
         " | ".join(f"c={int(c*100)}%" for c in CUTOFF_SWEEP) + " |")
    emit("|" + "---|" * (len(CUTOFF_SWEEP) + 3))
    for enc, ds in datasets.items():
        D = torch.as_tensor(ds.docs, device=dev)
        queries = {"dl19": ds.queries["dl19"]}
        qrels = {"dl19": ds.qrels["dl19"]}
        base = eval_system(D, queries, qrels)
        curve = {}
        for c in CUTOFF_SWEEP:
            pruner = StaticPruner(cutoff=c).fit(D)
            curve[c] = eval_system(D, queries, qrels, pruner)
        results[enc] = {"base": base, "curve": curve}
        for m in METRICS:
            cells = []
            for c in CUTOFF_SWEEP:
                v = float(curve[c]["dl19"][m].mean())
                sig, _ = wilcoxon_significant(base["dl19"][m], curve[c]["dl19"][m])
                cells.append(f"{v:.4f}{'*' if sig else ' '}")
            emit(f"| {enc} | {m} | {float(base['dl19'][m].mean()):.4f} | "
                 + " | ".join(cells) + " |")
    return results


if __name__ == "__main__":
    main("fig1_cutoff", run)
