"""Fig 2 — nDCG@10 on DL19 vs number of embeddings used to fit PCA (port of
``benchmarks/fig2_nembed.py``).

Paper RQ3: decompositions from 10^3 / 10^4 / 10^5 documents are
near-indistinguishable. Scaled to the benchmark corpus: {10^3, 10^4, all}.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import eval_system, load_all_datasets, main
from repro_torch.core.metrics import wilcoxon_significant
from repro_torch.core.pruning import StaticPruner
from repro_torch.util import default_device

FIT_SIZES = (1_000, 10_000, None)     # None = full corpus
CUTOFFS = (0.25, 0.5, 0.75)


def run(datasets=None, emit=print, device=None) -> dict:
    dev = default_device(device)
    datasets = datasets or load_all_datasets()
    results = {}
    emit("\n### Fig 2 — nDCG@10 (DL19) vs #embeddings used for PCA fit")
    emit("| encoder | fit size | " +
         " | ".join(f"c={int(c*100)}%" for c in CUTOFFS) + " |")
    emit("|" + "---|" * (len(CUTOFFS) + 2))
    for enc, ds in datasets.items():
        D = torch.as_tensor(ds.docs, device=dev)
        queries = {"dl19": ds.queries["dl19"]}
        qrels = {"dl19": ds.qrels["dl19"]}
        base = eval_system(D, queries, qrels)
        per_enc = {}
        for n_fit in FIT_SIZES:
            Dfit = D if n_fit is None else D[:n_fit]
            row = {}
            cells = []
            for c in CUTOFFS:
                pruner = StaticPruner(cutoff=c).fit(Dfit)
                r = eval_system(D, queries, qrels, pruner)
                row[c] = r
                v = float(r["dl19"]["nDCG@10"].mean())
                sig, _ = wilcoxon_significant(base["dl19"]["nDCG@10"],
                                              r["dl19"]["nDCG@10"])
                cells.append(f"{v:.4f}{'*' if sig else ' '}")
            label = "all" if n_fit is None else f"{n_fit}"
            emit(f"| {enc} | {label} | " + " | ".join(cells) + " |")
            per_enc[label] = row
        results[enc] = per_enc
    return results


if __name__ == "__main__":
    main("fig2_nembed", run)
