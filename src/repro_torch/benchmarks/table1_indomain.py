"""Table 1 — In-domain PCA pruning at cutoffs {25, 50, 75}% (port of
``benchmarks/table1_indomain.py``).

Three encoder spectra × five query sets × {AP, MRR@10, nDCG@10}, with a
two-tailed paired Wilcoxon signed-rank test vs the unpruned baseline
(† = significant at α=0.05), exactly the paper's protocol. PCA is fit on
the in-domain corpus.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import CUTOFFS, emit_table, eval_system, load_all_datasets, main
from repro_torch.core.pruning import StaticPruner
from repro_torch.util import default_device


def run(datasets=None, emit=print, device=None) -> dict:
    dev = default_device(device)
    datasets = datasets or load_all_datasets()
    results = {}
    for enc, ds in datasets.items():
        D = torch.as_tensor(ds.docs, device=dev)
        rows = {"baseline": eval_system(D, ds.queries, ds.qrels)}
        for c in CUTOFFS:
            pruner = StaticPruner(cutoff=c).fit(D)
            rows[c] = eval_system(D, ds.queries, ds.qrels, pruner)
        results[enc] = rows
        emit_table(emit, f"Table 1 — {enc} (in-domain PCA)", rows)
    return results


if __name__ == "__main__":
    main("table1_indomain", run)
