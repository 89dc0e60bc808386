"""Table 2 — Out-of-domain PCA: W_m fit on a different corpus of the same
encoder (paper RQ2; port of ``benchmarks/table2_ood.py``)."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import CUTOFFS, emit_table, eval_system, load_all_datasets, main
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import make_ood_corpus
from repro_torch.util import default_device


def run(datasets=None, emit=print, device=None) -> dict:
    dev = default_device(device)
    datasets = datasets or load_all_datasets()
    results = {}
    for enc, ds in datasets.items():
        D = torch.as_tensor(ds.docs, device=dev)
        n, d = ds.docs.shape
        ood = torch.as_tensor(make_ood_corpus(enc, n_docs=n, d=d), device=dev)
        rows = {"baseline": eval_system(D, ds.queries, ds.qrels)}
        for c in CUTOFFS:
            pruner = StaticPruner(cutoff=c).fit(ood)   # fit OUT of domain
            rows[c] = eval_system(D, ds.queries, ds.qrels, pruner)
        results[enc] = rows
        emit_table(emit, f"Table 2 — {enc} (out-of-domain PCA)", rows)
    return results


if __name__ == "__main__":
    main("table2_ood", run)
