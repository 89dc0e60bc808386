"""Quickstart: PCA static pruning in ~30 lines (paper §2, end to end); the
port of ``examples/quickstart.py``.

A 10,000 × 768 ``tasb`` corpus, a pruner fitted on it keeping half the dims
(the fit's Gram on the ``gram`` kernel), the pruned index built and searched
with the dl19 queries (``pca_project`` and the top-k kernel), then nDCG@10,
MRR@10 and AP against the unpruned index.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.quickstart        # on the card
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.index import DenseIndex
from repro_torch.core.metrics import evaluate_run, mean_metrics
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import RetrievalDataset, make_dataset
from repro_torch.util import default_device

METRICS = ("nDCG@10", "MRR@10", "AP")


def run_ids(ids: torch.Tensor) -> dict:
    """A run (query index -> ranked doc ids) from a (B, k) id tensor."""
    rows = ids.cpu().numpy()
    return {i: rows[i].tolist() for i in range(rows.shape[0])}


def quickstart(ds: RetrievalDataset, query_set: str = "dl19", *, cutoff: float = 0.5,
               k: int = 10, device="cuda") -> dict:
    """Fit, prune, build, search and score as the reference script does,
    printing its lines; returns ``{"baseline": …, "pruned": …}`` mean
    metrics."""
    dev = default_device(device)
    # 1. a corpus of document embeddings (stand-in for an encoded MS MARCO)
    D = torch.as_tensor(ds.docs, device=dev)
    Q = torch.as_tensor(ds.queries[query_set], device=dev)
    qrels = ds.qrels[query_set]

    # 2. OFFLINE: fit PCA on the index, keep a share of the dims, build the pruned index
    pruner = StaticPruner(cutoff=cutoff).fit(D)          # D^T D = W Λ W^T
    index = DenseIndex.build(pruner.prune_index(D))      # D̂ = D W_m
    print(f"index: {D.shape[1]} -> {pruner.kept_dims} dims, "
          f"{D.numel() * D.element_size()/2**20:.1f} -> {index.nbytes/2**20:.1f} MiB")

    # 3. ONLINE: transform queries (O(dm)) and search the pruned index (O(mn))
    q_hat = pruner.transform_queries(Q)                  # q̂ = W_m^T q
    _, ids = index.search(q_hat, k=k)

    # 4. effectiveness vs the unpruned baseline
    pruned = mean_metrics(evaluate_run(run_ids(ids), qrels))
    _, ids0 = DenseIndex.build(D).search(Q, k=k)
    base = mean_metrics(evaluate_run(run_ids(ids0), qrels))
    for m in METRICS:
        delta = 100 * (pruned[m] - base[m]) / max(base[m], 1e-9)
        print(f"{m:8s} baseline {base[m]:.4f} | {round(cutoff * 100)}%-pruned "
              f"{pruned[m]:.4f} ({delta:+.1f}%)")
    return {"baseline": base, "pruned": pruned}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    default_device(args.device)          # no card: raise before building the data
    ds = make_dataset("tasb", n_docs=10000, d=768, query_sets=("dl19",))
    return quickstart(ds, device=args.device)


if __name__ == "__main__":
    main()
