"""Out-of-domain PCA transfer (paper RQ2): fit W_m on corpus A, prune
corpus B; the port of ``examples/ood_transfer.py``.

A 15,000 × 768 ``tasb`` corpus with its covid queries, and a source corpus
of the same encoder from another domain (``make_ood_corpus``). At cutoffs
25, 50 and 75 % a pruner fitted in domain and one fitted on the source
prune the target; nDCG@10 at k 100 of each against the unpruned baseline,
† where a paired Wilcoxon test finds the change significant (α = 0.05).

  PYTHONPATH=src python -m repro_torch.examples.ood_transfer --device cpu
  PYTHONPATH=src python -m repro_torch.examples.ood_transfer      # on the card
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.index import DenseIndex
from repro_torch.core.metrics import evaluate_run, wilcoxon_significant
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import RetrievalDataset, make_dataset, make_ood_corpus
from repro_torch.examples.quickstart import run_ids
from repro_torch.util import default_device

CUTOFFS = (0.25, 0.5, 0.75)


def ood_transfer(ds: RetrievalDataset, source: np.ndarray, query_set: str = "covid", *,
                 cutoffs=CUTOFFS, k: int = 100, device="cuda") -> dict:
    """The reference script's loop, printing its lines; returns the
    baseline's per-query nDCG@10 and, per cutoff, the in- and out-of-domain
    ones with their significance."""
    dev = default_device(device)
    D = torch.as_tensor(ds.docs, device=dev)
    Q = torch.as_tensor(ds.queries[query_set], device=dev)
    qrels = ds.qrels[query_set]
    S = torch.as_tensor(source, device=dev)

    def ndcg(D_, Q_):
        _, ids = DenseIndex.build(D_).search(Q_, k=k)
        return evaluate_run(run_ids(ids), qrels)

    base = ndcg(D, Q)
    print(f"baseline          nDCG@10 = {base['nDCG@10'].mean():.4f}")
    out = {"baseline": base["nDCG@10"]}
    for c in cutoffs:
        in_dom = StaticPruner(cutoff=c).fit(D)
        out_dom = StaticPruner(cutoff=c).fit(S)
        r_in = ndcg(in_dom.prune_index(D), in_dom.transform_queries(Q))
        r_out = ndcg(out_dom.prune_index(D), out_dom.transform_queries(Q))
        sig_in, _ = wilcoxon_significant(base["nDCG@10"], r_in["nDCG@10"])
        sig_out, _ = wilcoxon_significant(base["nDCG@10"], r_out["nDCG@10"])
        print(f"cutoff {int(c*100)}%:  in-domain {r_in['nDCG@10'].mean():.4f}"
              f"{'†' if sig_in else ' '}   out-of-domain "
              f"{r_out['nDCG@10'].mean():.4f}{'†' if sig_out else ' '}")
        out[c] = dict(in_domain=r_in["nDCG@10"], out_of_domain=r_out["nDCG@10"],
                      sig_in=bool(sig_in), sig_out=bool(sig_out))
    print("† = significant change vs baseline (paired Wilcoxon, α=0.05)")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    default_device(args.device)          # no card: raise before building the data
    # target corpus + its queries (think: BEIR TREC-COVID)
    ds = make_dataset("tasb", n_docs=15000, d=768, query_sets=("covid",))
    # source corpus the transform is learned on (think: MS MARCO)
    source = make_ood_corpus("tasb", n_docs=15000, d=768)
    return ood_transfer(ds, source, device=args.device)


if __name__ == "__main__":
    main()
