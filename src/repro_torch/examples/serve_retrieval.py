"""Serve a PCA-pruned index with batched concurrent requests; the port of
``examples/serve_retrieval.py``.

The public API from offline artefacts to clients: a 20,000 × 512 ``ance``
corpus fitted and pruned to half its dims, a ``RetrievalServer`` over the
pruned index (k 10, batches of up to 16; each batch is one fused projection
and top-k, ``search_projected``), then 8 client threads sending 25 dl19
queries each, and the throughput and latency percentiles they saw.

  PYTHONPATH=src python -m repro_torch.examples.serve_retrieval --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_retrieval   # on the card
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core.index import DenseIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import RetrievalDataset, make_dataset
from repro_torch.launch.serve import RetrievalServer
from repro_torch.util import default_device


def serve_retrieval(ds: RetrievalDataset, query_set: str = "dl19", *, cutoff: float = 0.5,
                    k: int = 10, max_batch: int = 16, clients: int = 8,
                    per_client: int = 25, device="cuda") -> dict:
    """Build, serve and drive as the reference script does, printing its
    lines. Returns the index, the pruner, the wall seconds, each latency
    and every reply as (query row, scores, ids)."""
    dev = default_device(device)
    D = torch.as_tensor(ds.docs, device=dev)
    pruner = StaticPruner(cutoff=cutoff).fit(D)
    index = DenseIndex.build(pruner.prune_index(D))
    print(f"serving {index.n} docs at {index.dim} dims "
          f"({index.nbytes/2**20:.1f} MiB)")

    server = RetrievalServer(index, pruner, k=k, max_batch=max_batch)
    queries = ds.queries[query_set]
    lat: list[float] = []
    replies: list = []
    lock = threading.Lock()

    def client(worker: int, n: int):
        rng = np.random.default_rng(worker)
        for _ in range(n):
            row = int(rng.integers(0, len(queries)))
            t0 = time.time()
            scores, ids = server.query(queries[row])
            with lock:
                lat.append(time.time() - t0)
                replies.append((row, scores, ids))

    threads = [threading.Thread(target=client, args=(w, per_client)) for w in range(clients)]
    t0 = time.time()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
    finally:
        server.close()

    ms = np.array(lat) * 1e3
    print(f"{len(lat)} queries from {clients} concurrent clients in {wall:.2f}s "
          f"({len(lat)/wall:.0f} qps)")
    print(f"latency p50={np.percentile(ms, 50):.1f}ms "
          f"p95={np.percentile(ms, 95):.1f}ms p99={np.percentile(ms, 99):.1f}ms")
    return dict(index=index, pruner=pruner, wall=wall, latencies_ms=ms, replies=replies)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    default_device(args.device)          # no card: raise before building the data
    ds = make_dataset("ance", n_docs=20000, d=512, query_sets=("dl19",))
    return serve_retrieval(ds, device=args.device)


if __name__ == "__main__":
    main()
