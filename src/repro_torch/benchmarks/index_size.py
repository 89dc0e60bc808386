"""Index space-occupancy table: O(mn + md) vs O(dn) (paper §2; port of
``benchmarks/index_size.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import main
from repro_torch.core.index import DenseIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.util import default_device

N_DOCS = 50_000
DIM = 768


def run(emit=print, device=None, n_docs: int = N_DOCS, dim: int = DIM) -> dict:
    dev = default_device(device)
    rng = np.random.default_rng(0)
    D = torch.as_tensor(rng.standard_normal((n_docs, dim)), dtype=torch.float32,
                        device=dev)
    full = DenseIndex.build(D)
    emit(f"index_full,0,bytes={full.nbytes} dims={dim}")
    out = {"full": full.nbytes}
    for c in (0.25, 0.5, 0.75):
        pr = StaticPruner(cutoff=c).fit(D)
        m = pr.kept_dims
        idx = DenseIndex.build(pr.prune_index(D))
        w_bytes = m * dim * 4     # W_m transform matrix (O(md))
        total = idx.nbytes + w_bytes
        emit(f"index_pca_c{int(c*100)},0,bytes={total} "
             f"ratio={total/full.nbytes:.3f} predicted={m/dim:.3f}")
        out[c] = total
        idx8 = pr.build_index(D, quantize_int8=True)
        emit(f"index_pca_c{int(c*100)}_int8,0,bytes={idx8.nbytes + w_bytes} "
             f"ratio={(idx8.nbytes + w_bytes)/full.nbytes:.3f}")
        out[f"{c}_int8"] = idx8.nbytes + w_bytes
    return out


if __name__ == "__main__":
    main("index_size", run, datasets=False)
