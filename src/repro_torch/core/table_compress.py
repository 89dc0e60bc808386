"""PCA compression of recsys embedding-table columns (port of
``repro/core/table_compress.py``).

The paper prunes document-embedding dimensions. The same offline rotation
applies to the *item side* of recommender models: an embedding table
``T ∈ R^{V×E}`` is itself an embedding index, so ``T̂ = T·W_m`` shrinks
serving memory by m/E while any dot-product consumer transforms its other
operand once (`q̂ = W_mᵀq`). On the card the fit is the ``gram`` kernel and
each table's prune the ``pca_project`` kernel (``StaticPruner``).
"""
from __future__ import annotations

import torch

from repro_torch.core.pruning import StaticPruner
from repro_torch.util import as_tensor


def compress_tables(tables: list, *, cutoff: float = 0.5, fit_rows: int = 100_000
                    ) -> tuple[list[torch.Tensor], StaticPruner]:
    """Fit one shared PCA over all tables' rows, prune every table.

    Tables share an embedding dim E; a single rotation keeps downstream
    dot products consistent across fields. The fit's sample is each
    table's first ``fit_rows / len(tables)`` rows (at least one, at most
    the table), concatenated. Returns (pruned tables, pruner).
    """
    tables = [as_tensor(t) for t in tables]
    sample = torch.cat(
        [t[: max(1, min(fit_rows // len(tables), t.shape[0]))] for t in tables], dim=0)
    pruner = StaticPruner(cutoff=cutoff).fit(sample)
    return [pruner.prune_index(t) for t in tables], pruner


def compressed_table_bytes(tables: list, cutoff: float = 0.5) -> dict:
    tables = [as_tensor(t) for t in tables]
    full = sum(t.numel() * t.element_size() for t in tables)
    pruned, pruner = compress_tables(tables, cutoff=cutoff)
    comp = sum(t.numel() * t.element_size() for t in pruned)
    return {"full_bytes": full, "pruned_bytes": comp,
            "ratio": comp / full, "kept_dims": pruner.kept_dims}
