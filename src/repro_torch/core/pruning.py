"""StaticPruner: the paper's offline pipeline as one object (port of
``repro/core/pruning.py`` without the mesh and store paths).

    pruner = StaticPruner(cutoff=0.5).fit(D)     # keep m = d/2 dims
    index = pruner.build_index(D)                # D̂ = D W_m
    q_hat = pruner.transform_queries(q)          # q̂ = W_mᵀ q,  O(dm)
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.core import pca as _pca
from repro_torch.core.index import DenseIndex
from repro_torch.util import as_tensor


@dataclasses.dataclass
class StaticPruner:
    """PCA-based static dimension pruning (query-independent, offline).

    Exactly one of ``cutoff`` / ``m`` / ``variance_target`` picks the kept
    dimensionality; ``center=False`` reproduces the paper's uncentered
    Gram eigendecomposition.
    """

    cutoff: float | None = None
    m: int | None = None
    variance_target: float | None = None
    center: bool = False
    state: _pca.PCAState | None = None

    def __post_init__(self):
        picked = sum(x is not None for x in (self.cutoff, self.m, self.variance_target))
        if picked != 1:
            raise ValueError("specify exactly one of cutoff / m / variance_target")

    # -- fit ---------------------------------------------------------------
    def fit(self, D) -> "StaticPruner":
        self.state = _pca.fit_pca(D, center=self.center)
        return self

    def fit_streaming(self, batches: Iterable, *, device=None) -> "StaticPruner":
        self.state = _pca.fit_pca_streaming(batches, center=self.center,
                                            device=device)
        return self

    # -- dimensionality ------------------------------------------------------
    @property
    def kept_dims(self) -> int:
        if self.state is None:
            raise RuntimeError("fit() before querying kept_dims")
        d = self.state.d
        if self.m is not None:
            return min(self.m, d)
        if self.cutoff is not None:
            return _pca.m_from_cutoff(d, self.cutoff)
        return _pca.m_for_variance(self.state, self.variance_target)

    @property
    def effective_cutoff(self) -> float:
        return _pca.cutoff_from_m(self.state.d, self.kept_dims)

    # -- offline application -------------------------------------------------
    def prune_index(self, D, *, block_rows: int = 262144) -> torch.Tensor:
        """D̂ = D·W_m, computed in row blocks written into one output."""
        self._check_fit()
        D = as_tensor(D)
        m = self.kept_dims
        n = D.shape[0]
        if n <= block_rows:
            return _pca.transform(D, self.state, m)
        out = torch.empty((n, m), dtype=D.dtype, device=D.device)
        for i in range(0, n, block_rows):
            out[i:i + block_rows] = _pca.transform(D[i:i + block_rows],
                                                   self.state, m)
        return out

    def build_index(self, D, *, quantize_int8: bool = False) -> DenseIndex:
        """One-stop offline artefact: pruned (optionally int8) search index."""
        return DenseIndex.build(self.prune_index(D), quantize_int8=quantize_int8)

    # -- online application ----------------------------------------------------
    def transform_queries(self, q) -> torch.Tensor:
        """q̂ = W_mᵀq — the only per-query cost the method adds: O(dm)."""
        self._check_fit()
        q = as_tensor(q, self.state.components.device)
        return _pca.transform_query(q, self.state, self.kept_dims)

    def projection(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(W_m, mean-or-None)`` for ``DenseIndex.search_projected``."""
        self._check_fit()
        return _pca.projection_operands(self.state, self.kept_dims)

    # -- persistence ------------------------------------------------------------
    def save(self, path: str) -> None:
        self._check_fit()
        _pca.save_pca(path, self.state)

    @classmethod
    def load(cls, path: str, *, cutoff: float | None = None, m: int | None = None,
             variance_target: float | None = None, device=None) -> "StaticPruner":
        if cutoff is None and m is None and variance_target is None:
            cutoff = 0.5
        state = _pca.load_pca(path, device=device)
        obj = cls(cutoff=cutoff, m=m, variance_target=variance_target,
                  center=state.centered)
        obj.state = state
        return obj

    def _check_fit(self):
        if self.state is None:
            raise RuntimeError("StaticPruner is not fitted; call fit() first")
