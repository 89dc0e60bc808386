"""StaticPruner: the paper's offline pipeline as one object (port of
``repro/core/pruning.py``).

    pruner = StaticPruner(cutoff=0.5).fit(D)     # keep m = d/2 dims
    index = pruner.build_index(D)                # D̂ = D W_m
    index = pruner.build_index(D, mesh=mesh)     # ... laid over a DeviceMesh
    q_hat = pruner.transform_queries(q)          # q̂ = W_mᵀ q,  O(dm)
    store = pruner.build_index_to(path, blocks)  # streaming build to disk
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import pca as _pca
from repro_torch.core.index import DenseIndex, ShardedDenseIndex
from repro_torch.core.quantization import quantize_rows, scale_from_absmax
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

    def fit_distributed(self, D, mesh) -> "StaticPruner":
        """Fit on a matrix laid over ``mesh`` (one strip Gram per slot)."""
        self.state = _pca.fit_pca_distributed(D, mesh, center=self.center)
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

    def build_index(self, D, *, quantize_int8: bool = False, mesh=None
                    ) -> DenseIndex | ShardedDenseIndex:
        """One-stop offline artefact: pruned (optionally int8) search index,
        sharded over ``mesh`` when one is given."""
        pruned = self.prune_index(D)
        if mesh is not None:
            return ShardedDenseIndex.build(pruned, mesh, quantize_int8=quantize_int8)
        return DenseIndex.build(pruned, quantize_int8=quantize_int8)

    def build_index_to(self, path: str, corpus_batches, *,
                       quantize_int8: bool = False,
                       dtype: torch.dtype | None = None,
                       meta: dict | None = None,
                       already_projected: bool = False, device=None):
        """Streaming offline build: fit + prune + (quantize) straight to disk.

        ``corpus_batches`` is the corpus as row blocks (numpy arrays, CPU or
        CUDA tensors): a list/tuple of blocks or a zero-argument callable
        returning a fresh iterator, since the build reads the corpus up to
        three times (Gram fit if not yet fitted, one combined
        project/absmax/write pass, a bounded re-read). A one-shot generator
        is rejected loudly. An unfitted pruner fits with ``fit_streaming``
        (numpy blocks go to ``device``, default the card); the projection
        then runs on the pruner's device through ``pca.transform``.

        ``already_projected=True`` declares the blocks are already in the
        pruned m-dim space (f32): fit and projection are skipped and only
        the absmax/quantise/write machinery runs. That is the store-backed
        compaction path (``IndexUpdater.compact``).

        ``quantize_int8``: each projected block is quantised on the
        pruner's device under the *provisional running* per-dim scale (its
        own absmax included, so the spill never clips), and only the int8
        block crosses to the host, into a spill next to ``path``. Blocks
        spilled after the scale stopped growing are already exact under
        the final corpus-wide scale; blocks spilled before a later block
        widened it are re-projected in ONE bounded re-read pass. The
        artifact equals quantising exact f32 projections under the final
        scale (f32 divide, round half to even, clip ±127), byte for byte;
        ``meta`` records ``spill_bytes``, ``spill_dtype`` and
        ``requant_blocks``.

        Host memory is O(block): neither the corpus nor the pruned index is
        ever whole on the host. Returns the committed ``IndexStore``.
        """
        from repro_torch.core.store import IndexStore

        def passes():
            if callable(corpus_batches):
                return iter(corpus_batches())
            if isinstance(corpus_batches, (list, tuple)):
                return iter(corpus_batches)
            raise TypeError(
                "corpus_batches must be a list/tuple of row blocks or a "
                "zero-arg callable returning a fresh iterator: the streaming "
                "build reads the corpus in multiple passes")

        if self.state is None:
            if already_projected:
                raise RuntimeError("already_projected=True requires a "
                                   "fitted pruner (the blocks carry no "
                                   "d-dim information to fit from)")
            self.fit_streaming(passes(), device=device)
        m = self.kept_dims
        dev = self.state.components.device

        def project(b) -> torch.Tensor:
            b = as_tensor(b, dev)
            if already_projected:
                if b.ndim != 2 or b.shape[1] != m:
                    raise ValueError(f"already_projected blocks must be "
                                     f"(rows, {m}), got {tuple(b.shape)}")
                return b.float()
            return _pca.transform(b, self.state, m).float()

        def quantize(p: torch.Tensor, scale: torch.Tensor) -> np.ndarray:
            return quantize_rows(p, scale).cpu().numpy()

        spill_stats = {}
        writer = IndexStore.create(path)
        with writer:
            writer.put_pca(self.state)
            if quantize_int8:
                # the spill lives NEXT TO the target store, not in the
                # system temp dir: /tmp is often RAM-backed, which would
                # turn the O(n·m) spill back into host memory
                spill = tempfile.mkdtemp(
                    prefix="idxbuild_spill_",
                    dir=os.path.dirname(os.path.abspath(path)) or ".")
                try:
                    absmax = torch.zeros((m,), dtype=torch.float32, device=dev)
                    files: list[str] = []
                    scales: list[torch.Tensor] = []
                    spill_bytes = 0
                    for b in passes():
                        p = project(b)
                        absmax = torch.maximum(absmax, p.abs().amax(0))
                        s_prov = scale_from_absmax(absmax)
                        q = quantize(p, s_prov)
                        f = os.path.join(spill, f"{len(files):06d}.npy")
                        np.save(f, q)
                        spill_bytes += q.nbytes
                        files.append(f)
                        scales.append(s_prov)
                    scale = scale_from_absmax(absmax)
                    writer.set_scale(scale)
                    stale = {i for i, s in enumerate(scales)
                             if not torch.equal(s, scale)}
                    if stale:
                        # bounded re-read: advance block by block,
                        # re-projecting ONLY the stale ones and overwriting
                        # their spill under the final scale
                        seen = 0
                        for i, b in enumerate(passes()):
                            if i in stale:
                                np.save(files[i], quantize(project(b), scale))
                                seen += 1
                                if seen == len(stale):
                                    break
                        if seen != len(stale):
                            raise RuntimeError(
                                f"corpus iterator yielded fewer blocks on "
                                f"the re-read pass ({seen}/{len(stale)} "
                                f"stale blocks revisited)")
                    for f in files:
                        writer.append(np.load(f, mmap_mode="r"))
                        os.remove(f)
                    spill_stats = dict(spill_bytes=int(spill_bytes),
                                       spill_dtype="int8",
                                       requant_blocks=int(len(stale)))
                finally:
                    shutil.rmtree(spill, ignore_errors=True)
            else:
                for b in passes():
                    p = project(b)
                    writer.append(p if dtype is None else p.to(dtype))
            info = dict(kept_dims=int(m), source_dim=int(self.state.d),
                        cutoff=float(self.effective_cutoff),
                        centered=bool(self.state.centered),
                        quantize_int8=bool(quantize_int8), **spill_stats)
            info.update(meta or {})
            return writer.commit(meta=info)

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
