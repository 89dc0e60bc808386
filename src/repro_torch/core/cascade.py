"""Cascade retrieval: a coarse scan at m_coarse, then an exact rescore of
the shortlist at full m (port of ``repro/core/cascade.py``).

  1. **coarse scan**: the first pass scans an aggressively pruned index
     (the first ``m_coarse`` PCA dims, int8 by default) for the top-(N·k)
     per query. PCA dims nest, so the coarse matrix is the full pruned
     matrix's leading columns re-quantised with their own scale, and the
     coarse query is a column slice of the one projected query.
  2. **shortlist rescore**: the per-query shortlists are flattened into one
     batch-shared shortlist (sorted ascending, duplicates set to -1), the
     U = B·N·k full-resolution rows are gathered in their storage dtype,
     and ``ops.topk_score`` in its ``row_ids`` mode scores them exactly
     and takes the final top-k.

The rescore goes through the same top-k kernel as the full search, whose
sum order for a score does not depend on where the row sits, so on the
card a shortlist that covers the corpus (N·k >= n) makes the cascade
bitwise equal to the full-m ``search_projected``. The reference rescores
its segmented and paged sides with a matmul and a max-combine; here each
index's own ``rescore`` makes each part (a segment; an extent of an int8
paged index, or all of a float one) one ``row_ids`` call with the uids outside it set to -1, and the parts merge
with ``merge_segment_topk``. Each live uid lies in exactly one part and the
parts come in ascending id order, so the merge equals the reference's
max-combine and top-k, ties included (lowest id first).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.index import (
    DenseIndex,
    SegmentedIndex,
    _open_store,
    _project_nofold,
    rehydrate_delta,
)
from repro_torch.core.paged import PagedIndex
from repro_torch.core.store import IndexStoreError
from repro_torch.util import as_tensor


def _shortlist(cids: torch.Tensor) -> torch.Tensor:
    """Batch-shared shortlist from (B, nk) coarse top ids: flattened,
    sorted ascending (so -1 pads lead and ties resolve to the lowest doc
    id), duplicates set to -1, so each doc is scored once per batch."""
    flat = torch.sort(cids.reshape(-1)).values
    dup = torch.zeros_like(flat, dtype=torch.bool)
    dup[1:] = flat[1:] == flat[:-1]
    return torch.where(dup, torch.full_like(flat, -1), flat)


def _coarse_rows(full: DenseIndex, m: int) -> torch.Tensor:
    """Dequantised f32 leading ``m`` columns of an existing index (exact
    for f32 storage, the reconstruction for int8), on its device."""
    v = full.vectors[:, :m].float()
    if full.scale is not None:
        v = v * full.scale[None, :m]
    return v


@dataclasses.dataclass(frozen=True)
class CascadeIndex:
    """Two-resolution cascade over one corpus: coarse scan, exact rescore.

    ``coarse`` holds the first ``m_coarse`` PCA dims (int8 by default),
    ``full`` the complete pruned representation; both index the same rows
    in the same order (validated), so a shortlist id from the first pass
    addresses the rescore row directly. ``n_factor`` sets the shortlist
    depth: the coarse pass keeps N·k candidates per query.

    Copy-on-write like the indexes under it: ``append`` returns a new
    ``CascadeIndex`` with both resolutions grown, so a server's
    ``swap_index`` installs a consistent pair at once.
    """

    coarse: DenseIndex | SegmentedIndex | PagedIndex
    full: DenseIndex | SegmentedIndex | PagedIndex
    n_factor: int = 8

    def __post_init__(self):
        if self.coarse.n != self.full.n:
            raise ValueError(
                f"cascade resolutions disagree on row count: coarse has "
                f"{self.coarse.n} rows, full has {self.full.n}")
        if not 0 < self.coarse.dim < self.full.dim:
            raise ValueError(
                f"coarse m={self.coarse.dim} does not nest inside full "
                f"m={self.full.dim} (need 0 < m_coarse < m)")
        if self.n_factor < 1:
            raise ValueError(f"n_factor must be >= 1, got {self.n_factor}")

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, pruned, *, m_coarse: int, n_factor: int = 8,
              quantize_int8: bool = False, coarse_int8: bool = True,
              device=None) -> "CascadeIndex":
        """Build both resolutions from one (n, m) pruned f32 matrix (on its
        own device if it is a tensor, else on ``device``, default the
        card). The coarse index is its leading ``m_coarse`` columns with
        their own per-dim scale (``coarse_int8``); ``quantize_int8``
        sets the full resolution's storage."""
        v = as_tensor(pruned, device)
        full = DenseIndex.build(v, quantize_int8=quantize_int8)
        coarse = DenseIndex.build(v[:, :m_coarse], quantize_int8=coarse_int8)
        return cls(coarse=coarse, full=full, n_factor=n_factor)

    @classmethod
    def from_index(cls, full: DenseIndex, *, m_coarse: int,
                   n_factor: int = 8, coarse_int8: bool = True
                   ) -> "CascadeIndex":
        """Derive the coarse resolution from an existing full index through
        its dequantised rows (exact for f32 storage, the reconstruction for
        int8), requantised with a scale of its own."""
        coarse = DenseIndex.build(_coarse_rows(full, m_coarse),
                                  quantize_int8=coarse_int8)
        return cls(coarse=coarse, full=full, n_factor=n_factor)

    @classmethod
    def load(cls, store, *, m_coarse: int | None = None, n_factor: int = 8,
             segmented: bool = False, paged: bool = False,
             page_rows: int | None = None, pool_pages: int | None = None,
             delta_capacity: int = 4096, device=None) -> "CascadeIndex":
        """Load a multi-resolution artifact onto ``device`` (default: the
        card): the main segments become the full resolution, the
        ``m_coarse`` resolution entry the coarse one (``None`` picks the
        widest stored resolution).

        A segmented load rehydrates the coarse deltas from the
        resolution's persisted delta segments when they mirror the main
        deltas row for row (the exact bytes and scales that were serving).
        Otherwise (an artifact without them, or main deltas grown past
        them) it re-derives the coarse deltas from the full deltas'
        dequantised rows, so the pair stays row-aligned. ``paged`` loads
        segmented and pages both sides, with the geometry of the
        manifest's ``paged`` block where there is one.
        """
        store = _open_store(store)
        if paged:
            pb = store.manifest.get("paged") or {}
            seal = int(pb.get("seal_rows", delta_capacity))
            inner = cls.load(store, m_coarse=m_coarse, n_factor=n_factor,
                             segmented=True, delta_capacity=seal, device=device)
            return inner.paged(
                page_rows=int(pb.get("page_rows", 256)) if page_rows is None else page_rows,
                pool_pages=pool_pages, seal_rows=seal)
        views = store.resolutions()
        if not views:
            raise IndexStoreError(
                f"{store.path}: no coarse resolutions in manifest — write "
                f"one with IndexStore.add_resolution before loading a "
                f"cascade")
        if m_coarse is None:
            view = max(views, key=lambda v: v.dim)
        else:
            by_m = {v.dim: v for v in views}
            if m_coarse not in by_m:
                raise IndexStoreError(
                    f"{store.path}: no m={m_coarse} resolution (stored: "
                    f"{sorted(by_m)})")
            view = by_m[m_coarse]
        coarse = DenseIndex.load(view, device=device)
        if not segmented:
            return cls(coarse=coarse, full=DenseIndex.load(store, device=device),
                       n_factor=n_factor)
        full = SegmentedIndex.load(store, delta_capacity=delta_capacity, device=device)
        coarse = SegmentedIndex.from_index(coarse, delta_capacity=delta_capacity)
        dviews = store.resolution_deltas(view.name)
        if dviews and [v.n for v in dviews] == [d.n_real for d in full.deltas]:
            coarse = dataclasses.replace(coarse, deltas=tuple(
                rehydrate_delta(v, delta_capacity, device=coarse.device)
                for v in dviews))
        else:
            for d in full.deltas:
                if d.n_real:
                    coarse = coarse.append(d.raw[:, :coarse.dim])
        return cls(coarse=coarse, full=full, n_factor=n_factor)

    def segmented(self, *, delta_capacity: int = 4096) -> "CascadeIndex":
        """Both resolutions as single-base segmented indexes (the live
        form: appends grow the pair in lockstep)."""
        return dataclasses.replace(
            self,
            coarse=SegmentedIndex.from_index(self.coarse, delta_capacity=delta_capacity),
            full=SegmentedIndex.from_index(self.full, delta_capacity=delta_capacity))

    def paged(self, *, page_rows: int = 256, pool_pages: int | None = None,
              coarse_pool_pages: int | None = None, seal_rows: int = 4096,
              depth: int = 2, wave_pages: int = 8) -> "CascadeIndex":
        """Both resolutions re-homed on paged storage, byte for byte: the
        coarse scan and the rescore both go through page tables, and
        either side may oversubscribe the card on its own (``pool_pages``
        / ``coarse_pool_pages``)."""
        def conv(ix, pool):
            if isinstance(ix, SegmentedIndex):
                return PagedIndex.from_segmented(ix, page_rows=page_rows,
                                                 pool_pages=pool, depth=depth,
                                                 wave_pages=wave_pages)
            return PagedIndex.from_index(ix, page_rows=page_rows, pool_pages=pool,
                                         seal_rows=seal_rows, depth=depth,
                                         wave_pages=wave_pages)

        return dataclasses.replace(self, full=conv(self.full, pool_pages),
                                   coarse=conv(self.coarse, coarse_pool_pages))

    # -- shape --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.full.n

    @property
    def dim(self) -> int:
        """Search dim: the full resolution's width (the projection's m)."""
        return self.full.dim

    @property
    def m_coarse(self) -> int:
        return self.coarse.dim

    @property
    def device(self) -> torch.device:
        return self.full.device

    @property
    def nbytes(self) -> int:
        return self.coarse.nbytes + self.full.nbytes

    # -- growth (copy-on-write) --------------------------------------------
    def append(self, rows) -> "CascadeIndex":
        """Append pruned f32 rows (full m) to both resolutions; the coarse
        side takes the leading columns. Needs segmented or paged sides."""
        if not isinstance(self.full, (SegmentedIndex, PagedIndex)):
            raise TypeError("append needs segmented or paged resolutions — "
                            "wrap with CascadeIndex.segmented()/.paged() "
                            "first")
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        return dataclasses.replace(
            self, full=self.full.append(rows),
            coarse=self.coarse.append(np.ascontiguousarray(rows[:, :self.m_coarse])))

    # -- search -------------------------------------------------------------
    def coarse_topk(self, qf: torch.Tensor, nk: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The first pass: top-``nk`` of the coarse resolution for projected
        queries ``qf`` (no scale folded; each side folds its own)."""
        return self.coarse.search(qf[:, :self.m_coarse].contiguous(), k=nk)

    def rescore(self, qf: torch.Tensor, uids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The second pass: exact top-``k`` of the shortlist ``uids`` at full
        m, one ``row_ids`` call per part, merged in ascending id order."""
        return self.full.rescore(qf, uids, k)

    def search_projected(self, queries, components, k: int = 10, *,
                         mean=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Cascaded raw-query search, with the single-resolution
        ``search_projected``'s signature and contract: one shared
        projection (no scale fold), the coarse top-(N·k), the shortlist,
        the exact rescore. With N·k >= n the result is the full-m search's,
        bitwise on the card."""
        k = min(k, max(self.n, 1))
        nk = min(self.n_factor * k, max(self.n, 1))
        dev = self.device
        Q = torch.atleast_2d(as_tensor(queries, dev))
        qf = _project_nofold(Q, as_tensor(components, dev),
                             None if mean is None else as_tensor(mean, dev))
        _, cids = self.coarse_topk(qf, nk)
        return self.rescore(qf, _shortlist(cids), k)
