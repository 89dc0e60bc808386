"""Index maintenance: segmented live growth and drift-triggered compaction
(port of ``repro/core/maintenance.py``).

  * ``IndexUpdater.add_documents`` — new documents are rotated with the
    EXISTING ``W_m`` and appended to the open delta segment (no refit, no
    reindex of old docs). Each delta carries its OWN int8 scale, widened per
    append block when needed, so nothing ever clips against the base's
    frozen scale. With a ``store`` attached, every append mirrors durably
    to disk (the bytes on disk are the bytes being served); with a
    ``server`` attached, every append installs the new segment set
    atomically between batches (``RetrievalServer.swap_index``).
  * ``drift_score`` — fraction of a new batch's embedding energy captured by
    the kept subspace, ``||X W_m||² / ||X||²``, against the energy it
    captured at fit time: near 1 the rotation still fits (paper RQ2
    regime); a falling ratio says the corpus moved enough for a refit.
  * ``scale_divergence`` / ``delta_fraction`` — how far the delta scales
    have widened past the base's, and how much of the corpus lives outside
    the base. Either climbing is the compaction signal.
  * ``needs_refit`` — thresholded policy over all three signals.
  * ``compact()`` — rebuild of base + deltas into ONE fresh base segment
    (same rotation, fresh corpus-wide scale). Without a store it runs on
    the index's device; with one it streams through
    ``StaticPruner.build_index_to(already_projected=True)`` into a sidecar
    artifact and swaps the directory in atomically. ``compact_async()``
    runs it off-thread: appends that land mid-compaction are reconciled
    onto the new base before the swap. A paged index compacts by pointer
    swaps; a sharded base compacts (and refits) onto the same mesh.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.fsio import commit_dir
from repro_torch.core.index import DenseIndex, SegmentedIndex, ShardedDenseIndex
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.store import IndexStore, paged_manifest_block, save_index
from repro_torch.util import as_tensor


def _new_rlock():
    """Call-time ``threading.RLock`` lookup for the dataclass default, so a
    lock class instrumented after import (a lock sanitizer) still applies
    to every new updater."""
    return threading.RLock()


def _eigval_energy(pruner: StaticPruner) -> float:
    """Reference captured energy from the fitted state alone.

    ``captured_energy`` is an *uncentered* ratio. Uncentered fit:
    ``||D W_m||²/||D||² = Σ_{i≤m} λ_i / Σ λ_i``. Centered fit: the Gram is
    ``n·(C + μμᵀ)``, so the same ratio gains the mean's energy —
    ``(Σ_{i≤m} λ_i + ||W_mᵀμ||²) / (Σ λ_i + ||μ||²)``. Both exact.
    """
    state = pruner.state
    m = pruner.kept_dims
    lam = state.eigenvalues.cpu().numpy().astype(np.float64)
    mu = state.mean.cpu().numpy().astype(np.float64)
    W = state.components.cpu().numpy().astype(np.float64)[:, :m]
    num = float(lam[:m].sum()) + float(np.sum((W.T @ mu) ** 2))
    den = float(lam.sum()) + float(np.sum(mu ** 2))
    return num / max(den, 1e-30)


def captured_energy(X, pruner: StaticPruner) -> float:
    """||X W_m||² / ||X||² — energy the kept subspace explains on X."""
    W = pruner.state.components[:, :pruner.kept_dims]
    Xf = as_tensor(X, W.device).float()
    num = torch.sum((Xf @ W) ** 2)
    den = torch.clamp_min(torch.sum(Xf ** 2), 1e-30)
    return float(num / den)


@dataclasses.dataclass
class IndexUpdater:
    """Segmented (or paged) pruned index + transform with live growth and
    compaction.

    ``index`` may be a bare ``DenseIndex`` or ``ShardedDenseIndex`` (wrapped
    as a single-base ``SegmentedIndex``), a ``SegmentedIndex`` or a
    ``PagedIndex``.
    ``fit_energy`` may be left unset: the reference energy then comes from
    the fitted state (``_eigval_energy``), exactly, with no pass over the
    fit corpus. ``store``: an optional ``IndexStore`` (or path) the updater
    appends through — every delta mutation lands durably, so the on-disk
    artifact tracks the in-memory segments bit for bit. ``server``: an
    optional ``RetrievalServer`` that receives the new index via
    ``swap_index`` after every mutation.
    """

    pruner: StaticPruner
    index: SegmentedIndex | PagedIndex
    fit_energy: float | None = None  # energy on the fit corpus (reference)
    store: IndexStore | None = None  # IndexStore | str | None
    server: object | None = None     # RetrievalServer | None
    delta_capacity: int = 4096
    # telemetry
    appended_rows: int = 0
    compactions: int = 0
    # last compaction's cost receipt. Paged: {"pages_moved", "pages_freed",
    # "pages_host"} (pointer swaps); segmented rebuild: {"rows_rebuilt"}
    last_compaction: dict | None = None
    # background-thread failures (compact_async): read by health(), so a
    # dead compaction surfaces instead of leaving the deltas to grow
    background_errors: list = dataclasses.field(default_factory=list)
    _lock: threading.RLock = dataclasses.field(default_factory=_new_rlock,
                                               repr=False, compare=False)

    def __post_init__(self):
        if isinstance(self.store, (str, bytes, os.PathLike)):
            self.store = IndexStore.open(self.store)
        if isinstance(self.index, (DenseIndex, ShardedDenseIndex)):
            self.index = SegmentedIndex.from_index(
                self.index, delta_capacity=self.delta_capacity)

    @classmethod
    def build(cls, corpus, *, cutoff: float = 0.5, quantize_int8: bool = False,
              store_path: str | None = None, delta_capacity: int = 4096,
              paged: bool = False, page_rows: int = 256,
              pool_pages: int | None = None) -> "IndexUpdater":
        """Fit + build on the corpus's device; with ``store_path``, also
        persist the artifact and attach the committed store for durable
        appends. ``paged=True`` serves through ``PagedIndex`` (pointer-swap
        lifecycle; ``pool_pages`` below the corpus page count
        oversubscribes device memory)."""
        corpus = as_tensor(corpus)
        pruner = StaticPruner(cutoff=cutoff).fit(corpus)
        base = pruner.build_index(corpus, quantize_int8=quantize_int8)
        if paged:
            index = PagedIndex.from_index(base, page_rows=page_rows,
                                          pool_pages=pool_pages,
                                          seal_rows=delta_capacity)
        else:
            index = SegmentedIndex.from_index(base, delta_capacity=delta_capacity)
        store = None
        if store_path is not None:
            store = save_index(store_path, index if paged else base, pruner=pruner)
        return cls(pruner=pruner, index=index,
                   fit_energy=captured_energy(corpus, pruner), store=store,
                   delta_capacity=delta_capacity)

    @classmethod
    def from_store(cls, store, *, mesh=None, merge: str = "flat",
                   delta_capacity: int = 4096, paged: bool | None = None,
                   pool_pages: int | None = None, device=None) -> "IndexUpdater":
        """Rehydrate updater state from a committed artifact (cold start)
        onto ``device`` (default: the card), or with ``mesh`` its base over
        the mesh: base AND delta segments, each with its own scale.
        ``paged=None`` auto-detects: a store carrying the ``paged`` manifest
        block reloads as a ``PagedIndex``.

        ``fit_energy`` stays lazy: the fit corpus is not in the store, and
        the eigenvalue identity gives the same reference.
        """
        if not isinstance(store, IndexStore):
            store = IndexStore.open(store)
        if paged is None:
            paged = "paged" in store.manifest
        if paged:
            index = PagedIndex.load(store, pool_pages=pool_pages, device=device)
        else:
            index = SegmentedIndex.load(store, mesh=mesh, merge=merge,
                                        delta_capacity=delta_capacity, device=device)
        return cls(pruner=store.load_pruner(device=index.device), index=index,
                   store=store, delta_capacity=delta_capacity)

    # -- incremental growth ------------------------------------------------
    def add_documents(self, new_embs) -> int:
        """Rotate with the existing W_m and append to the open delta.

        Copy-on-write: a NEW segment set is built, mirrored to the store
        (open/extend/widen ops with the exact stored bytes), then installed
        into the attached server atomically. Nothing ever clips: an int8 delta's
        scale widens per dim to fit every appended block (requantised from
        the exact f32 staging; the rewrite is bounded by the open delta's
        capacity). Returns the number of rows appended.
        """
        with self._lock:
            pruner = self.pruner
        # the rotation runs OUTSIDE the lock (device work must not block
        # concurrent telemetry); the append below re-takes it
        X = as_tensor(new_embs, pruner.state.components.device)
        pruned = pruner.prune_index(X).float().cpu().numpy()
        with self._lock:
            new_index, ops_ = self.index.append_with_ops(pruned)
            self._mirror_ops(ops_, new_index)
            self.index = new_index
            self.appended_rows += pruned.shape[0]
            # swap INSIDE the lock: a preempted thread must not install a
            # segment set an already-completed append/compaction superseded
            if self.server is not None:
                self.server.swap_index(new_index)
        return int(pruned.shape[0])

    def _mirror_ops(self, ops_, new_index) -> None:
        """Replay append ops durably (three fsyncs per op: the blob, the
        manifest and the directory). The op stream is identical for
        segmented and paged indexes; only the delta-ordinal -> store-segment
        mapping differs (paged: extents are segments positionally, with
        base extents a prefix — delta ordinal di is segment ``n_base +
        di``). A paged mirror finishes with the lifecycle-block swap, which
        may lag the segment ops across a crash (the loader reconstructs;
        ``IndexStore._validate_paged``)."""
        if self.store is None:
            return
        paged = isinstance(new_index, PagedIndex)
        if paged:
            base_idx = sum(1 for e in new_index.storage.extents if e.kind == "base")
            capacity = new_index.storage.seal_rows
        else:
            base_idx = 1
        names = [v.name for v in self.store.segments()]
        dtype = self.store.dtype
        for op in ops_:
            kind, di = op[0], op[1]
            seg_idx = base_idx + di                # store segment position
            # host rows in the store's dtype (a bf16 index hands its rows
            # over as f32 values, exactly representable)
            stored = torch.as_tensor(op[2]).to(dtype)
            if kind == "open":
                cap = capacity if paged else new_index.deltas[di].capacity
                name = self.store.add_delta(scale=op[3], capacity=cap)
                names.append(name)
                if stored.shape[0]:
                    self.store.append(stored, segment=name)
            elif kind == "extend":
                self.store.append(stored, segment=names[seg_idx])
            else:                                   # widen: bounded rewrite
                self.store.replace_segment(names[seg_idx], [stored], scale=op[3])
        if paged:
            self.store.set_paged_state(paged_manifest_block(new_index.storage))

    # -- telemetry ---------------------------------------------------------
    @property
    def clip_fraction(self) -> float:
        """Always 0.0: per-delta scales widen instead of clipping. Kept as an
        explicit invariant for dashboards that tracked it."""
        return 0.0

    @property
    def delta_fraction(self) -> float:
        """Fraction of the corpus living outside the compacted base. A paged
        index counts pages (``delta_pages / total_pages``), the unit its
        compaction pays in."""
        with self._lock:
            index = self.index
        pages = getattr(index, "total_pages", None)
        if pages is not None:
            return index.delta_pages / pages if pages else 0.0
        n = index.n
        return index.delta_rows / n if n else 0.0

    def scale_divergence(self) -> float:
        """max over deltas of the max-dim ratio (delta scale / base scale):
        how far live data has outgrown the base's quantisation regime. 1.0
        when unquantised or no delta has widened past the base."""
        with self._lock:
            index = self.index
        if isinstance(index, PagedIndex):           # extents carry it
            exts = index.storage.extents
            base_scale = exts[0].scale if exts else None
            dscales = [e.scale for e in exts if e.kind == "delta"]
        else:
            base_scale = (None if index.base.scale is None
                          else index.base.scale.cpu().numpy())
            dscales = [None if d.scale is None else d.scale.cpu().numpy()
                       for d in index.deltas]
        if base_scale is None or not dscales:
            return 1.0
        b = np.asarray(base_scale, np.float64)
        worst = 1.0
        for s in dscales:
            if s is not None:
                worst = max(worst, float(np.max(np.asarray(s, np.float64) / b)))
        return worst

    # -- drift policy ------------------------------------------------------
    def _reference_energy(self) -> float:
        with self._lock:
            if self.fit_energy is not None:
                return self.fit_energy
            pruner = self.pruner
        # the device->host reads run UNLOCKED; only the cache fill re-takes
        # the lock (and drops the result if a refit swapped the pruner)
        ref = _eigval_energy(pruner)
        with self._lock:
            if self.fit_energy is None and self.pruner is pruner:
                self.fit_energy = ref
            return self.fit_energy if self.fit_energy is not None else ref

    def drift_score(self, new_embs) -> float:
        """1.0 = no drift; < 1.0 = the kept subspace explains less energy on
        the new batch than it did on the fit corpus."""
        with self._lock:
            pruner = self.pruner
        ref = self._reference_energy()
        return captured_energy(new_embs, pruner) / max(ref, 1e-12)

    def needs_refit(self, new_embs, threshold: float = 0.9,
                    delta_threshold: float = 0.5,
                    scale_threshold: float = 4.0) -> bool:
        """Compact/refit when the subspace drifted, the deltas hold more than
        ``delta_threshold`` of the corpus, *or* a delta scale has widened
        more than ``scale_threshold``x past the base's (widened scales never
        clip, but they coarsen the grid for everything in that delta)."""
        if self.delta_fraction > delta_threshold:
            return True
        if self.scale_divergence() > scale_threshold:
            return True
        return self.drift_score(new_embs) < threshold

    # -- compaction --------------------------------------------------------
    def _iter_dequant_rows(self, index: SegmentedIndex, block_rows: int,
                           store: IndexStore | None = None):
        """Stream base + delta rows as f32 blocks in global id order, then
        each delta's exact f32 staging.

        ``store`` is the caller's locked snapshot of ``self.store`` (or
        None): the generator runs unlocked while appends mirror to the live
        store, so it never re-reads the field mid-stream. With a store the
        base streams from DISK (host O(block)), each block read onto the
        index's device; otherwise from the device copy (a sharded base's
        real rows, shard by shard). Either way it is dequantised there by
        one f32 multiply per element."""
        dev = index.device
        if store is not None:
            view = store.segments()[0]
            n = view.n
            s = view.scale()
            scale = None if s is None else torch.from_numpy(s).to(dev)

            def block(lo):
                return view.read_rows(lo, min(lo + block_rows, n), device=dev)
        else:
            base = index.base
            n, scale = base.n, base.scale

            def block(lo):          # a sharded base walks its shards' real rows
                return base.rows(lo, min(lo + block_rows, n))
        for lo in range(0, n, block_rows):
            rows = block(lo).float()
            if scale is not None:
                rows = rows * scale[None, :]
            yield rows
        for d in index.deltas:
            for lo in range(0, d.n_real, block_rows):
                yield torch.from_numpy(d.raw[lo:lo + block_rows])

    def _compact_paged(self) -> None:
        """Paged compaction: seal + promote every delta extent and drain
        tail pages into free pool slots — pointer swaps plus one gather,
        never a corpus rebuild, so it runs entirely under the lock. On disk
        it is one lifecycle-block manifest swap (the page bytes were
        mirrored at append time)."""
        with self._lock:
            new_index, stats = self.index.compact_pages()
            if self.store is not None:
                self.store.set_paged_state(paged_manifest_block(new_index.storage))
            self.index = new_index
            self.compactions += 1
            self.last_compaction = dict(stats)
            if self.server is not None:
                self.server.swap_index(new_index)

    def compact(self, *, block_rows: int = 65536) -> None:
        """Merge base + deltas into ONE fresh base segment and swap it in.

        The rotation (``W_m``) is unchanged; compaction re-homogenises the
        quantisation: a single fresh corpus-wide scale replaces the base's
        and every widened delta scale.

        Without a store the rows are assembled on the index's device
        (``_iter_dequant_rows`` into one f32 buffer) and ``DenseIndex.build``
        (or, for a sharded base, ``ShardedDenseIndex.build`` on the same
        mesh) quantises them. With a store attached the new artifact builds
        UNLOCKED at a sidecar path (``<path>.compact``) through
        ``StaticPruner.build_index_to(already_projected=True)`` (O(block)
        host memory, int8 spill), the base loads from it, and only the
        directory swap into the live path (``commit_dir`` rename-aside: a
        crash leaves the old or the new artifact, never neither) happens
        under the updater lock, so no append mirror can interleave with
        the replacement. Both paths give the same bytes. Appends racing the
        build are reconciled: rows landed after the snapshot re-append
        onto the fresh base (and mirror to the new artifact) before the
        swap.
        """
        with self._lock:
            snapshot, pruner = self.index, self.pruner
            store, n_compactions = self.store, self.compactions
        if isinstance(snapshot, PagedIndex):
            self._compact_paged()
            return
        old_base = snapshot.base
        mesh = getattr(old_base, "mesh", None)     # a sharded base stays on its mesh
        if store is not None:
            side_path = store.path + ".compact"
            side = pruner.build_index_to(
                side_path,
                lambda: self._iter_dequant_rows(snapshot, block_rows, store),
                quantize_int8=snapshot.quantized, already_projected=True,
                meta={"compactions": n_compactions + 1})
            # the base materialises from the sidecar before the lock: the
            # load never blocks appends
            if mesh is not None:
                base = ShardedDenseIndex.load(side, mesh, merge=old_base.merge)
            else:
                base = DenseIndex.load(side, device=snapshot.device)
        else:
            side_path = None
            rows = torch.empty((snapshot.n, snapshot.dim), dtype=torch.float32,
                               device=snapshot.device)
            pos = 0
            for blk in self._iter_dequant_rows(snapshot, block_rows):
                rows[pos:pos + blk.shape[0]] = blk
                pos += blk.shape[0]
            if mesh is not None:
                base = ShardedDenseIndex.build(rows, mesh, quantize_int8=snapshot.quantized,
                                               merge=old_base.merge)
            else:
                base = DenseIndex.build(rows, quantize_int8=snapshot.quantized)
            del rows
        fresh = SegmentedIndex.from_index(base, delta_capacity=self.delta_capacity)
        with self._lock:
            if side_path is not None:
                commit_dir(side_path, self.store.path)     # atomic retire
                self.store = IndexStore.open(self.store.path)
            # the current segment set extends the snapshot row for row, so
            # the tail [snapshot.n:) is exactly the racing appends
            tail = [d.raw for d in self.index.deltas]
            tail_rows = (np.concatenate(tail)[snapshot.delta_rows:] if tail
                         else np.zeros((0, snapshot.dim), np.float32))
            if tail_rows.shape[0]:
                fresh, ops_ = fresh.append_with_ops(tail_rows)
                self._mirror_ops(ops_, fresh)
            self.index = fresh
            self.compactions += 1
            self.last_compaction = {"rows_rebuilt": int(fresh.n)}
            if self.server is not None:
                self.server.swap_index(fresh)

    def compact_async(self, **kw) -> threading.Thread:
        """Run ``compact`` off-thread: serving keeps dispatching against the
        old segment set until the finished base swaps in. A crash is
        RECORDED in ``background_errors`` (read by ``health()``) and
        re-raised in the thread."""
        def _run():
            try:
                self.compact(**kw)
            except BaseException as e:   # noqa: BLE001 — recorded, re-raised
                with self._lock:
                    self.background_errors.append(
                        {"op": "compact", "error": repr(e), "time": time.time()})
                raise
        th = threading.Thread(target=_run, daemon=True)
        th.start()
        return th

    def health(self) -> dict:
        """Maintenance health snapshot: ok iff no background thread has
        died. ``background_errors`` is a copy."""
        with self._lock:
            errs = list(self.background_errors)
            compactions = self.compactions
            appended = self.appended_rows
            last = None if self.last_compaction is None else dict(self.last_compaction)
        return {"ok": not errs, "background_errors": errs,
                "compactions": compactions, "appended_rows": appended,
                "last_compaction": last}

    def refit(self, corpus) -> None:
        """Full offline refit (new rotation) on the current corpus
        distribution; unlike ``compact``, this re-fits ``W_m`` itself. A
        paged index stays paged with its page geometry, a sharded base is
        rebuilt on the same mesh with the same merge, and an attached store
        is rewritten under the new rotation."""
        with self._lock:
            old_index, old_pruner = self.index, self.pruner
        corpus = as_tensor(corpus, old_index.device)
        pruner = StaticPruner(cutoff=old_pruner.effective_cutoff).fit(corpus)
        old_base = getattr(old_index, "base", None)
        mesh = getattr(old_base, "mesh", None)
        if mesh is not None:
            base = ShardedDenseIndex.build(pruner.prune_index(corpus), mesh,
                                           quantize_int8=old_index.quantized,
                                           merge=old_base.merge)
        else:
            base = pruner.build_index(corpus, quantize_int8=old_index.quantized)
        if isinstance(old_index, PagedIndex):
            st = old_index.storage
            new_index = PagedIndex.from_index(
                base, page_rows=st.page_rows, seal_rows=st.seal_rows,
                depth=old_index.depth, wave_pages=old_index.wave_pages)
        else:
            new_index = SegmentedIndex.from_index(base, delta_capacity=self.delta_capacity)
        energy = captured_energy(corpus, pruner)
        with self._lock:
            self.pruner, self.index, self.fit_energy = pruner, new_index, energy
            self.appended_rows = 0
            if self.store is not None:
                # the old artifact is invalid under the new rotation:
                # replace it atomically at the same path
                self.store = save_index(
                    self.store.path,
                    self.index if isinstance(self.index, PagedIndex) else self.index.base,
                    pruner=self.pruner)
            if self.server is not None:
                self.server.swap_index(self.index, pruner=self.pruner)

    def search(self, queries, k: int = 10):
        with self._lock:
            index, pruner = self.index, self.pruner
        return index.search(pruner.transform_queries(queries), k=k)
