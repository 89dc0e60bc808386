"""Dense embedding index with exact top-k search (port of the flat part of
``repro/core/index.py``).

On a CUDA index every search is one ``topk_score`` kernel call (plus the
query projection as a plain fp32 matmul); on a CPU index it is
``_scan_topk``, the blocked running top-k that ``repro`` runs as its jnp
path. Scores are accumulated in fp32 whatever the index dtype.

``SegmentedIndex`` is the live index: an immutable base plus fixed-capacity
delta segments, each with its own int8 scale, searched per segment and
merged (``merge_segment_topk``). A delta's search is one ``topk_score``
call over its whole capacity with ``n_valid`` masking the rows not yet
appended, so its operand shape never changes as it fills.

``DenseIndex.load`` and ``SegmentedIndex.load`` read an ``IndexStore``
artifact (``core/store.py``) onto a device, the card by default. The paged
index is in ``core/paged.py``, the cascade in ``core/cascade.py``; the
sharded index is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.quantization import quantize_int8_per_dim, quantize_with_scale, scale_for
from repro_torch.core.store import IndexStore, IndexStoreError
from repro_torch.kernels import ops
from repro_torch.util import as_tensor, default_device


def project_queries(q: torch.Tensor, W: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    mean: torch.Tensor | None = None) -> torch.Tensor:
    """q̂ = ((q − mean) @ W_m) ⊙ scale: raw query to search query (PCA
    projection + int8 dequant fold), in the reference's operation order:
    cast to f32, centre, project, fold the scale."""
    q = torch.atleast_2d(q).float()
    if mean is not None:
        q = q - mean[None, :]
    q = q @ W
    if scale is not None:
        q = q * scale[None, :]
    return q


def _project_nofold(Q: torch.Tensor, W: torch.Tensor,
                    mean: torch.Tensor | None) -> torch.Tensor:
    """Centre and project a raw query without any scale fold: a paged index
    folds each page's own scale inside its search."""
    return project_queries(Q, W, scale=None, mean=mean)


def _topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (B, C) candidates with first-occurrence ties (a stable sort,
    as ``jax.lax.top_k``), returning (B, k) scores and gathered ids."""
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, idx[:, :k])


def _scan_topk(D: torch.Tensor, Q: torch.Tensor, k: int, block: int = 65536
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked exact search on the CPU: stream row blocks of D, keep a
    running top-k. Never holds the full (B, n) score matrix.

    Each block keeps its storage dtype and upcasts only for its matmul. A
    block that cannot improve any row's k-th best is skipped; rows that do
    not improve keep their list, which is exact because blocks come in
    ascending id order and ties go to the first occurrence.
    """
    n = D.shape[0]
    B = Q.shape[0]
    block = min(block, n)
    Qf = Q.float()
    kk = min(k, block)

    if block == n:
        # one strip: no running list, select directly; with fewer rows than
        # k the (-inf, -1) pads go first so they win -inf ties
        s = Qf @ D.float().T
        ids = torch.arange(n, dtype=torch.int32).expand(B, n)
        if k > n:
            s = torch.cat([torch.full((B, k), float("-inf")), s], 1)
            ids = torch.cat([torch.full((B, k), -1, dtype=torch.int32), ids], 1)
        return _topk_merge(s, ids, k)

    bs = torch.full((B, k), float("-inf"))
    bi = torch.full((B, k), -1, dtype=torch.int32)
    for start in range(0, n, block):
        s = Qf @ D[start:start + block].float().T                 # (B, <= block)
        imp = s.amax(1) > bs.amin(1)                               # (B,)
        if not bool(imp.any()):
            continue
        ss, si = _topk_merge(
            s, torch.arange(start, start + s.shape[1], dtype=torch.int32)
            .expand(B, -1), min(kk, s.shape[1]))
        # running list first: at -inf ties its (-1) pads win
        ms, mi = _topk_merge(torch.cat([bs, ss], 1), torch.cat([bi, si], 1), k)
        bs = torch.where(imp[:, None], ms, bs)
        bi = torch.where(imp[:, None], mi, bi)
    return bs, bi


def _check_flat_loadable(store) -> None:
    """Refuse to flatten a segmented store whose segments disagree on the
    int8 scale: a flat load would dequantise delta rows with the base's
    scale. ``SegmentView``s (one segment by construction) pass."""
    if getattr(store, "flat_loadable", True):
        return
    raise IndexStoreError(
        f"{store.path}: store has delta segments with per-segment scales — "
        f"load it with SegmentedIndex.load, not a flat index loader")


def _open_store(store):
    """An ``IndexStore`` from a path or an open handle (a store or one of
    its segment views)."""
    return IndexStore.open(store) if isinstance(store, (str, os.PathLike)) else store


@dataclasses.dataclass
class DenseIndex:
    """Flat exact-search index over document embeddings.

    ``vectors``: (n, m) document matrix (possibly PCA-pruned and/or int8).
    ``scale``: per-dim dequant scale when vectors are int8, else None.
    The index searches on the device its vectors live on.
    """

    vectors: torch.Tensor
    scale: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def nbytes(self) -> int:
        b = self.vectors.numel() * self.vectors.element_size()
        if self.scale is not None:
            b += self.scale.numel() * self.scale.element_size()
        return b

    @classmethod
    def build(cls, vectors, *, dtype: torch.dtype | None = None,
              quantize_int8: bool = False) -> "DenseIndex":
        v = as_tensor(vectors)
        if quantize_int8:
            q, scale = quantize_int8_per_dim(v)
            return cls(vectors=q, scale=scale)
        if dtype is not None:
            v = v.to(dtype)
        return cls(vectors=v.contiguous(), scale=None)

    @classmethod
    def load(cls, store, *, device=None) -> "DenseIndex":
        """Load from an on-disk ``IndexStore`` (path or open handle, or one
        segment's view) onto ``device`` (default: the card).

        The vectors are preallocated on the device and the memory-mapped
        chunks copied in one slice at a time (``read_into``), so the host
        never holds a copy of the index beyond the OS page cache.
        """
        store = _open_store(store)
        _check_flat_loadable(store)
        dev = default_device(device)
        vectors = torch.empty((store.n, store.dim), dtype=store.dtype, device=dev)
        store.read_into(vectors)
        s = store.scale()
        return cls(vectors=vectors,
                   scale=None if s is None else torch.from_numpy(s).to(dev))

    def _dequeries(self, queries: torch.Tensor) -> torch.Tensor:
        """Fold the int8 scale into the query side: (Dq) = (D_int8)(s ⊙ q)."""
        q = torch.atleast_2d(as_tensor(queries, self.device))
        if self.scale is not None:
            q = q * self.scale[None, :]
        return q

    def _topk(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        if self.device.type == "cuda":
            return ops.topk_score(self.vectors, q.float().contiguous(), k=k)
        return _scan_topk(self.vectors, q, k)

    def search(self, queries, k: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k. Returns (scores (B,k) fp32, ids (B,k) int32)."""
        return self._topk(self._dequeries(queries), min(k, self.n))

    def search_projected(self, queries, components: torch.Tensor,
                         k: int = 10, *, mean: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw-query search: (B, d) queries, the (d, m) projection ``W_m``
        and the optional centring row; projection and the int8 scale fold
        run in the reference's order, then one top-k."""
        dev = self.device
        q = project_queries(as_tensor(queries, dev), as_tensor(components, dev),
                            scale=self.scale,
                            mean=None if mean is None else as_tensor(mean, dev))
        return self._topk(q, min(k, self.n))

    def rescore(self, qf: torch.Tensor, uids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-``k`` of the shortlist ``uids`` (a cascade's second
        pass) for projected queries ``qf`` (no scale folded): one
        ``row_ids`` top-k over the gathered rows."""
        return _rows_rescore(self.vectors, self.scale, qf, uids, 0, self.n, k)


def _rows_rescore(D: torch.Tensor, scale: torch.Tensor | None,
                  qf: torch.Tensor, uids: torch.Tensor, offset: int,
                  n_valid: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the shortlist rows one segment holds: the segment's scale
    folded into the query, the U rows gathered in storage dtype (uids
    outside [offset, offset + n_valid) point at a clamped row and are
    masked with id -1), one ``row_ids`` top-k."""
    q = qf if scale is None else qf * scale[None, :]
    local = uids.long() - offset
    valid = (uids >= 0) & (local >= 0) & (local < n_valid)
    rows = D[local.clamp(0, D.shape[0] - 1)]
    ids = torch.where(valid, uids, torch.full_like(uids, -1))
    return ops.topk_score(rows, q.contiguous(), k=k, row_ids=ids)


# ---------------------------------------------------------------------------
# Segmented live index: immutable base + fixed-capacity delta segments
# ---------------------------------------------------------------------------


def _delta_topk(D: torch.Tensor, scale: torch.Tensor | None, Q: torch.Tensor,
                n_valid: int, offset: int, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over one fixed-capacity delta segment: one ``topk_score`` call
    over all ``capacity`` rows of ``D`` (storage dtype; rows at and beyond
    ``n_valid`` are zero padding, masked to (-inf, -1) by the kernel), the
    segment's own scale folded into the query, then local ids offset to
    global ones. The call's operand shapes do not depend on ``n_valid``."""
    q = torch.atleast_2d(Q).float()
    if scale is not None:
        q = q * scale[None, :]
    s, ids = ops.topk_score(D, q.contiguous(), k=min(k, D.shape[0]),
                            n_valid=n_valid)
    return s, torch.where(ids >= 0, ids + offset, ids)


def _delta_update(D: torch.Tensor, block: torch.Tensor, start: int) -> torch.Tensor:
    """Rows patched into a copy of a delta's fixed-capacity buffer: a new
    tensor (one device copy of the capacity), so searches in flight keep
    reading the old one."""
    out = D.clone()
    out[start:start + block.shape[0]] = block
    return out


def merge_segment_topk(candidates, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-segment (B, k_i) top-k candidate lists (global ids already
    applied) into the global (B, k) top-k.

    Segments must come in ascending id-offset order (base first, then
    deltas): the stable merge keeps the first occurrence among equal
    scores, so concatenation order reproduces a monolithic index's lowest-id
    tie-break, which makes the segmented search bit-identical to one scan
    over the concatenated corpus wherever the segments' scores are.
    """
    if len(candidates) == 1:
        return candidates[0]
    return _topk_merge(torch.cat([s for s, _ in candidates], 1),
                       torch.cat([i for _, i in candidates], 1), k)


def _host_f32(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    return np.ascontiguousarray(np.atleast_2d(np.asarray(rows, np.float32)))


def _stored(raw: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """f32 rows as stored in a float dtype, on the host (bf16 rounded, kept
    in f32 since numpy has no bf16)."""
    if dtype == torch.float32:
        return raw
    return torch.from_numpy(raw).to(dtype).float().numpy()


def _host_stored(t: torch.Tensor) -> np.ndarray:
    """Stored rows copied to the host: bf16 as f32 values (numpy has no
    bf16), as ``_stored`` keeps them."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """One growable segment: fixed-capacity storage and its own scale.

    ``vectors`` always has ``capacity`` rows (zeros beyond ``n_real``), so
    every search of it has one operand shape. ``raw`` keeps the exact f32
    rows appended so far: the requantisation source when an append widens
    the scale (requantising from f32 is exact; from int8 it would drift by
    up to half an old LSB).
    """

    vectors: torch.Tensor              # (capacity, m), storage dtype
    n_real: int
    scale: torch.Tensor | None         # per-dim dequant scale (int8 deltas)
    raw: np.ndarray                    # (n_real, m) f32 requant source

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def nbytes(self) -> int:
        b = self.vectors.numel() * self.vectors.element_size()
        if self.scale is not None:
            b += self.scale.numel() * self.scale.element_size()
        return b

    @staticmethod
    def quantise(raw: np.ndarray, scale: np.ndarray) -> np.ndarray:
        return quantize_with_scale(raw, scale)

    @staticmethod
    def _padded(stored: np.ndarray, capacity: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
        out = torch.zeros((capacity, stored.shape[1]), dtype=dtype, device=device)
        out[:stored.shape[0]] = torch.from_numpy(stored).to(device=device, dtype=dtype)
        return out

    @classmethod
    def build(cls, rows, capacity: int, *, quantize: bool, dtype: torch.dtype,
              device: torch.device) -> "DeltaSegment":
        """Open a delta from its first f32 rows on ``device``; an int8 delta
        gets a FRESH per-dim scale fitted to these rows, never the base's."""
        raw = _host_f32(rows)
        if raw.shape[0] > capacity:
            raise ValueError(f"{raw.shape[0]} rows exceed delta capacity "
                             f"{capacity}")
        if quantize:
            scale = scale_for(raw)
            stored = cls.quantise(raw, scale)
            dtype = torch.int8
        else:
            scale = None
            stored = _stored(raw, dtype)
        return cls(vectors=cls._padded(stored, capacity, dtype, device),
                   n_real=raw.shape[0],
                   scale=None if scale is None else torch.from_numpy(scale).to(device),
                   raw=raw)

    def extend(self, rows) -> tuple["DeltaSegment", bool, np.ndarray]:
        """Copy-on-write append of f32 rows.

        Returns ``(new segment, widened, stored)``, ``stored`` the host copy
        of what changed in storage dtype: the new rows in the common case,
        the whole requantised segment when the scale widened. An int8 delta
        widens its per-dim scale whenever a new row's absmax exceeds it,
        and the whole segment requantises from its exact f32 staging, so
        nothing ever clips; that rewrite is bounded by the capacity. The
        common append quantises only the new rows under the unchanged scale
        and patches them into a copy of the buffer (``_delta_update``).
        """
        rows = _host_f32(rows)
        if self.n_real + rows.shape[0] > self.capacity:
            raise ValueError("extend beyond delta capacity — seal and open "
                             "a new delta instead")
        raw = np.concatenate([self.raw, rows])
        dev, dtype = self.vectors.device, self.vectors.dtype
        if self.scale is not None:
            old = self.scale.cpu().numpy()
            scale = np.maximum(old, scale_for(rows)).astype(np.float32)
            if bool((scale > old).any()):          # widen: bounded rewrite
                stored = self.quantise(raw, scale)
                return dataclasses.replace(
                    self, vectors=self._padded(stored, self.capacity, dtype, dev),
                    n_real=raw.shape[0], scale=torch.from_numpy(scale).to(dev),
                    raw=raw), True, stored
            new_rows = self.quantise(rows, old)
        else:
            new_rows = _stored(rows, dtype)
        block = torch.from_numpy(new_rows).to(device=dev, dtype=dtype)
        return dataclasses.replace(
            self, vectors=_delta_update(self.vectors, block, self.n_real),
            n_real=raw.shape[0], raw=raw), False, new_rows


def rehydrate_delta(view, delta_capacity: int, *, device=None) -> DeltaSegment:
    """Rebuild one ``DeltaSegment`` from a store view on ``device``
    (default: the card): the stored bytes become the served bytes bit for
    bit, padded to the stored capacity; ``raw`` is the dequantised f32
    reconstruction, the best requantisation source that survives a
    restart."""
    rows = view.read_rows(0, view.n, device="cpu")
    s = view.scale()
    raw = rows.float().numpy()
    if s is not None:
        raw = raw * s[None, :].astype(np.float32)
    cap = int(view.capacity) if view.capacity else max(delta_capacity, view.n)
    dev = default_device(device)
    vectors = torch.zeros((cap, view.dim), dtype=rows.dtype, device=dev)
    vectors[:view.n] = rows.to(dev)
    return DeltaSegment(vectors=vectors, n_real=view.n,
                        scale=None if s is None else torch.from_numpy(s).to(dev),
                        raw=np.ascontiguousarray(raw))


@dataclasses.dataclass(frozen=True)
class SegmentedIndex:
    """Immutable segment set: [base] + deltas, searched as one index.

    The base is a committed ``DenseIndex`` (the offline PCA-pruned
    artifact); deltas absorb live corpus growth. Every mutation
    (``append``) returns a NEW ``SegmentedIndex`` sharing the untouched
    segments, so a running ``RetrievalServer`` swaps whole segment sets
    between batches and in-flight batches keep the old set alive.

    Search = per-segment top-k (each segment folds its OWN scale) merged by
    ``merge_segment_topk`` with global id offsets (base rows first, deltas
    in open order). When every segment shares one scale the result is
    bit-identical to a monolithic index over the concatenated corpus on the
    card, where each score's sum order does not depend on the segment; with
    mixed scales, ids and order are the top-k of the per-segment
    dequantised scores.
    """

    base: DenseIndex
    deltas: tuple[DeltaSegment, ...] = ()
    delta_capacity: int = 4096

    @classmethod
    def from_index(cls, base: DenseIndex, *, delta_capacity: int = 4096
                   ) -> "SegmentedIndex":
        return cls(base=base, deltas=(), delta_capacity=delta_capacity)

    @classmethod
    def load(cls, store, *, delta_capacity: int = 4096, device=None
             ) -> "SegmentedIndex":
        """Load a (possibly segmented) artifact onto ``device`` (default:
        the card): segment 0 becomes the base, every delta segment is
        rehydrated at its stored capacity with its own scale. A pre-segment
        artifact loads as a single base."""
        views = _open_store(store).segments()
        base = DenseIndex.load(views[0], device=device)
        deltas = [rehydrate_delta(v, delta_capacity, device=base.device)
                  for v in views[1:]]
        return cls(base=base, deltas=tuple(deltas), delta_capacity=delta_capacity)

    # -- shape --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.base.n + sum(d.n_real for d in self.deltas)

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def nbytes(self) -> int:
        return self.base.nbytes + sum(d.nbytes for d in self.deltas)

    @property
    def quantized(self) -> bool:
        return self.base.scale is not None

    @property
    def delta_rows(self) -> int:
        return sum(d.n_real for d in self.deltas)

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.base.vectors.dtype

    # -- growth (copy-on-write) ----------------------------------------------
    def append(self, rows) -> "SegmentedIndex":
        return self.append_with_ops(rows)[0]

    def append_with_ops(self, rows) -> tuple["SegmentedIndex", list]:
        """Append f32 rows (already PCA-pruned to this index's dim).

        Returns ``(new_index, ops)``, ``ops`` what changed for a durable
        mirror, in order:
          ("open",   di, stored_rows, scale)  — new delta with first rows
          ("extend", di, stored_rows)         — rows appended, scale kept
          ("widen",  di, stored_all,  scale)  — scale widened: the delta's
                                                full requantised contents
        ``stored_*`` are host arrays in storage dtype (int8 already
        quantised; bf16 as its values in f32), exactly the bytes the index
        serves.
        """
        rows = _host_f32(rows)
        if rows.shape[1] != self.dim:
            raise ValueError(f"append expects (rows, {self.dim}), got "
                             f"{tuple(rows.shape)}")
        deltas = list(self.deltas)
        ops_: list = []
        pos = 0
        while pos < rows.shape[0]:
            if deltas and deltas[-1].n_real < deltas[-1].capacity:
                di = len(deltas) - 1
                seg = deltas[di]
                take = min(rows.shape[0] - pos, seg.capacity - seg.n_real)
                seg, widened, stored = seg.extend(rows[pos:pos + take])
                deltas[di] = seg
                if widened:
                    ops_.append(("widen", di, stored, seg.scale.cpu().numpy()))
                else:
                    ops_.append(("extend", di, stored))
            else:
                di = len(deltas)
                take = min(rows.shape[0] - pos, self.delta_capacity)
                seg = DeltaSegment.build(rows[pos:pos + take], self.delta_capacity,
                                         quantize=self.quantized,
                                         dtype=self.storage_dtype, device=self.device)
                deltas.append(seg)
                ops_.append(("open", di, _host_stored(seg.vectors[:seg.n_real]),
                             None if seg.scale is None else seg.scale.cpu().numpy()))
            pos += take
        return dataclasses.replace(self, deltas=tuple(deltas)), ops_

    # -- search ---------------------------------------------------------------
    def _merged_topk(self, q: torch.Tensor, k: int):
        k = min(k, max(self.n, 1))
        parts = [self.base.search(q, k=k)]
        off = self.base.n
        for d in self.deltas:
            parts.append(_delta_topk(d.vectors, d.scale, q, d.n_real, off, k))
            off += d.n_real
        return merge_segment_topk(parts, k)

    def search(self, queries, k: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k of pre-projected queries (no scale folded: each
        segment folds its own). Returns (scores (B,k) fp32, ids (B,k) int32)."""
        q = torch.atleast_2d(as_tensor(queries, self.device)).float()
        return self._merged_topk(q, k)

    def search_projected(self, queries, components: torch.Tensor, k: int = 10, *,
                         mean: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw-query search: one shared projection (no scale fold — the
        segments do not share one), then per-segment fold, top-k and merge."""
        dev = self.device
        q = _project_nofold(torch.atleast_2d(as_tensor(queries, dev)),
                            as_tensor(components, dev),
                            None if mean is None else as_tensor(mean, dev))
        return self._merged_topk(q, k)

    def rescore(self, qf: torch.Tensor, uids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-``k`` of the shortlist ``uids`` for projected queries
        ``qf``: one ``row_ids`` call per segment (the uids outside it set to
        -1), merged in ascending id order, which equals a max-combine and
        top-k over the segments, ties included."""
        parts = [self.base.rescore(qf, uids, k)]
        off = self.base.n
        for d in self.deltas:
            parts.append(_rows_rescore(d.vectors, d.scale, qf, uids, off, d.n_real, k))
            off += d.n_real
        return merge_segment_topk(parts, k)
