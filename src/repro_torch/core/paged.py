"""Paged index memory over a dense or segmented base (port of
``repro/core/paged.py``).

``PagedIndexStorage`` keeps an index's rows in fixed ``page_rows``-row
pages behind an int32 page table:

  * ``pool``  — the stable device tier (base and compacted pages);
  * ``tail``  — a small device write arena that absorbs appends;
  * host tier — pages whose table entry is -1 live in host memory (pinned
                when the index is on the card) and stream to the device in
                waves at search time, so the index may exceed the pool.

Logical slots are contiguous per extent (the base first, then delta
extents, in ascending global-id order). Every lifecycle step is a pointer
swap: append writes tail pages and grows the open delta extent, which
seals at ``seal_rows``; promote turns sealed deltas into base extents;
compact moves tail pages into free pool slots in one gather; evict moves
the highest pool pages to the host tier.

Copy-on-write: every step returns a new storage whose changed parts are new
tensors (a new tail per append, a new pool per compaction, new metadata);
nothing an in-flight search of an older storage reads is written in place,
so a server may swap a new index in under traffic. A step pushes only what
it changed: each new device table is a device-side copy of the old one
with the touched slots scattered in, and a new tail is a copy of the old
one with the written rows scattered in. Device copies are made on the
current stream, which is then synchronised before the new storage is
returned, so a search launched from any thread sees them complete.

A search walks slot runs in ascending order: device runs go straight to
``ops.topk_score_paged`` over the pool and tail, host runs stream in waves
of ``wave_pages`` pages chained through the top-k carry. Results follow the
(score desc, id asc) order, so they do not depend on where a page lives:
promote, compact and evict leave them unchanged. ``from_segmented`` pages a
live ``SegmentedIndex`` byte for byte, each delta becoming a delta extent.
``save`` writes one store segment per extent, gathered off the tiers by
``extent_rows``, and ``load`` pages a store back bit for bit. ``rescore``
is the cascade's second stage over the page tables.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.index import (
    DenseIndex,
    SegmentedIndex,
    _open_store,
    _project_nofold,
    merge_segment_topk,
)
from repro_torch.core.quantization import quantize_with_scale, scale_for
from repro_torch.core.store import save_paged_index
from repro_torch.kernels import ops
from repro_torch.util import as_tensor, default_device


class PageExtent(NamedTuple):
    """One logical row range: ``n_rows`` rows in ``n_pages`` contiguous
    slots from ``start_slot``; global ids ``[row_offset, row_offset +
    n_rows)``. ``scale`` is the extent's int8 dequant scale (the scale row
    of each of its pages); ``raw`` is the exact f32 staging kept while a
    delta extent is open (requantised from when an append widens the
    scale)."""

    kind: str                    # "base" | "delta"
    sealed: bool
    start_slot: int
    n_pages: int
    n_rows: int
    row_offset: int
    scale: np.ndarray | None
    raw: np.ndarray | None


def _pool_drain(pool: torch.Tensor, tail: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
    """Compaction: a new pool where slot p holds tail page ``sel[p]`` when
    ``sel[p] >= 0`` and its old page otherwise. One copy of the pool and
    one gather of the moved pages; the old pool is never written."""
    out = pool.clone()
    dst = torch.nonzero(sel >= 0).flatten()
    if dst.numel():
        out[dst] = tail[sel[dst].long()]
    return out


def _host_zeros(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host memory for pages of an index on ``device``: pinned for the card,
    so waves copy asynchronously."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _to_device(a: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` holding host array or tensor ``a`` (never
    a view of it). On the card the copy goes through pinned memory on the
    current stream without blocking the host; PyTorch's pinned allocator
    keeps the staging block until the copy is done."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def _paged_topk(pool, tail, pt, scale, nv, off, lo: int, hi: int, Q, *,
                k: int, carry=None, finalize: bool = True):
    """One paged top-k over slots [lo, hi) with pre-projected queries."""
    q = torch.atleast_2d(Q).float().contiguous()
    return ops.topk_score_paged(pool, pt, nv, off, lo, hi, q, k=k, tail=tail,
                                page_scale=scale, carry=carry,
                                finalize=finalize)


def _patched(t: torch.Tensor, cap: int, fill, slots: list, values: np.ndarray
             ) -> torch.Tensor:
    """A new device table of ``cap`` rows: ``t`` (grown with ``fill``) with
    ``values`` scattered into rows ``slots``. ``t`` itself is returned when
    nothing changed, and is never written."""
    if not slots and cap == t.shape[0]:
        return t
    if cap > t.shape[0]:
        t = torch.cat([t, t.new_full((cap - t.shape[0], *t.shape[1:]), fill)])
    else:
        t = t.clone()
    if slots:
        idx = torch.tensor(slots, dtype=torch.long).to(t.device)
        t[idx] = torch.from_numpy(np.ascontiguousarray(values)).to(t.device)
    return t


class _Mut:
    """Scratch copy-on-write view of a storage: a mutation edits private
    copies of the host metadata and records the slots it touched and the
    tail rows it wrote; ``freeze`` pushes just those to new device tensors
    (``_patched``)."""

    def __init__(self, st: "PagedIndexStorage"):
        self.st = st
        self.pt = st.pt_host.copy()
        self.nv = st.nvalid_host.copy()
        self.off = st.offset_host.copy()
        self.touched: set[int] = set()
        self.tail_writes: list = []        # (first flat tail row, host rows)
        self.host_pages = dict(st.host_pages)
        self.extents = list(st.extents)
        self.free_pool = list(st.free_pool)
        self.free_tail = list(st.free_tail)

    @property
    def R(self) -> int:
        return self.st.page_rows

    def ensure_slots(self, n_needed: int) -> None:
        cap = self.pt.shape[0]
        if n_needed <= cap:
            return
        new_cap = cap
        while new_cap < n_needed:
            new_cap *= 2
        grow = new_cap - cap
        self.pt = np.concatenate([self.pt, np.full(grow, -1, np.int32)])
        self.nv = np.concatenate([self.nv, np.zeros(grow, np.int32)])
        self.off = np.concatenate([self.off, np.zeros(grow, np.int32)])

    def set_page(self, slot: int, phys: int) -> None:
        self.pt[slot] = phys
        self.touched.add(slot)

    def alloc_page(self, slot: int, offset: int) -> None:
        """Back a fresh logical slot: the tail while arena pages remain,
        then the host tier (an append never fails)."""
        self.ensure_slots(slot + 1)
        if self.free_tail:
            self.set_page(slot, self.st.pool_pages + self.free_tail.pop(0))
        else:
            self.set_page(slot, -1)
            self.host_pages[slot] = _host_zeros(
                (self.R, self.st.dim), self.st.dtype, self.st.device)
        self.nv[slot] = 0
        self.off[slot] = offset

    def write_rows(self, slot: int, row0: int, rows: torch.Tensor) -> None:
        """Write ``rows`` (storage dtype, host) into a page at ``row0``."""
        phys = int(self.pt[slot])
        if phys >= 0:
            local = phys - self.st.pool_pages
            if local < 0:
                raise AssertionError("writes only target tail/host pages")
            self.tail_writes.append((local * self.R + row0, rows))
        else:
            page = _host_zeros((self.R, self.st.dim), self.st.dtype,
                               self.st.device)
            page.copy_(self.host_pages[slot])      # readers keep theirs
            page[row0:row0 + rows.shape[0]] = rows
            self.host_pages[slot] = page
        self.nv[slot] = max(int(self.nv[slot]), row0 + rows.shape[0])
        self.touched.add(slot)

    def _scale_rows(self, slots: list) -> np.ndarray:
        """Each slot's scale row: the scale of the extent that holds it."""
        out = np.zeros((len(slots), self.st.dim), np.float32)
        for i, s in enumerate(slots):
            for e in self.extents:
                if e.start_slot <= s < e.start_slot + e.n_pages:
                    out[i] = e.scale
                    break
        return out

    def freeze(self, pool: torch.Tensor | None = None) -> "PagedIndexStorage":
        st = self.st
        dev = st.device
        slots = sorted(self.touched)
        cap = self.pt.shape[0]
        tail = st.tail
        if self.tail_writes:
            flat = np.concatenate([np.arange(r0, r0 + rows.shape[0])
                                   for r0, rows in self.tail_writes])
            rows = torch.cat([rows for _, rows in self.tail_writes])
            tail = tail.clone()
            tail.view(-1, st.dim)[torch.from_numpy(flat).to(dev)] = rows.to(dev)
        new = dataclasses.replace(
            st,
            pool=st.pool if pool is None else pool,
            tail=tail,
            page_table=_patched(st.page_table, cap, -1, slots, self.pt[slots]),
            page_scale=(None if st.page_scale is None else
                        _patched(st.page_scale, cap, 0, slots, self._scale_rows(slots))),
            page_nvalid=_patched(st.page_nvalid, cap, 0, slots, self.nv[slots]),
            page_offset=_patched(st.page_offset, cap, 0, slots, self.off[slots]),
            pt_host=self.pt, nvalid_host=self.nv, offset_host=self.off,
            host_pages=self.host_pages, extents=tuple(self.extents),
            free_pool=tuple(self.free_pool), free_tail=tuple(self.free_tail))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return new


@dataclasses.dataclass(frozen=True, eq=False)
class PagedIndexStorage:
    """Two device page tiers and a host tier behind one page table.

    Immutable: every mutation returns a new storage sharing the untouched
    tensors. The ``*_host`` numpy mirrors of the table, row counts and
    offsets are authoritative; a mutation pushes the slots it touched to
    device copies of the old tables, and the rows it wrote to a device copy
    of the old tail. A page's scale row is its extent's scale
    (``scale_host`` derives the host view from the extents). The host
    pages are CPU tensors in the storage dtype.
    """

    pool: torch.Tensor                 # (pool_pages, R, m) stable tier
    tail: torch.Tensor                 # (tail_pages, R, m) write arena
    page_table: torch.Tensor           # (table_cap,) int32; -1 = host tier
    page_scale: torch.Tensor | None    # (table_cap, m) f32 (int8 pools)
    page_nvalid: torch.Tensor          # (table_cap,) int32 live rows/page
    page_offset: torch.Tensor          # (table_cap,) int32 first global id
    pt_host: np.ndarray
    nvalid_host: np.ndarray
    offset_host: np.ndarray
    host_pages: dict                   # slot -> (R, m) host page
    extents: tuple
    free_pool: tuple
    free_tail: tuple
    page_rows: int
    seal_rows: int

    # -- shape ---------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def dtype(self) -> torch.dtype:
        return self.pool.dtype

    @property
    def pool_pages(self) -> int:
        return self.pool.shape[0]

    @property
    def dim(self) -> int:
        return self.pool.shape[2]

    @property
    def quantized(self) -> bool:
        return self.page_scale is not None

    @property
    def scale_host(self) -> np.ndarray | None:
        """Host view of ``page_scale``: each extent's scale on its slots."""
        if self.page_scale is None:
            return None
        sc = np.zeros((self.pt_host.shape[0], self.dim), np.float32)
        for e in self.extents:
            sc[e.start_slot:e.start_slot + e.n_pages] = e.scale
        return sc

    @property
    def n_slots(self) -> int:
        return sum(e.n_pages for e in self.extents)

    @property
    def n_rows(self) -> int:
        return sum(e.n_rows for e in self.extents)

    @property
    def delta_pages(self) -> int:
        return sum(e.n_pages for e in self.extents if e.kind == "delta")

    @property
    def n_host_pages(self) -> int:
        return len(self.host_pages)

    @property
    def nbytes(self) -> int:
        """Device bytes: both tiers and the metadata."""
        b = self.pool.numel() * self.pool.element_size()
        b += self.tail.numel() * self.tail.element_size()
        b += 4 * (self.page_table.numel() + self.page_nvalid.numel()
                  + self.page_offset.numel())
        if self.page_scale is not None:
            b += 4 * self.page_scale.numel()
        return b

    def _stored(self, rows: np.ndarray) -> torch.Tensor:
        """f32 rows (numpy) as a host tensor in the storage dtype."""
        return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(self.dtype)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_index(cls, base: DenseIndex, *, page_rows: int = 256,
                   pool_pages: int | None = None,
                   seal_rows: int = 4096) -> "PagedIndexStorage":
        """Page an immutable base index on its own device. The pool is
        filled by a device-side copy. ``pool_pages`` below the base's page
        count oversubscribes: the overflow suffix lives on the host tier.
        The tail arena holds two sealed extents' pages and the table has
        room for twice the pages, as the reference's defaults size them."""
        return cls._paged(base, page_rows, pool_pages, seal_rows,
                          max(2 * (-(-seal_rows // page_rows)), 2))

    @classmethod
    def _paged(cls, base: DenseIndex, R: int, pool_pages: int | None,
               seal_rows: int, tail_pages: int) -> "PagedIndexStorage":
        vec = base.vectors
        dev = vec.device
        scale = (None if base.scale is None
                 else base.scale.float().cpu().numpy())
        n, m = vec.shape
        npages = -(-n // R) if n else 0
        if pool_pages is None:
            pool_pages = npages + max(tail_pages, 8)
        pool_pages = max(pool_pages, 1)
        table_cap = max(2 * (npages + tail_pages) + 8, 16)

        res = min(npages, pool_pages)
        pt = np.full(table_cap, -1, np.int32)
        pt[:res] = np.arange(res, dtype=np.int32)
        starts = np.arange(npages, dtype=np.int64) * R
        nv = np.zeros(table_cap, np.int32)
        nv[:npages] = np.minimum(R, n - starts)
        off = np.zeros(table_cap, np.int32)
        off[:npages] = starts
        sc = None
        if scale is not None:
            sc = np.zeros((table_cap, m), np.float32)
            sc[:npages] = scale
        pool = torch.zeros((pool_pages, R, m), dtype=vec.dtype, device=dev)
        rows_res = min(n, res * R)
        pool.view(-1, m)[:rows_res].copy_(vec[:rows_res])
        host_pages: dict = {}
        if npages > res:
            block = _host_zeros((npages - res, R, m), vec.dtype, dev)
            block.view(-1, m)[:n - rows_res].copy_(vec[rows_res:])
            host_pages = {res + i: block[i] for i in range(npages - res)}
        extents = ((PageExtent("base", True, 0, npages, n, 0, scale, None),)
                   if n else ())
        st = cls(
            pool=pool, tail=torch.zeros((tail_pages, R, m), dtype=vec.dtype, device=dev),
            page_table=_to_device(pt, dev),
            page_scale=None if sc is None else _to_device(sc, dev),
            page_nvalid=_to_device(nv, dev), page_offset=_to_device(off, dev),
            pt_host=pt, nvalid_host=nv, offset_host=off,
            host_pages=host_pages, extents=extents,
            free_pool=tuple(range(res, pool_pages)),
            free_tail=tuple(range(tail_pages)), page_rows=R,
            seal_rows=seal_rows)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return st

    @classmethod
    def from_segmented(cls, seg: SegmentedIndex, *, page_rows: int = 256,
                       pool_pages: int | None = None) -> "PagedIndexStorage":
        """Page a live segmented index byte for byte: the base into the
        pool, each delta into a delta extent in the tail with its own scale
        (and its exact f32 staging while it is open). ``seal_rows`` adopts
        the delta capacity, so later appends evolve the scales as the
        segmented index would have. The tail holds the adopted deltas'
        pages plus one open extent's, and at least two extents' (the
        reference's sizing)."""
        R = page_rows
        per_delta = -(-seg.delta_capacity // R)
        need_tail = sum(-(-d.capacity // R) for d in seg.deltas)
        st = cls._paged(seg.base, R, pool_pages, seg.delta_capacity,
                        max(2 * per_delta, need_tail + per_delta, 2))
        for d in seg.deltas:
            sealed = d.n_real >= d.capacity
            st = st._adopt_extent(
                d.vectors[:d.n_real].cpu(),
                None if d.scale is None else d.scale.float().cpu().numpy(),
                raw=None if sealed else d.raw, sealed=sealed)
        return st

    def _adopt_extent(self, stored: torch.Tensor, scale: np.ndarray | None, *,
                      raw: np.ndarray | None, sealed: bool) -> "PagedIndexStorage":
        """Append a whole pre-quantised extent (a segmented delta)."""
        mut = _Mut(self)
        R = self.page_rows
        start_slot = self.n_slots
        row_offset = self.n_rows
        n = stored.shape[0]
        npages = -(-n // R) if n else 0
        for pi in range(npages):
            slot = start_slot + pi
            mut.alloc_page(slot, row_offset + pi * R)
            mut.write_rows(slot, 0, stored[pi * R:(pi + 1) * R])
        mut.extents.append(PageExtent("delta", sealed, start_slot, npages,
                                      n, row_offset, scale, raw))
        return mut.freeze()

    def extent_rows(self, ei: int, start: int = 0, stop: int | None = None
                    ) -> torch.Tensor:
        """Rows [start, stop) of extent ``ei`` (default: all of them), its
        stored bytes in global-id order, as a host tensor in the storage
        dtype. Each page comes off the tier that holds it: pool and tail
        pages in one device gather per tier and one copy to the host, host
        pages as they are. The persistence source (``save_paged_index``)
        and the staging reconstruction of a reloaded open extent."""
        e = self.extents[ei]
        R = self.page_rows
        stop = e.n_rows if stop is None else stop
        if not 0 <= start <= stop <= e.n_rows:
            raise ValueError(f"row range [{start}, {stop}) outside extent "
                             f"{ei}'s [0, {e.n_rows})")
        p0, p1 = start // R, -(-stop // R)
        phys = self.pt_host[e.start_slot + p0:e.start_slot + p1]
        out = torch.empty((p1 - p0, R, self.dim), dtype=self.dtype)
        P = self.pool_pages
        for tier, sel, first in ((self.pool, (phys >= 0) & (phys < P), 0),
                                 (self.tail, phys >= P, P)):
            sel = np.flatnonzero(sel)
            if sel.size:
                idx = torch.from_numpy(phys[sel].astype(np.int64) - first)
                out[torch.from_numpy(sel)] = tier[idx.to(tier.device)].cpu()
        for i in np.flatnonzero(phys < 0):
            out[i] = self.host_pages[e.start_slot + p0 + int(i)]
        return out.view(-1, self.dim)[start - p0 * R:stop - p0 * R]

    # -- growth (copy-on-write) ---------------------------------------------
    def append_with_ops(self, rows) -> tuple["PagedIndexStorage", list]:
        """Append f32 rows; page-pointer swaps only.

        Rows land in the open delta extent (tail pages, host pages once the
        arena is full), which seals at ``seal_rows``. int8 scale evolution
        is the reference's: a fresh per-dim scale per extent; widening =
        ``max(old, need)`` and a requantisation of the extent from its f32
        staging. Returns the same op stream as the reference
        (("open" | "extend" | "widen"), delta ordinal, stored rows[, scale]),
        the stored rows as host tensors.
        """
        rows = np.atleast_2d(np.asarray(
            rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows,
            np.float32))
        if rows.shape[1] != self.dim:
            raise ValueError(f"append expects (rows, {self.dim}), got "
                             f"{tuple(rows.shape)}")
        st = self
        ops_: list = []
        pos = 0
        while pos < rows.shape[0]:
            mut = _Mut(st)
            open_ei = None
            if (mut.extents and mut.extents[-1].kind == "delta"
                    and not mut.extents[-1].sealed):
                open_ei = len(mut.extents) - 1
            ordinal = sum(1 for e in mut.extents if e.kind == "delta")
            if open_ei is not None:
                ext = mut.extents[open_ei]
                ordinal -= 1
                take = min(rows.shape[0] - pos, st.seal_rows - ext.n_rows)
                block = rows[pos:pos + take]
                raw = np.concatenate([ext.raw, block])
                if ext.scale is not None:
                    need = scale_for(block)
                    scale = np.maximum(ext.scale, need).astype(np.float32)
                    if bool((scale > ext.scale).any()):
                        stored_all = quantize_with_scale(raw, scale)
                        stored_all = torch.from_numpy(stored_all)
                        st = st._widen_extent(mut, open_ei, raw, stored_all,
                                              scale)
                        ops_.append(("widen", ordinal, stored_all, scale))
                        pos += take
                        continue
                    stored = torch.from_numpy(quantize_with_scale(block, ext.scale))
                else:
                    stored = st._stored(block)
                st = st._extend_extent(mut, open_ei, raw, stored)
                ops_.append(("extend", ordinal, stored))
            else:
                take = min(rows.shape[0] - pos, st.seal_rows)
                block = rows[pos:pos + take]
                if st.quantized:
                    scale = scale_for(block)
                    stored = torch.from_numpy(quantize_with_scale(block, scale))
                else:
                    scale = None
                    stored = st._stored(block)
                st = st._open_extent(mut, stored, scale, block)
                ops_.append(("open", ordinal, stored, scale))
            pos += take
        return st, ops_

    def append(self, rows) -> "PagedIndexStorage":
        return self.append_with_ops(rows)[0]

    def _open_extent(self, mut: _Mut, stored: torch.Tensor,
                     scale: np.ndarray | None,
                     raw: np.ndarray) -> "PagedIndexStorage":
        R = self.page_rows
        start_slot = self.n_slots
        row_offset = self.n_rows
        n = stored.shape[0]
        npages = -(-n // R)
        for pi in range(npages):
            slot = start_slot + pi
            mut.alloc_page(slot, row_offset + pi * R)
            mut.write_rows(slot, 0, stored[pi * R:(pi + 1) * R])
        sealed = n >= self.seal_rows
        mut.extents.append(PageExtent(
            "delta", sealed, start_slot, npages, n, row_offset, scale,
            None if sealed else np.ascontiguousarray(raw)))
        return mut.freeze()

    def _extend_extent(self, mut: _Mut, ei: int, raw: np.ndarray,
                       stored: torch.Tensor) -> "PagedIndexStorage":
        R = self.page_rows
        ext = mut.extents[ei]
        r = ext.n_rows
        pos = 0
        n_pages = ext.n_pages
        while pos < stored.shape[0]:
            pi = r // R
            slot = ext.start_slot + pi
            if pi >= n_pages:              # grow the (last) open extent
                mut.alloc_page(slot, ext.row_offset + pi * R)
                n_pages = pi + 1
            in_page = r - pi * R
            chunk = min(stored.shape[0] - pos, R - in_page)
            mut.write_rows(slot, in_page, stored[pos:pos + chunk])
            pos += chunk
            r += chunk
        n = ext.n_rows + stored.shape[0]
        sealed = n >= self.seal_rows
        mut.extents[ei] = ext._replace(
            n_pages=n_pages, n_rows=n, sealed=sealed,
            raw=None if sealed else raw)
        return mut.freeze()

    def _widen_extent(self, mut: _Mut, ei: int, raw: np.ndarray,
                      stored_all: torch.Tensor,
                      scale: np.ndarray) -> "PagedIndexStorage":
        """The scale widened: requantise the whole (open, so at most
        ``seal_rows``-row) extent from its f32 staging and rewrite its
        pages."""
        R = self.page_rows
        ext = mut.extents[ei]
        n = stored_all.shape[0]
        npages = -(-n // R)
        for pi in range(npages):
            slot = ext.start_slot + pi
            if pi >= ext.n_pages:
                mut.alloc_page(slot, ext.row_offset + pi * R)
            mut.write_rows(slot, 0, stored_all[pi * R:(pi + 1) * R])
        sealed = n >= self.seal_rows
        mut.extents[ei] = ext._replace(
            n_pages=npages, n_rows=n, sealed=sealed, scale=scale,
            raw=None if sealed else raw)
        return mut.freeze()

    # -- lifecycle: pointer swaps -------------------------------------------
    def promote(self) -> tuple["PagedIndexStorage", int]:
        """Sealed delta extents become base extents: metadata only.
        Returns (new storage, extents promoted)."""
        promoted = 0
        extents = []
        for e in self.extents:
            if e.kind == "delta" and e.sealed:
                extents.append(e._replace(kind="base"))
                promoted += 1
            else:
                extents.append(e)
        if not promoted:
            return self, 0
        return dataclasses.replace(self, extents=tuple(extents)), promoted

    def compact(self) -> tuple["PagedIndexStorage", dict]:
        """Seal and promote every delta extent, then move its tail pages
        into free pool slots with one gather (``_pool_drain``). No
        requantisation; the statistics count pages."""
        mut = _Mut(self)
        for ei, e in enumerate(mut.extents):
            if e.kind == "delta":
                mut.extents[ei] = e._replace(kind="base", sealed=True,
                                             raw=None)
        sel = np.full(self.pool_pages, -1, np.int32)
        moved = 0
        for e in mut.extents:
            for pi in range(e.n_pages):
                slot = e.start_slot + pi
                phys = int(mut.pt[slot])
                if phys >= self.pool_pages and mut.free_pool:
                    dst = mut.free_pool.pop(0)
                    sel[dst] = phys - self.pool_pages
                    mut.set_page(slot, dst)
                    mut.free_tail.append(phys - self.pool_pages)
                    moved += 1
        pool = (_pool_drain(self.pool, self.tail, _to_device(sel, self.device))
                if moved else None)
        stats = {"pages_moved": moved, "pages_freed": moved,
                 "pages_host": len(mut.host_pages)}
        return mut.freeze(pool=pool), stats

    def evict(self, n_pages: int) -> tuple["PagedIndexStorage", int]:
        """Move the highest-slot pool pages to the host tier (a pointer swap
        and one device-to-host copy of the pages). Evicting a suffix keeps
        slots ascending, so results do not change."""
        mut = _Mut(self)
        ns = self.n_slots
        cands = [s for s in range(ns)
                 if 0 <= mut.pt[s] < self.pool_pages][::-1][:n_pages]
        if cands:
            phys = [int(mut.pt[s]) for s in cands]
            block = _host_zeros((len(cands), self.page_rows, self.dim),
                                self.dtype, self.device)
            block.copy_(self.pool[torch.tensor(phys, device=self.device)])
            for i, slot in enumerate(cands):
                mut.host_pages[slot] = block[i]
                mut.free_pool.append(phys[i])
                mut.set_page(slot, -1)
        return mut.freeze(), len(cands)


@dataclasses.dataclass(frozen=True, eq=False)
class PagedIndex:
    """Search facade over ``PagedIndexStorage``, with the reference's
    ``search`` / ``search_projected`` / ``append`` surface and its
    copy-on-write swap discipline.

    ``depth`` is how many host-tier waves are staged ahead of the one being
    scored (depth - 1) plus one; ``wave_pages`` bounds a wave, so an
    oversubscribed search streams host pages in fixed-size waves chained
    through the top-k carry. The index searches on its storage's device.
    """

    storage: PagedIndexStorage
    depth: int = 2
    wave_pages: int = 8

    # -- shape ---------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.storage.n_rows

    @property
    def dim(self) -> int:
        return self.storage.dim

    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def nbytes(self) -> int:
        return self.storage.nbytes

    @property
    def quantized(self) -> bool:
        return self.storage.quantized

    @property
    def delta_pages(self) -> int:
        return self.storage.delta_pages

    @property
    def total_pages(self) -> int:
        return self.storage.n_slots

    # -- construction --------------------------------------------------------
    @classmethod
    def from_index(cls, base: DenseIndex, *, page_rows: int = 256,
                   pool_pages: int | None = None, seal_rows: int = 4096,
                   depth: int = 2, wave_pages: int = 8) -> "PagedIndex":
        st = PagedIndexStorage.from_index(
            base, page_rows=page_rows, pool_pages=pool_pages,
            seal_rows=seal_rows)
        return cls(storage=st, depth=depth, wave_pages=wave_pages)

    @classmethod
    def from_segmented(cls, seg: SegmentedIndex, *, page_rows: int = 256,
                       pool_pages: int | None = None, depth: int = 2,
                       wave_pages: int = 8) -> "PagedIndex":
        st = PagedIndexStorage.from_segmented(seg, page_rows=page_rows,
                                              pool_pages=pool_pages)
        return cls(storage=st, depth=depth, wave_pages=wave_pages)

    # -- persistence ---------------------------------------------------------
    @classmethod
    def load(cls, store, *, page_rows: int | None = None,
             pool_pages: int | None = None, seal_rows: int | None = None,
             depth: int = 2, wave_pages: int = 8, device=None) -> "PagedIndex":
        """Page an on-disk artifact bit for bit onto ``device`` (default:
        the card).

        A store written by ``save_paged_index`` carries the ``paged``
        manifest block (page geometry + extent lifecycle); extent i's bytes
        are segment i's bytes, so the load reuses the segmented
        rehydration, then re-applies the recorded extent kinds. The block
        may LAG the segments (a crash between the append mirror's two
        manifest swaps): missing trailing extents reload as deltas, and
        sealed-ness is reconstructed conservatively (every non-last extent
        is sealed; the last one by row count or the fresh block entry). A
        plain segmented store (no block) pages directly. ``pool_pages``
        below the resident page count oversubscribes: the overflow streams
        from the host tier at search time.
        """
        store = _open_store(store)
        dev = default_device(device)
        pb = store.manifest.get("paged")
        if pb is not None:
            R = int(pb["page_rows"]) if page_rows is None else page_rows
            S = int(pb["seal_rows"]) if seal_rows is None else seal_rows
        else:
            R = 256 if page_rows is None else page_rows
            S = 4096 if seal_rows is None else seal_rows
        if pb is not None and pb["extents"] and pb["extents"][0]["kind"] == "delta":
            # extent 0 is itself a delta (an index grown from empty): adopt
            # every segment through the writable tiers (tail/host) over a
            # zero-row base, since pool pages take no writes
            views = store.segments()
            s0 = views[0].scale()
            shim = DenseIndex(
                vectors=torch.zeros((0, store.dim), dtype=store.dtype, device=dev),
                scale=None if s0 is None else torch.from_numpy(s0).to(dev))
            st = PagedIndexStorage.from_index(shim, page_rows=R,
                                              pool_pages=pool_pages, seal_rows=S)
            for v in views:
                st = st._adopt_extent(v.read_rows(0, v.n, device="cpu"), v.scale(),
                                      raw=None, sealed=True)
        else:
            seg = SegmentedIndex.load(store, delta_capacity=S, device=dev)
            st = PagedIndexStorage.from_segmented(seg, page_rows=R,
                                                  pool_pages=pool_pages)
        if pb is not None and st.extents:
            pbe = pb["extents"]
            exts = list(st.extents)
            for i, ext in enumerate(exts):
                kind = pbe[i]["kind"] if i < len(pbe) else "delta"
                fresh = i < len(pbe) and int(pbe[i]["n"]) == ext.n_rows
                sealed = (i < len(exts) - 1 or ext.n_rows >= S
                          or (fresh and bool(pbe[i]["sealed"])))
                raw = ext.raw
                if not sealed and raw is None:
                    raw = st.extent_rows(i).float().numpy()
                    if ext.scale is not None:
                        raw = raw * ext.scale[None, :].astype(np.float32)
                exts[i] = ext._replace(kind=kind, sealed=sealed,
                                       raw=None if sealed else raw)
            st = dataclasses.replace(st, extents=tuple(exts))
        return cls(storage=st, depth=depth, wave_pages=wave_pages)

    def save(self, path: str, *, pruner=None, meta: dict | None = None):
        """Persist page-granularly (see ``store.save_paged_index``)."""
        return save_paged_index(path, self, pruner=pruner, meta=meta)

    # -- growth --------------------------------------------------------------
    def append_with_ops(self, rows) -> tuple["PagedIndex", list]:
        st, ops_ = self.storage.append_with_ops(rows)
        return dataclasses.replace(self, storage=st), ops_

    def append(self, rows) -> "PagedIndex":
        return self.append_with_ops(rows)[0]

    def promote(self) -> tuple["PagedIndex", int]:
        st, n = self.storage.promote()
        return dataclasses.replace(self, storage=st), n

    def compact_pages(self) -> tuple["PagedIndex", dict]:
        st, stats = self.storage.compact()
        return dataclasses.replace(self, storage=st), stats

    def evict(self, n_pages: int) -> tuple["PagedIndex", int]:
        st, n = self.storage.evict(n_pages)
        return dataclasses.replace(self, storage=st), n

    # -- search --------------------------------------------------------------
    def _runs(self) -> list:
        """Maximal contiguous slot ranges per tier, ascending: device runs
        search the tiers in place, host runs stream waves."""
        ns = self.storage.n_slots
        if ns == 0:
            return []
        on_dev = self.storage.pt_host[:ns] >= 0
        edges = np.flatnonzero(on_dev[1:] != on_dev[:-1]) + 1
        starts = [0, *edges.tolist()]
        ends = [*edges.tolist(), ns]
        return [(a, b, bool(on_dev[a])) for a, b in zip(starts, ends)]

    def _device_args(self):
        st = self.storage
        return (st.pool, st.tail, st.page_table, st.page_scale,
                st.page_nvalid, st.page_offset)

    def _search_qf(self, qf: torch.Tensor, k: int):
        runs = self._runs()
        B = qf.shape[0]
        if not runs:
            return (torch.full((B, k), float("-inf"), device=qf.device),
                    torch.full((B, k), -1, dtype=torch.int32, device=qf.device))
        out = None
        for idx, (lo, hi, dev) in enumerate(runs):
            last = idx == len(runs) - 1
            if dev:
                out = _paged_topk(*self._device_args(), lo, hi, qf, k=k,
                                  carry=out, finalize=last)
            else:
                out = self._host_run_topk(qf, k, lo, hi, out, finalize=last)
        return out

    def _waves(self, lo: int, hi: int) -> list:
        slots = list(range(lo, hi))
        W = self.wave_pages
        return [slots[i:i + W] for i in range(0, len(slots), W)]

    def _stage_wave(self, slots: list, buf: torch.Tensor | None
                    ) -> torch.Tensor:
        """Host pages -> one wave of ``wave_pages`` pages on the device. On
        the card the pages are gathered into the pinned ``buf`` and copied
        without blocking the host."""
        st = self.storage
        pages = [st.host_pages[s] for s in slots]
        shape = (self.wave_pages, st.page_rows, st.dim)
        if buf is None:
            wave = torch.zeros(shape, dtype=st.dtype, device=st.device)
            wave[:len(slots)] = torch.stack(pages)
        else:
            torch.stack(pages, out=buf[:len(slots)])
            wave = torch.empty(shape, dtype=st.dtype, device=st.device)
            wave.copy_(buf, non_blocking=True)
        return wave

    def _host_run_topk(self, qf, k, lo, hi, carry, *, finalize):
        """Stream a host run in waves of consecutive slots. A wave is a pool
        of its own behind the table 0..wave_pages-1; its row counts, offsets
        and scales are slices of the storage's device metadata, which covers
        host slots too. On the card ``depth`` pinned staging buffers form a
        ring: ``depth - 1`` waves are gathered and their copies queued ahead
        of the wave being scored, and a buffer is refilled only once the
        event recorded after the kernel that read its wave has completed."""
        waves = self._waves(lo, hi)
        st = self.storage
        on_card = st.device.type == "cuda"
        depth = max(self.depth, 1)
        table = torch.arange(self.wave_pages, dtype=torch.int32, device=st.device)
        ring = ([torch.empty((self.wave_pages, st.page_rows, st.dim),
                             dtype=st.dtype, pin_memory=True)
                 for _ in range(min(depth, len(waves)))] if on_card else None)
        done: list = [None] * (len(ring) if ring else 0)
        staged: list = []
        nxt = 0
        out = carry
        for wi, slots in enumerate(waves):
            while nxt < len(waves) and nxt <= wi + depth - 1:
                buf = None
                if on_card:
                    slot = nxt % len(ring)
                    if done[slot] is not None:
                        done[slot].synchronize()
                    buf = ring[slot]
                staged.append(self._stage_wave(waves[nxt], buf))
                nxt += 1
            w0, w1 = slots[0], slots[-1] + 1
            out = _paged_topk(staged.pop(0), None, table,
                              None if st.page_scale is None else st.page_scale[w0:w1],
                              st.page_nvalid[w0:w1], st.page_offset[w0:w1], 0,
                              w1 - w0, qf, k=k, carry=out,
                              finalize=finalize and wi == len(waves) - 1)
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                done[wi % len(ring)] = ev
        return out

    def search(self, queries, k: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k of pre-projected queries. Returns (scores (B, k) f32,
        ids (B, k) int32)."""
        q = torch.atleast_2d(as_tensor(queries, self.device)).float()
        return self._search_qf(q, min(k, max(self.n, 1)))

    def search_projected(self, queries, components, k: int = 10, *,
                         mean=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw-query search: centre and project (no scale fold), then the
        paged walk, which folds each page's scale. A fully resident index
        is one paged top-k; an oversubscribed one chains its runs."""
        dev = self.device
        k = min(k, max(self.n, 1))
        W = as_tensor(components, dev)
        mu = None if mean is None else as_tensor(mean, dev)
        Q = torch.atleast_2d(as_tensor(queries, dev))
        return self._search_qf(_project_nofold(Q, W, mu), k)

    # -- cascade rescore -----------------------------------------------------
    def _shortlist_rows(self, uids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(rows, slot)``: each shortlist uid's stored row (U, m) and the
        logical slot of its page, on the device. A uid's page is found by
        its first global id (``page_offset``, ascending over the slots);
        pool and tail rows are gathered through the page table, the rows in
        host pages on the host, crossing in one copy. A uid outside [0, n)
        gets a clamped row, masked by the caller."""
        st = self.storage
        dev = st.device
        u = uids.long().clamp(0, self.n - 1)
        offs = st.page_offset[:st.n_slots].long()
        slot = torch.searchsorted(offs, u, right=True) - 1
        r = u - offs[slot]
        P, T = st.pool_pages, st.tail.shape[0]
        phys = st.page_table[slot].long()
        rows = st.pool[phys.clamp(0, P - 1), r]
        if T:
            rows = torch.where((phys >= P)[:, None],
                               st.tail[(phys - P).clamp(0, T - 1), r], rows)
        if st.host_pages:
            sr = torch.stack([slot, r]).cpu().numpy()
            hit = np.flatnonzero(st.pt_host[sr[0]] < 0)
            if hit.size:
                got = torch.stack([st.host_pages[s][i] for s, i in sr[:, hit].T.tolist()])
                rows[_to_device(hit, dev)] = _to_device(got, dev)
        return rows, slot

    def rescore(self, qf: torch.Tensor, uids: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-``k`` of the shortlist ``uids`` (the cascade's second
        stage) for projected queries ``qf``: the shortlist rows are gathered
        off every tier once, then scored by ``ops.topk_score`` in its
        ``row_ids`` mode, one call per extent of an int8 index (each folds
        its extent's scale, the uids of other extents set to -1), one call
        in all for a float index. The parts merge in ascending id order, so
        the result is bitwise a segmented index's rescore over the same
        bytes and scales."""
        st = self.storage
        if not self.n:
            B = qf.shape[0]
            return (torch.full((B, k), float("-inf"), device=qf.device),
                    torch.full((B, k), -1, dtype=torch.int32, device=qf.device))
        rows, slot = self._shortlist_rows(uids)
        valid = (uids >= 0) & (uids < self.n)
        if st.page_scale is None:
            ids = torch.where(valid, uids, torch.full_like(uids, -1))
            return ops.topk_score(rows, qf.float().contiguous(), k=k, row_ids=ids)
        parts = []
        for e in st.extents:
            if not e.n_rows:
                continue
            q = qf.float() * st.page_scale[e.start_slot][None, :]
            mine = valid & (slot >= e.start_slot) & (slot < e.start_slot + e.n_pages)
            ids = torch.where(mine, uids, torch.full_like(uids, -1))
            parts.append(ops.topk_score(rows, q.contiguous(), k=k, row_ids=ids))
        return merge_segment_topk(parts, k)
