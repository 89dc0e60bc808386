"""On-disk index artifact store (port of ``repro/core/store.py``): the
paper's offline object, made durable.

Static pruning is query independent and runs offline, so what it hands
over is a file on disk. The layout is the reference's, byte for byte, so a
store written by either package opens, validates and loads in the other:

    <dir>/
      manifest.json          # version, n, dim, logical dtype, chunk list,
                             # pca/scale file names, free-form meta
      pca.npz                # PCAState (W, Λ, mean) — save_pca format
      scale.npy              # per-dim int8 dequant scale (int8 stores only)
      vectors_000000.npy     # row chunk 0
      vectors_000001.npy     # row chunk 1 ...

A build writes into ``<dir>.tmp`` with every blob fsynced, then renames the
directory into place and fsyncs the parent (``checkpoint.fsio.commit_dir``),
so a crashed build is never mistaken for a committed artifact;
``IndexStore.open`` validates the manifest against the blobs it names
(version, chunk presence, per-chunk shape, row-count sum) and rejects a
tampered or partly copied directory loudly.

Appends to a committed store use blob-then-manifest: the new chunk is
written and fsynced, then the manifest is atomically replaced
(``os.replace`` + dir fsync). A crash between the two leaves an orphan blob
the manifest never names, which is still a valid store.

**Segments.** A live store may carry a ``segments`` list: segment 0 is the
immutable base, later entries are delta segments, each with its own chunk
list, its OWN ``scale_file`` and a ``capacity``. The top-level
``n``/``chunks``/``scale_file`` stay the derived global view, so a
pre-segment manifest is a valid single-base segmented store.

**Resolutions.** A manifest may carry ``resolutions``: coarse views of the
base rows at a smaller width m (the leading PCA columns), with their own
dtype, scale and optional coarse deltas. ``save_index`` of a
``CascadeIndex`` writes them; ``CascadeIndex.load`` reads them back.

Reads are host-streamed: chunks are memory-mapped, and ``DenseIndex.load``
copies them one slice at a time into a preallocated device tensor, through
two pinned staging buffers on the card. Writes take tensors on any device;
each chunk crosses to the host once. bfloat16 has no ``.npy`` encoding:
bf16 chunks are stored as their ``uint16`` bit pattern and the manifest
keeps the logical dtype ``"bfloat16"``; reads give bf16 tensors back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.fsio import commit_dir, fsync_dir, fsync_file, write_json_fsync
from repro_torch.util import default_device

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
PCA_FILE = "pca.npz"
SCALE_FILE = "scale.npy"

# logical dtypes with no native .npy encoding -> raw storage view
_STORAGE_VIEW = {"bfloat16": np.uint16}

# host bytes per pinned staging buffer of a load to the card (two of them)
_STAGE_BYTES = 64 << 20


class IndexStoreError(RuntimeError):
    """A store directory is missing, corrupted, or inconsistent."""


def _meta_of(pruner) -> dict:
    return {} if pruner is None else dict(
        kept_dims=int(pruner.kept_dims),
        source_dim=int(pruner.state.d),
        cutoff=float(pruner.effective_cutoff),
        centered=bool(pruner.state.centered))


def save_index(path: str, index, *, pruner=None, meta: dict | None = None,
               chunk_rows: int = 262144) -> "IndexStore":
    """Persist an already-built ``DenseIndex``, ``SegmentedIndex``,
    ``PagedIndex`` or ``CascadeIndex`` (on any device).

    Rows are copied device→host one ``chunk_rows`` slice at a time, so the
    host transient is one chunk. Pass the fitted ``pruner`` to persist the
    PCA state alongside (``IndexStore.load_pruner`` and ``serve
    --load-index`` need it to transform queries).
    """
    from repro_torch.core.cascade import CascadeIndex
    from repro_torch.core.index import SegmentedIndex
    from repro_torch.core.paged import PagedIndex
    if isinstance(index, PagedIndex):
        return save_paged_index(path, index, pruner=pruner, meta=meta,
                                chunk_rows=chunk_rows)
    if isinstance(index, CascadeIndex):
        # the full resolution commits through the flat, segmented or paged
        # path; the coarse base rides along as a `resolutions` entry, with
        # the coarse delta segments (or a paged coarse side's later
        # extents) as its deltas, their exact bytes and scales
        store = save_index(path, index.full, pruner=pruner, meta=meta,
                           chunk_rows=chunk_rows)
        coarse = index.coarse
        if isinstance(coarse, PagedIndex):
            cst = coarse.storage
            exts = cst.extents
            base_rows = (cst.extent_rows(0) if exts
                         else torch.zeros((0, cst.dim), dtype=cst.dtype))
            base_scale = exts[0].scale if exts else None
            coarse_deltas = [{"rows": cst.extent_rows(i), "scale": e.scale,
                              "capacity": cst.seal_rows}
                             for i, e in enumerate(exts) if i > 0]
        else:
            cb = getattr(coarse, "base", coarse)
            base_rows, base_scale = cb.vectors[:cb.n], cb.scale
            coarse_deltas = [{"rows": d.vectors[:d.n_real], "scale": d.scale,
                              "capacity": d.capacity}
                             for d in getattr(coarse, "deltas", ())]
        store.add_resolution(base_rows, scale=base_scale, chunk_rows=chunk_rows,
                             deltas=coarse_deltas)
        return store
    if isinstance(index, SegmentedIndex):
        # the base commits through the flat path, then each delta replays
        # as a durable segment mutation with its own scale and capacity
        store = save_index(path, index.base, pruner=pruner, meta=meta,
                           chunk_rows=chunk_rows)
        for d in index.deltas:
            name = store.add_delta(scale=d.scale, capacity=d.capacity)
            if d.n_real:
                store.append(d.vectors[:d.n_real], segment=name)
        return store
    writer = IndexStoreWriter(path)
    with writer:
        if pruner is not None:
            writer.put_pca(pruner.state)
        if index.scale is not None:
            writer.set_scale(index.scale)
        v = index.vectors
        n = index.n
        for start in range(0, n, chunk_rows):
            writer.append(v[start:min(start + chunk_rows, n)])
        info = _meta_of(pruner)
        info["quantize_int8"] = index.scale is not None
        info.update(meta or {})
        return writer.commit(meta=info)


def paged_manifest_block(storage) -> dict:
    """The ``paged`` manifest entry for a ``PagedIndexStorage``: page
    geometry plus per-extent lifecycle state. Extent i's rows are store
    segment i's rows, paged ascending, so the block stays tiny."""
    return {"page_rows": int(storage.page_rows),
            "seal_rows": int(storage.seal_rows),
            "extents": [{"kind": e.kind, "sealed": bool(e.sealed),
                         "n": int(e.n_rows)} for e in storage.extents]}


def save_paged_index(path: str, index, *, pruner=None,
                     meta: dict | None = None,
                     chunk_rows: int = 262144) -> "IndexStore":
    """Persist a ``PagedIndex``: one store segment per extent, chunked in
    whole pages, plus the ``paged`` manifest block. Each chunk's bytes are
    gathered off the page tiers (pool, tail, host) with
    ``PagedIndexStorage.extent_rows``, so the artifact is bit-identical to
    what was serving; the final ``set_paged_state`` manifest swap is the
    commit point for the lifecycle metadata."""
    st = index.storage
    R = st.page_rows
    chunk_rows = max(chunk_rows // R, 1) * R     # never split a page
    exts = st.extents
    writer = IndexStoreWriter(path)
    with writer:
        if pruner is not None:
            writer.put_pca(pruner.state)
        base_scale = exts[0].scale if exts else None
        if base_scale is not None:
            writer.set_scale(base_scale)
        if exts:
            for s in range(0, exts[0].n_rows, chunk_rows):
                writer.append(st.extent_rows(0, s, min(s + chunk_rows, exts[0].n_rows)))
        info = _meta_of(pruner)
        info["quantize_int8"] = st.quantized
        info.update(meta or {})
        store = writer.commit(meta=info)
    for ei in range(1, len(exts)):
        e = exts[ei]
        name = store.add_delta(scale=e.scale, capacity=st.seal_rows)
        for s in range(0, e.n_rows, chunk_rows):
            store.append(st.extent_rows(ei, s, min(s + chunk_rows, e.n_rows)),
                         segment=name)
    store.set_paged_state(paged_manifest_block(st))
    return store


# ---------------------------------------------------------------------------
# chunk encoding: numpy on disk, torch in memory
# ---------------------------------------------------------------------------


def _torch_dtype(logical: str) -> torch.dtype:
    """The torch dtype of a manifest's logical dtype name."""
    dt = getattr(torch, logical, None)
    if not isinstance(dt, torch.dtype):
        raise IndexStoreError(f"unsupported store dtype {logical!r}")
    return dt


def _storage_array(block) -> tuple[np.ndarray, str]:
    """``(host array as written to .npy, logical dtype name)`` of a block:
    a tensor on any device (copied to the host once) or a numpy array.
    bf16 is written as its ``uint16`` bit pattern."""
    if isinstance(block, torch.Tensor):
        t = block.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        a = t.cpu().numpy()
        return a, a.dtype.name
    a = np.asarray(block)
    if a.dtype.name in _STORAGE_VIEW:            # e.g. an ml_dtypes bf16 array
        return a.view(_STORAGE_VIEW[a.dtype.name]), a.dtype.name
    return a, a.dtype.name


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _np_view(t: torch.Tensor) -> np.ndarray:
    """A writable numpy view of a CPU tensor's storage (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A CPU tensor of the logical dtype over a storage array (copied
    first when read-only, e.g. memory-mapped)."""
    a = arr if arr.flags.writeable else np.array(arr)
    if logical in _STORAGE_VIEW:
        return torch.from_numpy(a.view(np.int16)).view(_torch_dtype(logical))
    return torch.from_numpy(a)


def _write_chunk(path: str, block) -> None:
    """Write and fsync one chunk (a tensor or its storage array)."""
    np.save(path, _storage_array(block)[0])
    fsync_file(path)


def _save_scale(path: str, scale) -> None:
    np.save(path, _host_f32(scale))
    fsync_file(path)


def _read_chunk(path: str, mmap: bool = True) -> np.ndarray:
    """A chunk as stored (bf16 chunks in their uint16 view),
    memory-mapped by default."""
    return np.load(path, mmap_mode="r" if mmap else None)


def _read_chunk_validated(store_path: str, fpath: str) -> np.ndarray:
    """``_read_chunk`` for validate(): a blob whose payload is shorter
    than its npy header promises (a torn write) surfaces as an
    IndexStoreError diagnosis, not a raw mmap/np.load failure."""
    try:
        return _read_chunk(fpath)
    except Exception as e:
        raise IndexStoreError(
            f"{store_path}: chunk {os.path.basename(fpath)} is truncated "
            f"or unreadable ({e}) — partial artifact rejected") from e


def _read_rows_from_chunks(path: str, chunks: list, logical: str, dim: int,
                           total: int, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of a chunk list in their storage view — host
    O(stop - start); chunks outside the range are never touched."""
    if not 0 <= start <= stop <= total:
        raise ValueError(f"row range [{start}, {stop}) outside [0, {total})")
    out = np.empty((stop - start, dim), _STORAGE_VIEW.get(logical, logical))
    pos = 0          # global row index at the current chunk's head
    filled = 0
    for c in chunks:
        rows = c["rows"]
        lo, hi = max(start, pos), min(stop, pos + rows)
        if lo < hi:
            chunk = _read_chunk(os.path.join(path, c["file"]))
            out[filled:filled + (hi - lo)] = chunk[lo - pos:hi - pos]
            filled += hi - lo
        pos += rows
        if pos >= stop:
            break
    return out


def _read_chunks_into(path: str, chunks: list, out: torch.Tensor) -> None:
    """Copy a chunk list's rows, in order, into the preallocated ``out``.

    On the CPU each memory-mapped chunk is copied straight into ``out``'s
    storage. On the card rows go in slices of at most ``_STAGE_BYTES``
    through two pinned staging buffers: a slice is read from the mapped
    file into one buffer while the other's copy to the device runs, and a
    buffer is refilled only after the event behind its last copy."""
    if out.device.type != "cuda":
        dst = _np_view(out)
        pos = 0
        for c in chunks:
            arr = _read_chunk(os.path.join(path, c["file"]))
            dst[pos:pos + arr.shape[0]] = arr
            pos += arr.shape[0]
        return
    dim = out.shape[1]
    stage = max(1, _STAGE_BYTES // max(dim * out.element_size(), 1))
    ring = [torch.empty((stage, dim), dtype=out.dtype, pin_memory=True)
            for _ in range(2)]
    views = [_np_view(b) for b in ring]
    done: list = [None, None]
    pos = i = 0
    for c in chunks:
        arr = _read_chunk(os.path.join(path, c["file"]))
        for lo in range(0, arr.shape[0], stage):
            part = arr[lo:lo + stage]
            s = i % 2
            if done[s] is not None:
                done[s].synchronize()
            views[s][:part.shape[0]] = part
            out[pos:pos + part.shape[0]].copy_(ring[s][:part.shape[0]],
                                               non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            done[s] = ev
            pos += part.shape[0]
            i += 1
    torch.cuda.current_stream(out.device).synchronize()


@dataclasses.dataclass
class SegmentView:
    """Read handle on one segment of a (possibly pre-segment) store.

    Duck-types the slice of the ``IndexStore`` read API the index loaders
    use (``n``/``dim``/``dtype``/``iter_chunks``/``read_rows``/
    ``read_into``/``scale``), so ``DenseIndex.load`` works unchanged on one
    segment — that is how ``SegmentedIndex.load`` assembles its base. Row
    indices are segment-local; ``offset`` is the segment's global doc-id
    base.
    """

    store_path: str
    name: str
    kind: str                      # "base" | "delta" | "resolution" | ...
    entry: dict                    # manifest segment entry (shared ref)
    offset: int                    # global row offset of this segment
    dim: int
    dtype_name: str

    @property
    def n(self) -> int:
        """Rows of the segment. A resolution entry records none of its own
        (the reference's format), so its rows are its chunks' rows."""
        if "n" in self.entry:
            return int(self.entry["n"])
        return sum(int(c["rows"]) for c in self.entry["chunks"])

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype_name)

    @property
    def capacity(self) -> int | None:
        c = self.entry.get("capacity")
        return None if c is None else int(c)

    def iter_chunks(self, mmap: bool = True) -> Iterator[np.ndarray]:
        """Row chunks in order, as stored (bf16 as uint16)."""
        for c in self.entry["chunks"]:
            yield _read_chunk(os.path.join(self.store_path, c["file"]), mmap=mmap)

    def read_rows(self, start: int, stop: int, *, device=None) -> torch.Tensor:
        """Rows [start, stop) as a tensor of the logical dtype on ``device``
        (default: the card)."""
        rows = _read_rows_from_chunks(self.store_path, self.entry["chunks"],
                                      self.dtype_name, self.dim, self.n,
                                      start, stop)
        return _host_tensor(rows, self.dtype_name).to(default_device(device))

    def read_into(self, out: torch.Tensor) -> None:
        """Every row, copied chunk by chunk into the preallocated ``out``
        of shape (n, dim) and the logical dtype."""
        _read_chunks_into(self.store_path, self.entry["chunks"], out)

    def scale(self) -> np.ndarray | None:
        """The segment's per-dim dequant scale (host f32), if it has one."""
        f = self.entry.get("scale_file")
        if f is None:
            return None
        return np.load(os.path.join(self.store_path, f))


class IndexStoreWriter:
    """Streaming writer: append row chunks, then commit atomically.

    Peak host memory is one chunk — nothing is buffered across ``append``
    calls. ``dim``/``dtype`` are inferred from the first chunk and enforced
    thereafter. Usable as a context manager (aborts on exception).
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.tmp = self.path + ".tmp"
        if os.path.exists(self.tmp):
            shutil.rmtree(self.tmp)
        os.makedirs(self.tmp)
        self._chunks: list[dict] = []
        self._n = 0
        self._dim: int | None = None
        self._dtype: str | None = None
        self._has_pca = False
        self._has_scale = False
        self._committed = False

    # -- content -----------------------------------------------------------
    def put_pca(self, state) -> None:
        """Persist the fitted PCAState alongside the vectors."""
        from repro_torch.core import pca as _pca
        _pca.save_pca(os.path.join(self.tmp, PCA_FILE), state)
        fsync_file(os.path.join(self.tmp, PCA_FILE))
        self._has_pca = True

    def set_scale(self, scale) -> None:
        """Per-dim dequant scale for int8 stores."""
        _save_scale(os.path.join(self.tmp, SCALE_FILE), scale)
        self._has_scale = True

    def append(self, block) -> None:
        """Write one (rows, dim) chunk: a tensor on any device or a numpy
        array."""
        arr, logical = _storage_array(block)
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"append expects a non-empty (rows, dim) block, "
                             f"got shape {arr.shape}")
        if self._dim is None:
            self._dim = int(arr.shape[1])
            self._dtype = logical
        if arr.shape[1] != self._dim or logical != self._dtype:
            raise ValueError(
                f"chunk mismatch: got ({arr.shape[1]}, {logical}), "
                f"store is ({self._dim}, {self._dtype})")
        fname = f"vectors_{len(self._chunks):06d}.npy"
        _write_chunk(os.path.join(self.tmp, fname), arr)
        self._chunks.append({"file": fname, "rows": int(arr.shape[0])})
        self._n += int(arr.shape[0])

    # -- commit ------------------------------------------------------------
    def commit(self, meta: dict | None = None) -> "IndexStore":
        if self._committed:
            raise IndexStoreError("writer already committed")
        if not self._chunks:
            raise IndexStoreError("commit on an empty store (no chunks)")
        manifest = {
            "format_version": FORMAT_VERSION,
            "kind": "dense_index",
            "n": self._n,
            "dim": self._dim,
            "dtype": self._dtype,
            "chunks": self._chunks,
            "pca_file": PCA_FILE if self._has_pca else None,
            "scale_file": SCALE_FILE if self._has_scale else None,
            "meta": meta or {},
        }
        write_json_fsync(os.path.join(self.tmp, MANIFEST), manifest)
        commit_dir(self.tmp, self.path)
        self._committed = True
        return IndexStore.open(self.path)

    def abort(self) -> None:
        if not self._committed and os.path.exists(self.tmp):
            shutil.rmtree(self.tmp)

    def __enter__(self) -> "IndexStoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()


@dataclasses.dataclass
class IndexStore:
    """Read/append handle on a committed artifact directory."""

    path: str
    manifest: dict

    # -- open / validate ---------------------------------------------------
    @classmethod
    def create(cls, path: str) -> IndexStoreWriter:
        return IndexStoreWriter(path)

    @classmethod
    def open(cls, path: str) -> "IndexStore":
        path = str(path)
        mpath = os.path.join(path, MANIFEST)
        if not os.path.isfile(mpath):
            raise IndexStoreError(
                f"{path}: not a committed index store (no {MANIFEST} — "
                f"a crashed build leaves only a .tmp directory)")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except json.JSONDecodeError as e:
            raise IndexStoreError(f"{path}: unreadable manifest: {e}") from e
        store = cls(path=path, manifest=manifest)
        store.validate()
        return store

    def _check_chunks(self, chunks: list, dim: int, what: str) -> int:
        """Every chunk present, readable and (rows, dim); returns the row
        sum."""
        pre = f"{what} " if what else ""
        rows = 0
        for c in chunks:
            fpath = os.path.join(self.path, c["file"])
            if not os.path.isfile(fpath):
                raise IndexStoreError(f"{self.path}: {pre}missing chunk {c['file']}")
            arr = _read_chunk_validated(self.path, fpath)
            if arr.ndim != 2 or arr.shape != (c["rows"], dim):
                raise IndexStoreError(
                    f"{self.path}: {pre}chunk {c['file']} has shape "
                    f"{tuple(arr.shape)}, manifest says ({c['rows']}, {dim})")
            rows += c["rows"]
        return rows

    def _check_blob(self, f: str | None, what: str) -> None:
        if f is not None and not os.path.isfile(os.path.join(self.path, f)):
            raise IndexStoreError(f"{self.path}: {what} blob {f}")

    def validate(self) -> None:
        m = self.manifest
        if m.get("format_version") != FORMAT_VERSION:
            raise IndexStoreError(
                f"{self.path}: format_version {m.get('format_version')!r} "
                f"!= supported {FORMAT_VERSION}")
        for key in ("n", "dim", "dtype", "chunks"):
            if key not in m:
                raise IndexStoreError(f"{self.path}: manifest missing {key!r}")
        rows = self._check_chunks(m["chunks"], m["dim"], "")
        if rows != m["n"]:
            raise IndexStoreError(
                f"{self.path}: chunk rows sum to {rows}, manifest n={m['n']}")
        for key in ("pca_file", "scale_file"):
            self._check_blob(m.get(key), f"missing {key}")
        segs = m.get("segments")
        if segs is not None:
            if not segs or segs[0].get("kind") != "base":
                raise IndexStoreError(
                    f"{self.path}: segments must start with a base segment")
            if sum(int(s["n"]) for s in segs) != m["n"]:
                raise IndexStoreError(
                    f"{self.path}: segment rows sum "
                    f"{sum(int(s['n']) for s in segs)} != manifest n={m['n']}")
            seg_files = [c["file"] for s in segs for c in s["chunks"]]
            if seg_files != [c["file"] for c in m["chunks"]]:
                raise IndexStoreError(
                    f"{self.path}: top-level chunks are not the "
                    f"concatenation of the segment chunk lists")
            for s in segs:
                self._check_blob(s.get("scale_file"),
                                 f"segment {s['name']} missing scale")
                cap = s.get("capacity")
                if cap is not None and int(s["n"]) > int(cap):
                    raise IndexStoreError(
                        f"{self.path}: segment {s['name']} holds {s['n']} "
                        f"rows over its capacity {cap}")
        self._validate_resolutions()
        self._validate_paged()

    def _validate_resolutions(self) -> None:
        """A coarse resolution must be a nested, row-aligned view of the
        base: same rows in the same order at a strictly smaller m. A
        mismatch would make cascade shortlist ids address the wrong
        rescore rows, so open() refuses loudly."""
        m = self.manifest
        base_n = int(self._segment_entries()[0]["n"])
        seen_m: set[int] = set()
        for r in m.get("resolutions", ()):
            for key in ("name", "m", "dtype", "chunks"):
                if key not in r:
                    raise IndexStoreError(
                        f"{self.path}: resolution entry missing {key!r}")
            rm = int(r["m"])
            if not 0 < rm < m["dim"]:
                raise IndexStoreError(
                    f"{self.path}: resolution {r['name']} has m={rm}, which "
                    f"does not nest inside the store's dim={m['dim']} "
                    f"(need 0 < m < dim — PCA leading columns)")
            if rm in seen_m:
                raise IndexStoreError(
                    f"{self.path}: duplicate resolution m={rm}")
            seen_m.add(rm)
            rows = self._check_chunks(r["chunks"], rm, f"resolution {r['name']}")
            if rows != base_n:
                raise IndexStoreError(
                    f"{self.path}: resolution {r['name']} holds {rows} "
                    f"rows, base segment has {base_n} — the views no "
                    f"longer describe the same corpus")
            self._check_blob(r.get("scale_file"),
                             f"resolution {r['name']} missing scale")
            for d in r.get("deltas", ()):
                for key in ("name", "n", "capacity", "dtype", "chunks"):
                    if key not in d:
                        raise IndexStoreError(
                            f"{self.path}: resolution delta entry missing "
                            f"{key!r}")
                if int(d["n"]) > int(d["capacity"]):
                    raise IndexStoreError(
                        f"{self.path}: resolution delta {d['name']} holds "
                        f"{d['n']} rows over its capacity {d['capacity']}")
                drows = self._check_chunks(d["chunks"], rm,
                                           f"resolution delta {d['name']}")
                if drows != int(d["n"]):
                    raise IndexStoreError(
                        f"{self.path}: resolution delta {d['name']} chunk "
                        f"rows sum to {drows}, manifest n={d['n']}")
                self._check_blob(d.get("scale_file"),
                                 f"resolution delta {d['name']} missing scale")

    def _validate_paged(self) -> None:
        """The ``paged`` block must describe the segment list it rides on.

        Append mirroring is two swaps (segment op, then lifecycle block),
        so the block may LAG the segments after a crash between them —
        fewer extents than segments, or a stale smaller row count — and
        the loader reconstructs the missing state conservatively. It must
        never LEAD: an extent claiming rows (or a whole extent) the
        segments don't hold is a torn artifact and is rejected."""
        pb = self.manifest.get("paged")
        if pb is None:
            return
        for key in ("page_rows", "seal_rows", "extents"):
            if key not in pb:
                raise IndexStoreError(
                    f"{self.path}: paged block missing {key!r}")
        if int(pb["page_rows"]) <= 0 or int(pb["seal_rows"]) <= 0:
            raise IndexStoreError(
                f"{self.path}: paged block needs positive page_rows/"
                f"seal_rows, got {pb['page_rows']}/{pb['seal_rows']}")
        exts = pb["extents"]
        entries = self._segment_entries() if int(self.manifest["n"]) else []
        if len(exts) > len(entries):
            raise IndexStoreError(
                f"{self.path}: paged block lists {len(exts)} extents but "
                f"the store holds {len(entries)} segments")
        for i, e in enumerate(exts):
            if e.get("kind") not in ("base", "delta"):
                raise IndexStoreError(
                    f"{self.path}: paged extent {i} has kind "
                    f"{e.get('kind')!r} (need base|delta)")
            if int(e["n"]) > int(entries[i]["n"]):
                raise IndexStoreError(
                    f"{self.path}: paged extent {i} claims {e['n']} rows, "
                    f"segment {entries[i]['name']} holds {entries[i]['n']}")
            if not e.get("sealed", True) and (i != len(exts) - 1
                                              or e["kind"] != "delta"):
                raise IndexStoreError(
                    f"{self.path}: paged extent {i} is unsealed but only "
                    f"the last delta extent may be open")

    # -- shape -------------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.manifest["n"])

    @property
    def dim(self) -> int:
        return int(self.manifest["dim"])

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.manifest["dtype"])

    @property
    def meta(self) -> dict:
        return self.manifest.get("meta", {})

    @property
    def nbytes(self) -> int:
        b = self.n * self.dim * self.dtype.itemsize
        if self.manifest.get("scale_file"):
            b += self.dim * 4
        return b

    # -- reads (host-streamed) --------------------------------------------
    def iter_chunks(self, mmap: bool = True) -> Iterator[np.ndarray]:
        """Row chunks in order, as stored (bf16 as uint16), memory-mapped
        by default."""
        for c in self.manifest["chunks"]:
            yield _read_chunk(os.path.join(self.path, c["file"]), mmap=mmap)

    def read_rows(self, start: int, stop: int, *, device=None) -> torch.Tensor:
        """Rows [start, stop) as a tensor of the logical dtype on ``device``
        (default: the card); host memory O(stop - start), and chunks outside
        the range are never touched."""
        rows = _read_rows_from_chunks(self.path, self.manifest["chunks"],
                                      self.manifest["dtype"], self.dim,
                                      self.n, start, stop)
        return _host_tensor(rows, self.manifest["dtype"]).to(default_device(device))

    def read_into(self, out: torch.Tensor) -> None:
        """Every row, copied chunk by chunk into the preallocated ``out``
        of shape (n, dim) and the logical dtype, on its device."""
        _read_chunks_into(self.path, self.manifest["chunks"], out)

    def scale(self) -> np.ndarray | None:
        """The base per-dim dequant scale (host f32), if the store has one."""
        f = self.manifest.get("scale_file")
        if f is None:
            return None
        return np.load(os.path.join(self.path, f))

    def load_pca(self, *, device=None):
        """PCAState persisted at build time, on ``device`` (default: the
        card)."""
        f = self.manifest.get("pca_file")
        if f is None:
            raise IndexStoreError(f"{self.path}: store has no PCA state")
        from repro_torch.core import pca as _pca
        return _pca.load_pca(os.path.join(self.path, f), device=device)

    def load_pruner(self, *, device=None):
        """Rebuild the StaticPruner this store was pruned with, on
        ``device`` (default: the card)."""
        from repro_torch.core.pruning import StaticPruner
        state = self.load_pca(device=device)
        m = self.meta.get("kept_dims", self.dim)
        pruner = StaticPruner(m=int(m), center=state.centered)
        pruner.state = state
        return pruner

    # -- segments ----------------------------------------------------------
    @property
    def is_segmented(self) -> bool:
        return "segments" in self.manifest

    def _segment_entries(self) -> list[dict]:
        """Manifest segment list, synthesising the single-base view for a
        pre-segment artifact (the backward-compat normalisation)."""
        segs = self.manifest.get("segments")
        if segs is not None:
            return segs
        return [{"name": "base", "kind": "base", "n": self.manifest["n"],
                 "chunks": self.manifest["chunks"],
                 "scale_file": self.manifest.get("scale_file")}]

    def segments(self) -> list[SegmentView]:
        """Read handles on every segment, base first, with global offsets."""
        views, offset = [], 0
        for s in self._segment_entries():
            views.append(SegmentView(store_path=self.path, name=s["name"],
                                     kind=s["kind"], entry=s, offset=offset,
                                     dim=self.dim,
                                     dtype_name=self.manifest["dtype"]))
            offset += int(s["n"])
        return views

    # -- resolutions (multi-resolution cascade artifact) -------------------
    def resolutions(self) -> list[SegmentView]:
        """Read handles on every coarse resolution (row-aligned with the
        base segment; ``dim`` is the resolution's m, ``dtype`` its own
        storage dtype). ``DenseIndex.load`` works on a view unchanged."""
        return [SegmentView(store_path=self.path, name=r["name"],
                            kind="resolution", entry=r, offset=0,
                            dim=int(r["m"]), dtype_name=r["dtype"])
                for r in self.manifest.get("resolutions", ())]

    def _put_blob(self, manifest: dict, prefix: str, write, what) -> str:
        """Write one new blob under the next sequence name (advancing the
        counter in both manifests, so names are never reused)."""
        fname, seq = self._next_blob(prefix)
        manifest["blob_seq"] = seq
        self.manifest["blob_seq"] = seq
        write(os.path.join(self.path, fname), what)
        return fname

    def add_resolution(self, vectors, *, scale=None, chunk_rows: int = 262144,
                       deltas: Sequence[dict] = ()) -> str:
        """Durably attach a coarse resolution: the (base_n, m) leading-
        column view of the base rows in its storage dtype (int8 rows with
        their own per-dim ``scale``, or a float dtype). Blob-then-manifest
        swap like every other segment mutation; refuses a duplicate m, a
        non-nested m, or a row count that disagrees with the base segment.

        ``deltas`` persists coarse delta segments: each dict carries
        ``rows`` (the live rows in storage dtype), ``scale`` (or None) and
        ``capacity``; their row counts must mirror the main delta segments.
        """
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.cpu()
        if vectors.ndim != 2:
            raise ValueError(f"add_resolution expects (rows, m), got shape "
                             f"{tuple(vectors.shape)}")
        seg_entries = self._segment_entries()
        base_n = int(seg_entries[0]["n"])
        n, m = vectors.shape
        if n != base_n:
            raise IndexStoreError(
                f"{self.path}: resolution has {n} rows, base segment has "
                f"{base_n}")
        if not 0 < m < self.dim:
            raise IndexStoreError(
                f"{self.path}: resolution m={m} does not nest inside "
                f"dim={self.dim}")
        deltas = list(deltas)
        main_delta_n = [int(s["n"]) for s in seg_entries[1:]]
        delta_n = [int(d["rows"].shape[0]) for d in deltas]
        if deltas and delta_n != main_delta_n:
            raise IndexStoreError(
                f"{self.path}: resolution delta rows {delta_n} do not mirror "
                f"the main delta segments {main_delta_n} — the views would "
                f"describe different docs")
        manifest = json.loads(json.dumps(self.manifest))   # deep copy
        if any(int(r["m"]) == m for r in manifest.get("resolutions", ())):
            raise IndexStoreError(
                f"{self.path}: resolution m={m} already present")
        name = f"m{m}"
        entry = {"name": name, "m": m, "dtype": _storage_array(vectors[:0])[1],
                 "chunks": [], "scale_file": None}
        for start in range(0, n, chunk_rows):
            block = vectors[start:min(start + chunk_rows, n)]
            fname = self._put_blob(manifest, f"res_{name}", _write_chunk, block)
            entry["chunks"].append({"file": fname, "rows": int(block.shape[0])})
        if scale is not None:
            entry["scale_file"] = self._put_blob(manifest, f"scale_{name}",
                                                 _save_scale, scale)
        if deltas:
            entry["deltas"] = []
            for di, d in enumerate(deltas):
                rows = d["rows"]
                if rows.ndim != 2 or rows.shape[1] != m:
                    raise ValueError(
                        f"resolution delta {di} expects (rows, {m}), got "
                        f"{tuple(rows.shape)}")
                dname = f"{name}-delta-{di:03d}"
                dent = {"name": dname, "n": int(rows.shape[0]),
                        "capacity": int(d["capacity"]),
                        "dtype": _storage_array(rows[:0])[1], "chunks": [],
                        "scale_file": None}
                if dent["n"] > dent["capacity"]:
                    raise IndexStoreError(
                        f"{self.path}: resolution delta {dname} holds "
                        f"{dent['n']} rows over its capacity "
                        f"{dent['capacity']}")
                if rows.shape[0]:
                    fname = self._put_blob(manifest, f"res_{dname}",
                                           _write_chunk, rows)
                    dent["chunks"].append({"file": fname,
                                           "rows": int(rows.shape[0])})
                if d.get("scale") is not None:
                    dent["scale_file"] = self._put_blob(
                        manifest, f"scale_{dname}", _save_scale, d["scale"])
                entry["deltas"].append(dent)
        manifest.setdefault("resolutions", []).append(entry)
        self._swap_manifest(manifest)
        return name

    def resolution_deltas(self, name: str) -> list[SegmentView]:
        """Read handles on a resolution's persisted coarse delta segments
        (empty for a base-only resolution). ``dim`` is the resolution's m;
        offsets continue from the base rows in delta order."""
        for r in self.manifest.get("resolutions", ()):
            if r["name"] == name:
                views, offset = [], int(self._segment_entries()[0]["n"])
                for d in r.get("deltas", ()):
                    views.append(SegmentView(
                        store_path=self.path, name=d["name"],
                        kind="resolution-delta", entry=d, offset=offset,
                        dim=int(r["m"]), dtype_name=d["dtype"]))
                    offset += int(d["n"])
                return views
        raise IndexStoreError(f"{self.path}: no resolution {name!r}")

    @property
    def flat_loadable(self) -> bool:
        """Whether the global chunk list is a coherent single index: one
        segment, no scales at all, or every segment sharing one scale —
        mixed per-segment scales need ``SegmentedIndex.load``."""
        segs = self._segment_entries()
        if len(segs) == 1:
            return True
        scales = [SegmentView(self.path, s["name"], s["kind"], s, 0,
                              self.dim, self.manifest["dtype"]).scale()
                  for s in segs]
        if all(s is None for s in scales):
            return True
        if any(s is None for s in scales):
            return False
        return all(np.array_equal(scales[0], s) for s in scales[1:])

    # -- append / segment mutation (incremental growth) --------------------
    def _next_blob(self, prefix: str = "vectors") -> tuple[str, int]:
        """Unique blob name: a monotonically increasing sequence survives
        segment rewrites that delete earlier blobs (names never reused)."""
        seq = int(self.manifest.get("blob_seq",
                                    len(self.manifest["chunks"])))
        return f"{prefix}_{seq:06d}.npy", seq + 1

    def _swap_manifest(self, manifest: dict) -> None:
        """Atomic manifest replacement — the commit point of every segment
        mutation (all blobs must already be fsynced)."""
        tmp_manifest = os.path.join(self.path, MANIFEST + ".tmp")
        write_json_fsync(tmp_manifest, manifest)
        os.replace(tmp_manifest, os.path.join(self.path, MANIFEST))
        fsync_dir(self.path)
        self.manifest = manifest

    def _rebuild_global(self, manifest: dict) -> dict:
        """Re-derive the top-level n/chunks/scale_file from the segment
        list. The top-level scale_file tracks the BASE segment's: a base
        rewrite replaces and deletes the old scale blob, and a stale
        pointer would fail validation forever after."""
        segs = manifest["segments"]
        manifest["chunks"] = [c for s in segs for c in s["chunks"]]
        manifest["n"] = sum(int(s["n"]) for s in segs)
        manifest["scale_file"] = segs[0].get("scale_file")
        return manifest

    def set_paged_state(self, block: dict) -> None:
        """Install/replace the ``paged`` lifecycle block in one manifest
        swap. Page bytes never move: promote and compact are pointer swaps
        in memory and exactly this metadata swap on disk."""
        manifest = json.loads(json.dumps(self.manifest))   # deep copy
        manifest["paged"] = block
        self._swap_manifest(manifest)

    def add_delta(self, scale=None, capacity: int | None = None) -> str:
        """Open a new (empty) delta segment with its own scale; returns its
        name. Converts a pre-segment manifest to the segmented layout (the
        existing vectors become the base segment, bit-untouched)."""
        manifest = json.loads(json.dumps(self.manifest))   # deep copy
        segs = manifest.setdefault("segments", self._segment_entries())
        name = f"delta-{len(segs):03d}"
        entry = {"name": name, "kind": "delta", "n": 0, "chunks": [],
                 "scale_file": None}
        if capacity is not None:
            entry["capacity"] = int(capacity)
        if scale is not None:
            fname, seq = self._next_blob(f"scale_{name}")
            _save_scale(os.path.join(self.path, fname), scale)
            entry["scale_file"] = fname
            manifest["blob_seq"] = seq
        segs.append(entry)
        self._swap_manifest(self._rebuild_global(manifest))
        return name

    def _find_segment(self, manifest: dict, segment: str | None) -> dict:
        segs = manifest.get("segments")
        if segs is None:
            if segment not in (None, "base"):
                raise IndexStoreError(
                    f"{self.path}: no segment {segment!r} (pre-segment store)")
            return manifest                     # legacy: top-level IS the base
        if segment is None:
            return segs[-1]                     # the open (last) segment
        for s in segs:
            if s["name"] == segment:
                return s
        raise IndexStoreError(f"{self.path}: no segment {segment!r}")

    def _check_block(self, arr: np.ndarray, logical: str, what: str) -> None:
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(f"{what} expects (rows, {self.dim}), got "
                             f"{tuple(arr.shape)}")
        if logical != self.manifest["dtype"]:
            raise ValueError(f"{what} dtype {logical} != store dtype "
                             f"{self.manifest['dtype']}")

    def append(self, block, *, segment: str | None = None) -> None:
        """Durably append a row chunk (storage dtype; a tensor on any device
        or a numpy array) to a segment.

        ``segment=None`` targets the open (last) segment — the base on a
        pre-segment store, the newest delta on a segmented one. Protocol:
        chunk blob fsynced first, then the manifest atomically replaced
        (``os.replace``) and the directory fsynced — the manifest swap is
        the commit point.
        """
        arr, logical = _storage_array(block)
        self._check_block(arr, logical, "append")
        fname, seq = self._next_blob()
        _write_chunk(os.path.join(self.path, fname), arr)
        manifest = json.loads(json.dumps(self.manifest))
        target = self._find_segment(manifest, segment)
        target["chunks"] = target["chunks"] + [
            {"file": fname, "rows": int(arr.shape[0])}]
        target["n"] = int(target["n"]) + int(arr.shape[0])
        manifest["blob_seq"] = seq
        if "segments" in manifest:
            manifest = self._rebuild_global(manifest)
        self._swap_manifest(manifest)

    def replace_segment(self, segment: str, blocks, *, scale=None) -> None:
        """Atomically rewrite one segment's contents (and scale).

        Used when a delta's int8 scale widens: the requantised rows replace
        the old chunks in one manifest swap. New blobs are written and
        fsynced first; the old blobs are deleted only after the swap, so a
        crash leaves either the old or the new segment — orphan blobs from
        the crash window are ignored by ``open`` (never named by the
        manifest). The rewrite cost is bounded by the segment's size.
        """
        manifest = json.loads(json.dumps(self.manifest))
        if "segments" not in manifest:
            manifest["segments"] = self._segment_entries()
        target = self._find_segment(manifest, segment)
        old_files = [c["file"] for c in target["chunks"]]
        old_scale = target.get("scale_file")
        chunks, total = [], 0
        for block in blocks:
            arr, logical = _storage_array(block)
            if logical != self.manifest["dtype"]:
                raise ValueError(
                    f"replace dtype {logical} != store dtype "
                    f"{self.manifest['dtype']}")
            fname = self._put_blob(manifest, "vectors", _write_chunk, arr)
            chunks.append({"file": fname, "rows": int(arr.shape[0])})
            total += int(arr.shape[0])
        if scale is not None:
            target["scale_file"] = self._put_blob(manifest, f"scale_{segment}",
                                                  _save_scale, scale)
        target["chunks"] = chunks
        target["n"] = total
        self._swap_manifest(self._rebuild_global(manifest))
        for f in old_files + ([old_scale] if scale is not None and old_scale
                              else []):
            try:
                os.remove(os.path.join(self.path, f))
            except OSError:
                pass

    def append_migrating(self, block, *, segment: str | None = None) -> bool:
        """Append f32 rows to an int8 segment, widening its scale instead
        of clipping (the scale-migration path, scoped per segment).

        If any value of ``block`` falls outside ±127 under the segment's
        current scale, the scale widens per-dim to fit and the segment's
        existing chunks requantise under it (dequantise with the old scale,
        requantise with the new — within half an old LSB of exact; callers
        holding the exact f32 rows should use ``replace_segment``
        directly). Returns True when the scale widened. On float stores
        this is a plain cast-and-append.
        """
        from repro_torch.core.quantization import quantize_with_scale, scale_for
        block = np.atleast_2d(_host_f32(block))
        views = {v.name: v for v in self.segments()}
        target = self._find_segment(self.manifest, segment)
        name = target.get("name", "base")
        view = views.get(name, self.segments()[0])
        if self.dtype != torch.int8:
            self.append(torch.from_numpy(block).to(self.dtype), segment=segment)
            return False
        old = view.scale()
        if old is None:
            raise IndexStoreError(
                f"{self.path}: segment {name} is int8 but has no scale")
        need = scale_for(block)
        if not bool((need > old).any()):
            self.append(quantize_with_scale(block, old), segment=segment)
            return False
        new_scale = np.maximum(old, need).astype(np.float32)
        requant = [
            quantize_with_scale(c.astype(np.float32) * old[None, :], new_scale)
            for c in view.iter_chunks()]
        requant.append(quantize_with_scale(block, new_scale))
        if "segments" not in self.manifest:
            # pre-segment store: the rewrite touches the whole (base)
            # artifact — exactly the unbounded cost segmenting avoids
            self.manifest["segments"] = self._segment_entries()
        self.replace_segment(name, requant, scale=new_scale)
        return True
