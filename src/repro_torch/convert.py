"""Carry fitted state across from numpy arrays (for example ``repro``'s
``PCAState``, ``DenseIndex``, ``ShardedDenseIndex``, ``CascadeIndex`` or
``PagedIndexStorage`` fields, or a bi-encoder's parameter tree, converted
with ``np.asarray``) into the port's objects. ``load_pca`` reads
``repro``'s ``pca.npz`` directly."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cascade import CascadeIndex
from repro_torch.core.index import DenseIndex, ShardedDenseIndex
from repro_torch.core.paged import PageExtent, PagedIndex, PagedIndexStorage
from repro_torch.core.pca import PCAState
from repro_torch.models.biencoder import BiEncoder, BiEncoderConfig
from repro_torch.util import as_tensor


def pca_state_from_numpy(components: np.ndarray, eigenvalues: np.ndarray,
                         mean: np.ndarray, n_samples: int, centered: bool,
                         device=None) -> PCAState:
    """A port ``PCAState`` on ``device`` (default: the card)."""
    return PCAState(
        components=as_tensor(np.asarray(components, np.float32), device),
        eigenvalues=as_tensor(np.asarray(eigenvalues, np.float32), device),
        mean=as_tensor(np.asarray(mean, np.float32), device),
        n_samples=int(n_samples), centered=bool(centered))


def dense_index_from_numpy(vectors: np.ndarray, scale: np.ndarray | None,
                           device=None) -> DenseIndex:
    """A port ``DenseIndex`` over the given (possibly int8) vectors."""
    v = as_tensor(np.ascontiguousarray(vectors), device)
    s = None if scale is None else as_tensor(np.asarray(scale, np.float32), device)
    return DenseIndex(vectors=v, scale=s)


def sharded_index_from_numpy(vectors: np.ndarray, scale: np.ndarray | None,
                             mesh, n_real: int | None = None,
                             merge: str = "flat") -> ShardedDenseIndex:
    """A port ``ShardedDenseIndex`` over ``mesh`` holding the first
    ``n_real`` rows of ``vectors`` (default: all of them), so a reference
    index's padded vectors come across without their padding."""
    v = np.ascontiguousarray(np.asarray(vectors)[:n_real])
    return ShardedDenseIndex.from_rows(
        as_tensor(v, mesh.device), mesh, merge=merge,
        scale=None if scale is None else np.asarray(scale, np.float32))


def cascade_index_from_numpy(coarse_vectors: np.ndarray, coarse_scale: np.ndarray | None,
                             full_vectors: np.ndarray, full_scale: np.ndarray | None,
                             n_factor: int = 8, device=None) -> CascadeIndex:
    """A port ``CascadeIndex`` over a dense cascade's two resolutions: the
    coarse (n, m_coarse) and full (n, m) vectors, each with its scale (or
    None), byte for byte."""
    return CascadeIndex(coarse=dense_index_from_numpy(coarse_vectors, coarse_scale, device),
                        full=dense_index_from_numpy(full_vectors, full_scale, device),
                        n_factor=n_factor)


def paged_index_from_numpy(pool: np.ndarray, tail: np.ndarray,
                           host_pages: dict, page_table: np.ndarray,
                           page_nvalid: np.ndarray, page_offset: np.ndarray,
                           page_scale: np.ndarray | None, extents,
                           free_pool, free_tail, *, page_rows: int,
                           seal_rows: int, device=None, depth: int = 2,
                           wave_pages: int = 8) -> PagedIndex:
    """A port ``PagedIndex`` holding a reference storage's bytes: ``pool``
    (P, R, m) and ``tail`` (T, R, m) f32 or int8, ``host_pages`` slot ->
    (R, m) page, the page table and its metadata, and ``extents`` as
    sequences of (kind, sealed, start_slot, n_pages, n_rows, row_offset,
    scale, raw). The metadata arrays are copied; each page's scale row in
    ``page_scale`` must be its extent's scale, as the reference keeps it."""
    pool_t = as_tensor(np.ascontiguousarray(pool), device)
    dev = pool_t.device

    def host(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.pin_memory() if dev.type == "cuda" else t

    pt = np.array(page_table, np.int32)
    nv = np.array(page_nvalid, np.int32)
    off = np.array(page_offset, np.int32)
    sc = None if page_scale is None else np.array(page_scale, np.float32)
    exts = tuple(PageExtent(str(e[0]), bool(e[1]), *map(int, e[2:6]),
                            None if e[6] is None else np.array(e[6], np.float32),
                            None if e[7] is None else np.array(e[7], np.float32))
                 for e in extents)
    st = PagedIndexStorage(
        pool=pool_t, tail=torch.tensor(np.ascontiguousarray(tail), device=dev),
        page_table=torch.tensor(pt, device=dev),
        page_scale=None if sc is None else torch.tensor(sc, device=dev),
        page_nvalid=torch.tensor(nv, device=dev),
        page_offset=torch.tensor(off, device=dev),
        pt_host=pt, nvalid_host=nv, offset_host=off,
        host_pages={int(s): host(p) for s, p in host_pages.items()},
        extents=exts, free_pool=tuple(int(x) for x in free_pool),
        free_tail=tuple(int(x) for x in free_tail), page_rows=int(page_rows),
        seal_rows=int(seal_rows))
    return PagedIndex(storage=st, depth=depth, wave_pages=wave_pages)


def _tensor_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        return as_tensor(a.view(np.uint16).copy(), device).view(torch.bfloat16)
    return as_tensor(np.array(a, copy=True), device)


def biencoder_from_numpy(params: dict, cfg: BiEncoderConfig, device=None) -> BiEncoder:
    """A port ``BiEncoder`` on ``device`` (default: the card) holding a
    reference parameter tree: ``embed``, ``pos_embed``, ``final_norm``,
    ``proj`` and ``layers``, whose every leaf is stacked on a leading
    ``n_layers`` axis (the reference inits its layers under ``vmap``). The
    layers come out unstacked, one module each; dtypes are kept."""
    tree = _tensor_tree(params, device)

    def layer(t, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    stacked = tree.pop("layers")
    tree["layers"] = [layer(stacked, i) for i in range(cfg.n_layers)]
    return BiEncoder(cfg, tree)
