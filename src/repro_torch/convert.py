"""Carry fitted state across from numpy arrays (for example ``repro``'s
``PCAState`` or ``DenseIndex`` fields, converted with ``np.asarray``) into
the port's objects. ``load_pca`` reads ``repro``'s ``pca.npz`` directly."""
from __future__ import annotations

import numpy as np

from repro_torch.core.index import DenseIndex
from repro_torch.core.pca import PCAState
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
