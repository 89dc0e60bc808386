"""PCA decomposition of dense-retrieval embedding indexes (port of
``repro/core/pca.py``).

    D^T D = W Λ W^T              (uncentered Gram eigendecomposition)
    T     = D W                  (rotated index, variance-sorted columns)
    D̂    = T_m = D W_m           (pruned index at cutoff c = (d-m)/d)
    q̂    = W_m^T q               (query transform, applied online)

The paper eigendecomposes the *uncentered* Gram matrix; ``center=True`` is
classical PCA. On a CUDA tensor the Gram goes through the ``gram`` kernel
and ``transform`` through the ``pca_project`` kernel; on a CPU tensor both
run as plain PyTorch. ``fit_pca_distributed`` fits a matrix laid over a
``DeviceMesh``: one strip Gram per slot, summed on the mesh's first device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.index import _slot_ranges
from repro_torch.kernels import ops
from repro_torch.par.mesh import DeviceMesh, on_mesh
from repro_torch.util import as_tensor


@dataclasses.dataclass(frozen=True)
class PCAState:
    """Result of fitting PCA on an embedding matrix.

    components: (d, d) orthonormal eigenvectors, columns by decreasing
    eigenvalue; eigenvalues: (d,) descending, clipped at >= 0; mean: (d,)
    mean row (zeros when ``centered`` is False); n_samples: rows fitted.
    """

    components: torch.Tensor
    eigenvalues: torch.Tensor
    mean: torch.Tensor
    n_samples: int
    centered: bool = False

    @property
    def d(self) -> int:
        return self.components.shape[0]


# ---------------------------------------------------------------------------
# Gram computation
# ---------------------------------------------------------------------------


def gram(D: torch.Tensor, block_rows: int = 8192) -> torch.Tensor:
    """``D^T D`` in fp32. On the card one ``gram`` kernel streams every row;
    on the CPU row blocks of ``block_rows`` bound the f32 working set."""
    if D.device.type == "cuda":
        return ops.gram(D.contiguous())
    n, d = D.shape
    acc = torch.zeros((d, d), dtype=torch.float32, device=D.device)
    for i in range(0, n, block_rows):
        acc += ops.gram(D[i:i + block_rows])
    return acc


def gram_streaming(batches: Iterable, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Accumulate Gram + column sums over an iterator of row blocks.

    Returns ``(G, colsum, n)``. Tensor blocks stay on their device; numpy
    blocks go to ``device`` (default: the card).
    """
    G = colsum = None
    n = 0
    for b in batches:
        b = as_tensor(b, device)
        if G is None:
            d = b.shape[1]
            G = torch.zeros((d, d), dtype=torch.float32, device=b.device)
            colsum = torch.zeros((d,), dtype=torch.float32, device=b.device)
        G += gram(b)
        colsum += b.sum(0, dtype=torch.float32)
        n += int(b.shape[0])
    if G is None:
        raise ValueError("gram_streaming received an empty iterator")
    return G, colsum, n


def gram_distributed(D, mesh: DeviceMesh) -> torch.Tensor:
    """Gram of an (n, d) matrix laid over ``mesh`` as a sharded index lays
    its rows: each slot's strip Gram (``gram``: the ``gram`` kernel on the
    card), summed in slot order on the mesh's first device, the
    reference's psum. A strip that is all padding adds nothing (zero rows
    are Gram-neutral), so it launches nothing. A slot on D's device reads
    its strip as a view; any other gets a copy of its strip."""
    D = on_mesh(D, mesh)
    d = D.shape[1]
    G = torch.zeros((d, d), dtype=torch.float32, device=mesh.device)
    for dev, _, _, lo, hi in _slot_ranges(mesh, *D.shape):
        if hi > lo:
            G += gram(D[lo:hi].to(dev)).to(mesh.device)
    return G


# ---------------------------------------------------------------------------
# Fit
# ---------------------------------------------------------------------------


def _eig_from_gram(G: torch.Tensor, colsum: torch.Tensor, n: int,
                   center: bool) -> PCAState:
    d = G.shape[0]
    mean = colsum / max(n, 1)
    if center:
        M = G / max(n, 1) - torch.outer(mean, mean)
    else:
        M = G
        mean = torch.zeros((d,), dtype=torch.float32, device=G.device)
    # eigh returns ascending eigenvalues; the paper wants descending
    evals, evecs = torch.linalg.eigh(M.float())
    evals = torch.clamp_min(evals.flip(0), 0.0)
    evecs = evecs.flip(1).contiguous()
    return PCAState(components=evecs, eigenvalues=evals, mean=mean,
                    n_samples=int(n), centered=center)


def fit_pca(D, *, center: bool = False, block_rows: int = 8192) -> PCAState:
    """Fit PCA on an in-memory embedding matrix (paper default: uncentered)."""
    D = as_tensor(D)
    n = D.shape[0]
    G = gram(D, block_rows=min(block_rows, max(1, n)))
    colsum = D.sum(0, dtype=torch.float32)
    return _eig_from_gram(G, colsum, n, center)


def fit_pca_streaming(batches: Iterable, *, center: bool = False,
                      device=None) -> PCAState:
    """Fit PCA over an iterator of row blocks (out-of-core offline path)."""
    G, colsum, n = gram_streaming(batches, device=device)
    return _eig_from_gram(G, colsum, n, center)


def fit_pca_distributed(D, mesh: DeviceMesh, *, center: bool = False) -> PCAState:
    """Fit PCA on a matrix laid over a mesh (``gram_distributed``); the
    column sum runs over all n real rows."""
    D = on_mesh(D, mesh)
    G = gram_distributed(D, mesh)
    colsum = D.sum(0, dtype=torch.float32).to(G.device)
    return _eig_from_gram(G, colsum, D.shape[0], center)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def m_from_cutoff(d: int, cutoff: float) -> int:
    """Paper's cutoff c = (d - m)/d ⇒ m = round(d · (1 - c)). c in [0, 1)."""
    if not 0.0 <= cutoff < 1.0:
        raise ValueError(f"cutoff must be in [0, 1), got {cutoff}")
    return max(1, int(round(d * (1.0 - cutoff))))


def cutoff_from_m(d: int, m: int) -> float:
    return (d - m) / d


def transform(X: torch.Tensor, state: PCAState, m: int | None = None
              ) -> torch.Tensor:
    """Project rows of X onto the first m principal components: X @ W_m,
    in X's dtype."""
    W = state.components if m is None else state.components[:, :m]
    Xc = X - state.mean if state.centered else X
    return ops.pca_project(Xc.contiguous(), W.contiguous()).to(X.dtype)


def transform_query(q: torch.Tensor, state: PCAState, m: int | None = None
                    ) -> torch.Tensor:
    """q̂ = W_m^T q for a single query (d,) or a batch (B, d)."""
    return transform(torch.atleast_2d(q), state, m).reshape(
        (*q.shape[:-1], m if m is not None else state.d))


def projection_operands(state: PCAState, m: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(W_m, mean-or-None)``: the operands ``search_projected`` takes.
    ``mean`` is ``None`` for the paper's uncentered fit."""
    W = state.components if m is None else state.components[:, :m]
    return W.contiguous(), (state.mean if state.centered else None)


def inverse_transform(T: torch.Tensor, state: PCAState) -> torch.Tensor:
    """Reconstruct from an m-dim projection (lossy for m < d): T @ W_m^T."""
    m = T.shape[-1]
    X = T @ state.components[:, :m].T
    return X + state.mean if state.centered else X


def explained_variance_ratio(state: PCAState) -> torch.Tensor:
    tot = torch.clamp_min(state.eigenvalues.sum(), 1e-30)
    return state.eigenvalues / tot


def m_for_variance(state: PCAState, target: float) -> int:
    """Smallest m whose leading eigenvalues explain >= target of total,
    clamped to [1, d] (fp32 rounding can leave the cumsum below 1.0)."""
    csum = torch.cumsum(explained_variance_ratio(state), 0)
    t = torch.tensor([target], dtype=csum.dtype, device=csum.device)
    m = int(torch.searchsorted(csum, t)[0]) + 1
    return max(1, min(m, state.d))


# ---------------------------------------------------------------------------
# Serialization (offline artefact: W, Λ, mean), the reference's npz keys
# ---------------------------------------------------------------------------


def save_pca(path: str, state: PCAState) -> None:
    np.savez(path,
             components=state.components.cpu().numpy(),
             eigenvalues=state.eigenvalues.cpu().numpy(),
             mean=state.mean.cpu().numpy(),
             n_samples=np.asarray(state.n_samples, np.int32),
             centered=np.asarray(state.centered))


def load_pca(path: str, *, device=None) -> PCAState:
    """Read a ``pca.npz`` (written by either package) onto ``device``
    (default: the card)."""
    z = np.load(path)
    return PCAState(components=as_tensor(z["components"], device),
                    eigenvalues=as_tensor(z["eigenvalues"], device),
                    mean=as_tensor(z["mean"], device),
                    n_samples=int(z["n_samples"]),
                    centered=bool(z["centered"]))
