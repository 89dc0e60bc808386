"""Dense embedding index with exact top-k search (port of the flat part of
``repro/core/index.py``).

On a CUDA index every search is one ``topk_score`` kernel call (plus the
query projection as a plain fp32 matmul); on a CPU index it is
``_scan_topk``, the blocked running top-k that ``repro`` runs as its jnp
path. Scores are accumulated in fp32 whatever the index dtype. The sharded,
segmented, store-backed and cascade indexes are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import quantize_int8_per_dim
from repro_torch.kernels import ops
from repro_torch.util import as_tensor


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
