"""The plain reference: the paper's pruned search, worked out again from the
drawn corpus in fp64 with plain PyTorch.

``fit`` eigendecomposes the uncentered Gram ``D^T D`` and keeps the ``m``
leading eigenvectors (``W_m``). ``Reference`` takes a ``W_m``, projects every
row (``D W_m``), quantises the projection per dimension where the
configuration stores int8 (symmetric, ``max|x| / 127``, round half to even,
clip to ±127), folds the scale into the projected query, and scores
exactly. Everything runs in row blocks, so the transient memory is a block,
never a second corpus.

The search is judged under the ``W_m`` that the judged side fitted: at the
configuration's cutoff the α 0.78 spectrum leaves eigenvalue gaps near the
384th of about 0.2 %, so two sound fits (fp32 and fp64) may turn the
boundary's eigenvectors into each other, and the pruned space itself, not
only its rounding, differs between them (PERF.md §2). That ``W_m`` is held
to the fp64 eigendecomposition of the same corpus on its own
(``Spectrum.readings``):

- ``shortfall``: ``|1 - tr(W^T G W) / sum(lambda_1..m)|``, the share of the
  leading m eigenvalues' sum that the kept span misses (or, for a W that is
  not orthonormal, exceeds): a turn between eigenvectors of nearly equal
  eigenvalue costs next to nothing, a kept direction from the wrong part of
  the spectrum costs its eigenvalue gap;
- ``leak``: how much of the kept span lies on eigenvectors past m + 8, well
  beyond the boundary's nearly equal pairs.

An int8 value is exact up to one level where the projection lies within
``SLACK`` of a level's rounding boundary: an f32 projection may round the
other way there. Scores of a stored row are then an interval, [lo, hi],
whose width is the sum of the flippable levels' contributions.

The same code, one precision lower, is the benchmark's control:
``precision="tf32"`` rounds every product's operands to TF32's 10-bit
mantissa and accumulates in fp32 (what TF32 tensor cores do), and
``store="int4"`` quantises to ±7.

Imports only ``torch``: nothing of the program, of JAX or of ``repro``.
"""
from __future__ import annotations

import torch

QMAX = {"int8": 127.0, "int4": 7.0}
SLACK = 2e-3      # levels: the f32 projection's error is below 2e-4 of a level
BLOCK = 1 << 19   # rows a block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 explicit mantissa bits, to nearest
    even, as an f32 tensor."""
    b = x.float().contiguous().view(torch.int32)
    low = b & 0x1FFF
    keep = b & ~0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((b & 0x2000) != 0))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("fp64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.float64 if precision == "fp64" else torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return tf32(a) @ tf32(b) if precision == "tf32" else a @ b


def _blocks(D: torch.Tensor, dtype: torch.dtype):
    for i in range(0, D.shape[0], BLOCK):
        yield i, D[i:i + BLOCK].to(dtype)


class Spectrum:
    """The uncentered Gram ``D^T D`` in ``precision`` and its
    eigendecomposition, eigenvalues descending."""

    LEAK_PAST = 8   # eigenvectors past m that a sound fit may turn into

    def __init__(self, D: torch.Tensor, precision: str = "fp64"):
        dtype = _dtype(precision)
        d = D.shape[1]
        self.G = torch.zeros((d, d), dtype=dtype, device=D.device)
        for _, X in _blocks(D, dtype):
            self.G += _mm(X.T, X, precision)
        evals, evecs = torch.linalg.eigh(self.G)
        self.evals, self.evecs = evals.flip(0), evecs.flip(1)

    def readings(self, W: torch.Tensor) -> dict[str, float]:
        """``shortfall`` and ``leak`` of a fitted ``W_m`` (d, m)."""
        W = W.to(device=self.G.device, dtype=self.G.dtype)
        m = W.shape[1]
        C = self.evecs.T @ W
        kept = torch.trace(W.T @ self.G @ W) / self.evals[:m].sum()
        return dict(shortfall=float((1 - kept).abs()),
                    leak=float((C[m + self.LEAK_PAST:] ** 2).sum()))


def fit(D: torch.Tensor, m: int, precision: str = "fp64") -> torch.Tensor:
    """W_m (d, m): the ``m`` leading eigenvectors of the uncentered Gram."""
    return Spectrum(D, precision).evecs[:, :m].contiguous()


class Reference:
    """Exact top-k over ``D W_m``, stored as ``store`` (``"float32"``,
    ``"int8"`` or ``"int4"``), computed in ``precision`` (``"fp64"``, or
    ``"tf32"`` for a control)."""

    def __init__(self, D: torch.Tensor, W: torch.Tensor, store: str = "float32",
                 precision: str = "fp64"):
        if store not in ("float32", *QMAX):
            raise ValueError(f"unknown store {store!r}")
        self.dtype = _dtype(precision)
        self.D, self.store, self.precision = D, store, precision
        self.W = W.to(device=D.device, dtype=self.dtype).contiguous()
        self.m = self.W.shape[1]
        self.scale = None
        if store in QMAX:
            absmax = torch.zeros(self.m, dtype=self.dtype, device=D.device)
            for _, X in _blocks(D, self.dtype):
                absmax = torch.maximum(absmax, self._mm(X, self.W).abs().amax(0))
            self.scale = absmax.clamp_min(1e-12) / QMAX[store]

    def _mm(self, a, b):
        return _mm(a, b, self.precision)

    def _stored(self, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Rows as the index holds them (levels for an int store) and, for
        an int store, where a level may flip (1.0) or not (0.0)."""
        P = self._mm(X, self.W)
        if self.scale is None:
            return P, None
        q = QMAX[self.store]
        x = P / self.scale
        Z = torch.clamp(torch.round(x), -q, q)
        frac = (x - torch.floor(x)).abs()
        flip = ((frac - 0.5).abs() < SLACK) & (x.abs() < q + 0.5)
        return Z, flip.to(self.dtype)

    def queries(self, Q: torch.Tensor) -> torch.Tensor:
        """Projected queries with the scale folded in: (S, m)."""
        qh = self._mm(Q.to(self.dtype), self.W)
        return qh if self.scale is None else qh * self.scale

    def topk(self, Q: torch.Tensor, k: int, low: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores, ids) of the top ``k`` rows for each query, descending,
        lowest id first among equal scores; with ``low``, by each row's
        lowest possible score."""
        qh = self.queries(Q)
        S = qh.shape[0]
        best_s = torch.full((S, 0), float("-inf"), dtype=self.dtype, device=qh.device)
        best_i = torch.full((S, 0), -1, dtype=torch.int64, device=qh.device)
        for start, X in _blocks(self.D, self.dtype):
            Z, flip = self._stored(X)
            s = self._mm(qh, Z.T)
            if low and flip is not None:
                s -= qh.abs() @ flip.T
            bs, bi = torch.topk(s, min(k, s.shape[1]), dim=1)
            cand_s = torch.cat([best_s, bs], 1)
            cand_i = torch.cat([best_i, bi + start], 1)
            # ids ascending, then a stable sort by score: lowest id wins ties
            order = torch.argsort(cand_i, dim=1)
            cand_s, cand_i = cand_s.gather(1, order), cand_i.gather(1, order)
            order = torch.sort(cand_s, dim=1, descending=True, stable=True).indices[:, :k]
            best_s, best_i = cand_s.gather(1, order), cand_i.gather(1, order)
        return best_s, best_i

    def bounds(self, Q: torch.Tensor, ids: torch.Tensor, chunk: int = 32
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(lo, hi): the reference's score of row ``ids[i, j]`` for query
        ``i`` (an interval where int8 levels may flip); -inf where the id
        is not a row of the corpus."""
        n = self.D.shape[0]
        qh = self.queries(Q)
        lo = torch.full(ids.shape, float("-inf"), dtype=self.dtype, device=qh.device)
        hi = lo.clone()
        ids = ids.to(qh.device).long()
        valid = (ids >= 0) & (ids < n)
        for i in range(0, ids.shape[0], chunk):
            rows = ids[i:i + chunk].clamp(0, n - 1)
            Z, flip = self._stored(self.D[rows.reshape(-1)].to(self.dtype))
            q = qh[i:i + chunk, None, :]
            s = (Z.reshape(*rows.shape, self.m) * q).sum(-1)
            w = 0 if flip is None else (flip.reshape(*rows.shape, self.m) * q.abs()).sum(-1)
            ok = valid[i:i + chunk]
            lo[i:i + chunk] = torch.where(ok, s - w, lo[i:i + chunk])
            hi[i:i + chunk] = torch.where(ok, s + w, hi[i:i + chunk])
        return lo, hi
