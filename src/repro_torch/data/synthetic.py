"""Synthetic retrieval corpora with controlled spectral structure.

A numpy copy of ``repro/data/synthetic.py``: the same seeds give the same
arrays, so tests can hand one dataset to both packages. ``corpus_on_device``
draws a corpus from the same model with a ``torch.Generator`` on the card,
for sizes the host should not build (its numbers differ from
``make_corpus``'s); ``ood_corpus_on_device`` does the same for
``make_ood_corpus``, in ``make_corpus``'s encoder space.

Stand-in for MS MARCO + {ANCE, TAS-B, Contriever} embeddings (unavailable
offline). Generative model:

    latent semantics  z_i ~ N(0, diag(lambda)),  lambda_j ∝ j^(-alpha)
    doc embedding     d_i = normalize(F z_i + sigma * eps_i),  F orthonormal
    query             z_q = z_seed + tau * (lambda^(1/2) ⊙ xi);
                      q   = normalize(F z_q + sigma_q * eps_q)
    true relevance    s*(q, i) = <z_q, z_i> / (|z_q||z_i|)   (clean, latent)

Graded qrels are banded from s* — *not* from the noisy embeddings the
retriever sees — so the baseline is imperfect and dimension pruning has the
paper's real trade-off: trailing principal dimensions carry mostly the eps
noise, leading ones carry the latent semantics.

Encoder profiles set the spectral decay ``alpha`` (and noise floor), chosen
to match each bi-encoder's empirically observed pruning robustness:

  * ``ance``        — steep decay, low effective rank: the paper finds ANCE
                      statistically unchanged even at 75 % pruning.
  * ``tasb``        — intermediate: robust at 50 %, degrades at 75 %.
  * ``contriever``  — flat spectrum: most pruning-sensitive.

Five query sets per corpus mimic the paper's DL19 / DL20 / DL-HARD /
DEV-SMALL / COVID surface: DL-HARD uses higher query noise, DEV-SMALL sparse
binary qrels, COVID a domain-shifted factor basis (for RQ2/out-of-domain).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.util import default_device

ENCODER_PROFILES: dict[str, dict] = {
    # alpha: latent spectrum decay; sigma: embedding noise floor.
    "ance":       dict(alpha=2.0, sigma=0.35),  # steep: low effective rank
    "tasb":       dict(alpha=0.78, sigma=0.42), # medium
    "contriever": dict(alpha=0.66, sigma=0.38), # flat: pruning-sensitive
}

QUERY_SET_PROFILES: dict[str, dict] = {
    "dl19":      dict(n_queries=43,  tau=0.45, graded=True,  pool_depth=64),
    "dl20":      dict(n_queries=54,  tau=0.45, graded=True,  pool_depth=64),
    "dlhard":    dict(n_queries=50,  tau=0.95, graded=True,  pool_depth=64),
    "devsmall":  dict(n_queries=200, tau=0.40, graded=False, pool_depth=2),
    "covid":     dict(n_queries=50,  tau=0.60, graded=True,  pool_depth=96,
                      domain_shift=0.5),
}


@dataclasses.dataclass
class RetrievalDataset:
    """A synthetic corpus + query sets + qrels, in embedding space."""

    docs: np.ndarray                              # (n, d) float32
    queries: dict[str, np.ndarray]                # set -> (nq, d)
    qrels: dict[str, dict[int, dict[int, int]]]   # set -> qid -> {docid: grade}
    encoder: str
    d: int


def _orthonormal(d: int, r: int, rng: np.random.Generator) -> np.ndarray:
    A = rng.standard_normal((d, r))
    Q, _ = np.linalg.qr(A)
    return Q[:, :r]


def _normalize(X: np.ndarray) -> np.ndarray:
    return X / np.linalg.norm(X, axis=1, keepdims=True).clip(1e-9)


def _encoder_space(encoder: str, d: int, seed: int
                   ) -> tuple[np.ndarray, np.ndarray, np.random.Generator]:
    """The encoder's spectrum ``lam`` and basis ``F`` (keyed by ``encoder``
    + ``seed``), and the generator that drew them."""
    enc_rng = np.random.default_rng(seed * 1_000_003 + abs(hash(encoder)) % (2**31))
    lam = np.arange(1, d + 1, dtype=np.float64) ** (-ENCODER_PROFILES[encoder]["alpha"])
    lam /= lam.sum()
    return lam, _orthonormal(d, d, enc_rng), enc_rng


def _domain(lam: np.ndarray, domain_seed: int
            ) -> tuple[np.random.Generator, np.ndarray]:
    """A domain's generator and its tilted spectrum: a smooth random factor
    re-weights the latent directions."""
    data_rng = np.random.default_rng(domain_seed * 9_000_011 + 5)
    lam_dom = lam * np.exp(0.5 * data_rng.standard_normal(lam.shape[0]))
    return data_rng, lam_dom / lam_dom.sum()


def make_corpus(encoder: str = "tasb", *, n_docs: int = 20000, d: int = 768,
                seed: int = 0, domain_seed: int | None = None
                ) -> tuple[np.ndarray, dict]:
    """Generate a corpus embedding matrix + latent ground truth.

    The factor basis ``F`` and spectrum belong to the *encoder* (keyed by
    ``encoder`` + ``seed``); ``domain_seed`` varies the *corpus* drawn
    through that encoder — a different domain re-weights which latent
    directions carry mass (as a real domain shift does) but lives in the
    same embedding space, which is what makes the paper's out-of-domain
    PCA transfer (RQ2) meaningful.
    """
    prof = ENCODER_PROFILES[encoder]
    lam, F, enc_rng = _encoder_space(encoder, d, seed)
    if domain_seed is None:
        data_rng = enc_rng
        lam_dom = lam
    else:
        data_rng, lam_dom = _domain(lam, domain_seed)
    Z = data_rng.standard_normal((n_docs, d)) * np.sqrt(lam_dom)[None, :]
    noise = prof["sigma"] * data_rng.standard_normal((n_docs, d)) / np.sqrt(d)
    D = _normalize(Z @ F.T + noise)
    aux = dict(F=F, lam=lam_dom, Z=Z, sigma=prof["sigma"], seed=seed,
               encoder=encoder)
    return D.astype(np.float32), aux


def _make_query_set(aux: Mapping, name: str, *, seed: int,
                    ) -> tuple[np.ndarray, dict[int, dict[int, int]]]:
    prof = QUERY_SET_PROFILES[name]
    rng = np.random.default_rng(seed * 7_000_003 + abs(hash(name)) % (2**31))
    F, lam, Z, sigma = aux["F"], aux["lam"], aux["Z"], aux["sigma"]
    n, d = Z.shape
    nq = prof["n_queries"]

    seed_docs = rng.choice(n, size=nq, replace=False)
    dz = prof["tau"] * rng.standard_normal((nq, d)) * np.sqrt(lam)[None, :]
    Zq = Z[seed_docs] + dz

    Fq = F
    if prof.get("domain_shift"):
        # COVID-like: query basis partially rotated off the corpus basis.
        shift = prof["domain_shift"]
        G = _orthonormal(d, d, rng)
        Fq = (1 - shift) * F + shift * G
        Fq, _ = np.linalg.qr(Fq)

    q_noise = sigma * rng.standard_normal((nq, d)) / np.sqrt(d)
    Q = _normalize(Zq @ Fq.T + q_noise)

    # True relevance from clean latent similarity (cosine).
    Zn = Z / np.linalg.norm(Z, axis=1, keepdims=True).clip(1e-12)
    Zqn = Zq / np.linalg.norm(Zq, axis=1, keepdims=True).clip(1e-12)
    s_true = Zqn @ Zn.T                               # (nq, n)

    qrels: dict[int, dict[int, int]] = {}
    depth = prof["pool_depth"]
    for qi in range(nq):
        order = np.argsort(-s_true[qi])[:depth]
        grades: dict[int, int] = {}
        if prof["graded"]:
            b1, b2 = max(1, depth // 16), max(2, depth // 4)
            for rank, doc in enumerate(order):
                if rank < b1:
                    grades[int(doc)] = 3
                elif rank < b2:
                    grades[int(doc)] = 2
                elif rng.random() < 0.5:
                    grades[int(doc)] = 1
                else:
                    grades[int(doc)] = 0
        else:
            for doc in order[:depth]:
                grades[int(doc)] = 1
        qrels[qi] = grades
    return Q.astype(np.float32), qrels


def make_dataset(encoder: str = "tasb", *, n_docs: int = 20000, d: int = 768,
                 seed: int = 0,
                 query_sets: tuple[str, ...] = ("dl19", "dl20", "dlhard",
                                                "devsmall", "covid"),
                 ) -> RetrievalDataset:
    D, aux = make_corpus(encoder, n_docs=n_docs, d=d, seed=seed)
    queries, qrels = {}, {}
    for name in query_sets:
        Q, R = _make_query_set(aux, name, seed=seed)
        queries[name] = Q
        qrels[name] = R
    return RetrievalDataset(docs=D, queries=queries, qrels=qrels,
                            encoder=encoder, d=d)


def make_ood_corpus(base_encoder: str, *, n_docs: int = 20000, d: int = 768,
                    seed: int = 0, domain_seed: int = 1234) -> np.ndarray:
    """A different-domain corpus from the SAME encoder (paper RQ2 setting):
    same embedding space, different document distribution."""
    D, _ = make_corpus(base_encoder, n_docs=n_docs, d=d, seed=seed,
                       domain_seed=domain_seed)
    return D


def _draw_rows(basis: torch.Tensor, noise: float, n_docs: int,
               g: torch.Generator, chunk_rows: int) -> torch.Tensor:
    """L2-normalised rows ``xi @ basis + noise * eps`` drawn from ``g`` on
    the basis's device, ``chunk_rows`` at a time into one output."""
    dev, d = basis.device, basis.shape[1]
    out = torch.empty((n_docs, d), dtype=torch.float32, device=dev)
    for i in range(0, n_docs, chunk_rows):
        r = min(chunk_rows, n_docs - i)
        x = torch.randn(r, basis.shape[0], generator=g, device=dev) @ basis
        x += noise * torch.randn(r, d, generator=g, device=dev)
        out[i:i + r] = x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)
    return out


def corpus_on_device(encoder: str = "tasb", *, n_docs: int, d: int = 768,
                     seed: int = 0, device: str | torch.device | None = None,
                     chunk_rows: int = 1 << 20) -> torch.Tensor:
    """An (n_docs, d) f32 corpus drawn on ``device`` (default: the card)
    from ``make_corpus``'s model: spectrum lambda_j ∝ j^-alpha, an
    orthonormal basis F, embedding noise, L2-normalised rows.

    Rows are generated ``chunk_rows`` at a time from one seeded
    ``torch.Generator``, so the transient memory is a chunk, never a
    second corpus.
    """
    dev = default_device(device)
    prof = ENCODER_PROFILES[encoder]
    g = torch.Generator(device=dev).manual_seed(seed)
    lam = torch.arange(1, d + 1, dtype=torch.float64, device=dev) ** (-prof["alpha"])
    lam /= lam.sum()
    F, _ = torch.linalg.qr(torch.randn(d, d, generator=g, device=dev,
                                       dtype=torch.float64))
    # z F^T with z = xi * sqrt(lambda)  ==  xi (diag(sqrt(lambda)) F^T)
    basis = (lam.sqrt()[:, None] * F.T).float()
    return _draw_rows(basis, prof["sigma"] / float(np.sqrt(d)), n_docs, g,
                      chunk_rows)


def ood_corpus_on_device(base_encoder: str, *, n_docs: int, d: int = 768,
                         seed: int = 0, domain_seed: int = 1234,
                         device: str | torch.device | None = None,
                         chunk_rows: int = 1 << 20) -> torch.Tensor:
    """``make_ood_corpus``'s counterpart drawn on ``device`` (default: the
    card): the same encoder space (``make_corpus``'s basis F and spectrum
    for ``base_encoder`` and ``seed``) and the same domain tilt, so it
    pairs with ``make_dataset``'s in-domain corpus as the paper's RQ2
    setting needs. Only the rows are drawn on the device, from a
    ``torch.Generator`` seeded with ``domain_seed``, so their numbers
    differ from ``make_ood_corpus``'s."""
    dev = default_device(device)
    lam, F, _ = _encoder_space(base_encoder, d, seed)
    _, lam_dom = _domain(lam, domain_seed)
    basis = torch.as_tensor(np.sqrt(lam_dom)[:, None] * F.T, device=dev).float()
    g = torch.Generator(device=dev).manual_seed(domain_seed)
    return _draw_rows(basis, ENCODER_PROFILES[base_encoder]["sigma"] / float(np.sqrt(d)),
                      n_docs, g, chunk_rows)
