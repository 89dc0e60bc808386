"""The cell's inputs, drawn from ``--seed`` on the run's device.

The corpus follows the synthetic model of the port's ``corpus_on_device``
(``repro_torch/data/synthetic.py``), copied here so that the yardstick
cannot move with the program: latent spectrum ``lambda_j ∝ j^-alpha``, an
orthonormal basis ``F`` from the QR of a Gaussian matrix, embedding noise
``sigma / sqrt(d)``, L2-normalised rows, drawn ``chunk_rows`` at a time
from one ``torch.Generator``. Queries are corpus rows picked at random,
perturbed and normalised again, as the port's chip smoke draws them.

Both the program and the reference get the same tensors: the reference
draws the corpus again from the same seed, which gives the same bits.
Imports only ``torch``.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def corpus(cfg: dict, gen: torch.Generator, device: torch.device,
           chunk_rows: int = 1 << 20) -> torch.Tensor:
    """The configuration's (n_docs, d) f32 corpus, drawn from ``gen``."""
    c = cfg["corpus"]
    n, d = int(c["n_docs"]), int(c["d"])
    lam = torch.arange(1, d + 1, dtype=torch.float64, device=device) ** (-float(c["alpha"]))
    lam /= lam.sum()
    F, _ = torch.linalg.qr(torch.randn(d, d, generator=gen, device=device,
                                       dtype=torch.float64))
    # z F^T with z = xi * sqrt(lambda)  ==  xi (diag(sqrt(lambda)) F^T)
    basis = (lam.sqrt()[:, None] * F.T).float()
    noise = float(c["sigma"]) / math.sqrt(d)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for i in range(0, n, chunk_rows):
        r = min(chunk_rows, n - i)
        x = torch.randn(r, d, generator=gen, device=device) @ basis
        x += noise * torch.randn(r, d, generator=gen, device=device)
        out[i:i + r] = x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)
    return out


def queries(D: torch.Tensor, count: int, noise: float, gen: torch.Generator
            ) -> torch.Tensor:
    """``count`` queries: random corpus rows plus ``noise / sqrt(d)`` Gaussian
    noise, L2-normalised (f32, on D's device)."""
    n, d = D.shape
    rows = torch.randint(0, n, (count,), generator=gen, device=D.device)
    Q = D[rows] + noise / math.sqrt(d) * torch.randn(count, d, generator=gen,
                                                      device=D.device)
    return Q / Q.norm(dim=1, keepdim=True).clamp_min(1e-9)
