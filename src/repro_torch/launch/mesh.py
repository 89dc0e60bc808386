"""Mesh construction for the entry points (port of ``repro/launch/mesh.py``;
the production mesh waits for the model zoo)."""
from __future__ import annotations

import torch

from repro_torch.par.mesh import DeviceMesh, make_mesh


def make_host_mesh(model: int | None = None, *, n: int | None = None,
                   device=None) -> DeviceMesh:
    """A small ``("data", "model")`` mesh of ``n`` slots: over the visible
    cards (``n`` defaults to their count) or, with ``device``, over that one
    device repeated (``n`` defaults to 1)."""
    if n is None:
        n = torch.cuda.device_count() if device is None else 1
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    return make_mesh((n // model, model), ("data", "model"), devices=device)
