"""Mesh construction for the entry points (port of ``repro/launch/mesh.py``)."""
from __future__ import annotations

import torch

from repro_torch.par.mesh import DeviceMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 single-pod (256 chips) or 2×16×16 two-pod (512 chips) mesh,
    every slot on the meta device: the axis names and sizes that specs
    resolve against (``par.sharding``), with nothing placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


def make_host_mesh(model: int | None = None, *, n: int | None = None,
                   device=None) -> DeviceMesh:
    """A small ``("data", "model")`` mesh of ``n`` slots: over the visible
    cards (``n`` defaults to their count) or, with ``device``, over that one
    device repeated (``n`` defaults to 1)."""
    if n is None:
        n = torch.cuda.device_count() if device is None else 1
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    return make_mesh((n // model, model), ("data", "model"), devices=device)
