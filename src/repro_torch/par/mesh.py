"""``DeviceMesh``: the port's counterpart of ``jax.sharding.Mesh``.

A mesh is a row-major array of slots, one ``torch.device`` per slot, with a
name per axis. A device may fill several slots, as the reference's forced
host devices all sit on one CPU: four slots on ``cuda:0`` run the sharded
path (four per-shard kernel launches, the merges) on one card, and on a
machine with four cards only the device list changes. The port is one
process over the mesh, as the reference is one controller over its devices;
there is no collective, the merge runs on the mesh's first device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.util import as_tensor, default_device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``devices``: an object array of ``torch.device`` of shape ``shape``,
    slots in row-major order (a device may repeat); ``axis_names`` one name
    per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list[torch.device]:
        """Every slot's device, in row-major slot order."""
        return list(self.devices.reshape(-1))

    @property
    def device(self) -> torch.device:
        """The first slot's device: where queries are projected and the
        per-shard candidates merged."""
        return self.device_list[0]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names``.

    ``devices``: None for the visible cards, repeated round-robin to fill
    the mesh (raises when there is none); one device (``"cpu"``,
    ``"cuda:0"``) for every slot; or a sequence, repeated round-robin.
    """
    if devices is None:
        default_device("cuda")                      # raises without a card
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devs = [_slot_device(devices)]
    else:
        devs = [_slot_device(d) for d in devices]
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if size < 1 or not devs:
        raise ValueError(f"mesh shape {shape} over {len(devs)} device(s) has no slot")
    arr = np.empty(size, dtype=object)
    for i in range(size):
        arr[i] = devs[i % len(devs)]
    return DeviceMesh(devices=arr.reshape(shape), axis_names=tuple(axis_names))


def _slot_device(device) -> torch.device:
    """A slot's device with its card index spelt out (``cuda`` is the
    current card), as a tensor on it reports its device."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def axis_index(mesh: DeviceMesh, pos: Sequence[int]) -> int:
    """Flat row-major slot index of mesh position ``pos`` (what
    ``compat.axis_index`` over every axis gives inside ``shard_map``)."""
    return int(np.ravel_multi_index(tuple(pos), mesh.shape))


def on_mesh(x, mesh: DeviceMesh) -> torch.Tensor:
    """A tensor stays where it is; anything else (numpy, lists) goes to the
    mesh's first device."""
    return x if isinstance(x, torch.Tensor) else as_tensor(x, mesh.device)
