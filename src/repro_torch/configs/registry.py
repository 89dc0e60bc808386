"""Architecture registry: ``--arch`` lookup, shape cells, step bundles (port
of ``repro/configs/registry.py``).

Every architecture of the reference is listed, in its order, and ported:
the decoder LMs, the GNN family (graphcast), the recsys family (DLRM,
AutoInt, DeepFM, the two-tower retrieval model) and the paper's
bi-encoder.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.configs import (
    arctic_480b,
    autoint,
    biencoder_msmarco,
    deepfm,
    dlrm_mlperf,
    graphcast,
    mixtral_8x7b,
    phi3_medium_14b,
    qwen2_1_5b,
    smollm_135m,
    two_tower_retrieval,
)
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.configs.steps import BUNDLE_BUILDERS, StepBundle
from repro_torch.par.mesh import DeviceMesh

_MODULES = {
    "mixtral-8x7b": mixtral_8x7b,
    "arctic-480b": arctic_480b,
    "qwen2-1.5b": qwen2_1_5b,
    "phi3-medium-14b": phi3_medium_14b,
    "smollm-135m": smollm_135m,
    "graphcast": graphcast,
    "dlrm-mlperf": dlrm_mlperf,
    "autoint": autoint,
    "deepfm": deepfm,
    "two-tower-retrieval": two_tower_retrieval,
    # the paper's own encoder (examples/launcher; not a graded cell)
    "biencoder-msmarco": biencoder_msmarco,
}

ARCHS = tuple(k for k in _MODULES if k != "biencoder-msmarco")


def list_archs(include_extra: bool = False) -> tuple[str, ...]:
    return tuple(_MODULES) if include_extra else ARCHS


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; "
                       f"known: {sorted(_MODULES)}") from None


def get_arch(arch_id: str) -> ArchSpec:
    return _module(arch_id).spec()


def get_smoke_cfg(arch_id: str):
    return _module(arch_id).smoke_cfg()


def cells(include_skipped: bool = True) -> Iterator[tuple[ArchSpec, ShapeCell]]:
    """Every (arch × shape) dry-run cell, in registry order."""
    for arch_id in ARCHS:
        spec = get_arch(arch_id)
        for cell in spec.shapes:
            if cell.skip_reason and not include_skipped:
                continue
            yield spec, cell


def make_step_bundle(arch_id: str, shape: str, mesh: DeviceMesh) -> StepBundle:
    spec = get_arch(arch_id)
    cell = spec.cell(shape)
    if cell.skip_reason:
        raise ValueError(f"{arch_id}:{shape} is skipped: {cell.skip_reason}")
    return BUNDLE_BUILDERS[spec.family](spec, cell, mesh)
