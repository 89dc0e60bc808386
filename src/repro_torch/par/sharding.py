"""Path-based sharding rules with divisibility fallback (port of
``repro/par/sharding.py``).

One engine drives every architecture on the same mesh: a rule proposes
logical shardings for a parameter-tree path; each *clause group* is tried in
order and the first group whose every (dim, axis) divides evenly is used.
That is what lets smollm (9 heads) and arctic (56 heads, 128 experts)
coexist on a 16-wide 'model' axis: smollm's attention falls through its
head-sharded clause to a replicated fallback while its MLP/vocab dims still
shard; arctic takes the expert-parallel clause.

Logical axes:
  * ``dp``  — data parallel: ('pod', 'data') when the mesh has a pod axis
  * ``tp``  — tensor parallel: ('model',)
  * ``ep``  — expert parallel: ('model',)   (same physical axis as tp —
              an expert-sharded layer is *not* additionally TP-sharded)
  * ``sp``  — sequence parallel: ('model',) for long-context KV/activations

Pure Python over a ``DeviceMesh``'s axis names and sizes. Paths and shapes
are the reference's: a tree whose layers are stacked on a leading axis
(``layers/attn/wq/w`` of shape (L, d, H·Dh)), so negative-dim clauses land
on the dims they land on there; ``convert.reference_shapes`` gives that
tree for a port model, whose layers are unstacked. ``shard_index`` and
``place`` are the counterpart of ``named_shardings``: the block each slot
holds, as the reference's ``NamedSharding`` gives it to that device. There
is no collective: the port is one process over the mesh's slots.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.par.mesh import DeviceMesh
from repro_torch.util import map_with_paths

LOGICAL_AXES = ("dp", "tp", "ep", "sp")

# A clause is (dim, logical_axis). A clause group is a tuple of clauses that
# must all fit. A rule maps a path regex to an ordered list of clause groups.
Clause = tuple[int, str]
ClauseGroup = tuple[Clause, ...]


class PartitionSpec:
    """Per dim: ``None`` (not sharded), one mesh axis name, or a tuple of
    names (the dim split over their product, the first the major one).
    Compared by value; ``to_json`` / ``from_json`` are the checkpoint
    manifest's ``spec`` entry, as the reference writes and reads it."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, (tuple, list)) else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"

    def to_json(self) -> list:
        return [list(p) if isinstance(p, tuple) else p for p in self.parts]

    @classmethod
    def from_json(cls, parts: list) -> "PartitionSpec":
        return cls(*parts)


P = PartitionSpec


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def logical_to_physical(logical: str, mesh: DeviceMesh) -> tuple[str, ...]:
    names = mesh.axis_names
    if logical == "dp":
        return tuple(n for n in ("pod", "data") if n in names) or (names[0],)
    if logical in ("tp", "ep", "sp"):
        return ("model",) if "model" in names else ()
    if logical == "fsdp":   # every mesh axis (huge embedding tables)
        return tuple(names)
    raise ValueError(f"unknown logical axis {logical}")


def _axis_size(mesh: DeviceMesh, phys: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[p] for p in phys)


@dataclasses.dataclass
class ShardingRules:
    """Ordered (regex, clause-groups) rules applied to '/'-joined tree paths."""

    rules: list[tuple[str, list[ClauseGroup]]]

    def spec(self, path: str, shape: Sequence[int], mesh: DeviceMesh) -> PartitionSpec:
        for pattern, groups in self.rules:
            if re.search(pattern, path):
                for group in groups:
                    assign: dict[int, tuple[str, ...]] = {}
                    ok = True
                    for dim, logical in group:
                        d = dim if dim >= 0 else len(shape) + dim
                        phys = logical_to_physical(logical, mesh)
                        if not phys or d >= len(shape) or d in assign:
                            ok = False
                            break
                        if shape[d] % _axis_size(mesh, phys) != 0:
                            ok = False
                            break
                        assign[d] = phys
                    if ok and assign:
                        parts: list[Any] = [None] * len(shape)
                        for d, phys in assign.items():
                            parts[d] = phys if len(phys) > 1 else phys[0]
                        return P(*parts)
                return P()  # matched a rule but nothing fits -> replicate
        return P()


def spec_for(tree: Any, mesh: DeviceMesh, rules: ShardingRules) -> Any:
    """PartitionSpec tree for a tree (nested dicts, tuples, lists) of
    anything with a ``shape`` (tensors, meta tensors), by '/'-joined path."""
    return map_with_paths(lambda path, leaf: rules.spec(path, tuple(leaf.shape), mesh), tree)


def param_specs(params_shape: Any, mesh: DeviceMesh, rules: ShardingRules) -> Any:
    return spec_for(params_shape, mesh, rules)


def data_spec(mesh: DeviceMesh, ndim: int, *, batch_dim: int = 0,
              extra: dict[int, str] | None = None) -> PartitionSpec:
    """Batch-dim over dp; optional extra {dim: logical} (divisibility NOT
    checked here — callers pass shapes they control)."""
    parts: list[Any] = [None] * ndim
    dp = logical_to_physical("dp", mesh)
    parts[batch_dim] = dp if len(dp) > 1 else dp[0]
    for d, logical in (extra or {}).items():
        phys = logical_to_physical(logical, mesh)
        if phys:
            parts[d] = phys if len(phys) > 1 else phys[0]
    return P(*parts)


def replicated(ndim: int) -> PartitionSpec:
    return P()


# ---------------------------------------------------------------------------
# placement: the block of a spec that each slot holds
# ---------------------------------------------------------------------------


def shard_index(shape: Sequence[int], spec: PartitionSpec, mesh: DeviceMesh,
                slot: int) -> tuple[slice, ...]:
    """The block of a ``shape`` array that slot ``slot`` (row-major) holds
    under ``spec``: per dim, the slot's mixed-radix position over the dim's
    axes (the first major) picks one of their product's equal blocks.
    Raises where a sharded dim does not divide."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.axis_names, np.unravel_index(int(slot), mesh.shape)))
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, part in enumerate(parts[:len(shape)]):
        if part is None:
            out.append(slice(0, shape[d]))
            continue
        axes = part if isinstance(part, tuple) else (part,)
        n, block = 1, 0
        for a in axes:
            block = block * sizes[a] + int(coord[a])
            n *= sizes[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {axes} ({n})")
        step = shape[d] // n
        out.append(slice(block * step, (block + 1) * step))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A tensor laid over a mesh by a spec: ``shards[i]`` is slot i's block
    (``shard_index``), on that slot's device."""

    shape: torch.Size
    spec: PartitionSpec
    mesh: DeviceMesh
    shards: tuple[torch.Tensor, ...]

    def full(self) -> torch.Tensor:
        """The whole tensor, assembled from the shards on the mesh's first device."""
        out = torch.empty(self.shape, dtype=self.shards[0].dtype, device=self.mesh.device)
        for slot, s in enumerate(self.shards):
            out[shard_index(self.shape, self.spec, self.mesh, slot)] = s.to(out.device)
        return out


def place(t: torch.Tensor, spec: PartitionSpec, mesh: DeviceMesh) -> ShardedTensor:
    """Each slot's block of ``t`` under ``spec``: a view where the slot's
    device is ``t``'s, else a copy on the slot's device."""
    return ShardedTensor(t.shape, spec, mesh, tuple(
        t[shard_index(t.shape, spec, mesh, slot)].to(dev)
        for slot, dev in enumerate(mesh.device_list)))


# ---------------------------------------------------------------------------
# Stock rule sets per model family
# ---------------------------------------------------------------------------


def lm_rules(moe: bool = False, moe_dp_dim: str = "ff") -> ShardingRules:
    """2-D FSDP×TP (+ EP or per-expert-TP) for decoder LMs — MaxText-style.

    Every weight matrix shards one dim over 'tp' (model axis) and, where it
    divides, a second dim over 'dp' (data [+pod] axes). Stacked layers add a
    leading L dim, so in-layer dims shift by +1 — rules use negative dims to
    stay layout-agnostic.
    """
    r: list[tuple[str, list[ClauseGroup]]] = [
        # embeddings: vocab over tp, d_model over dp
        (r"(^|/)embed$", [((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
        (r"(^|/)unembed$", [((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
        (r"pos_embed$", [()]),
        # attention: fused head dim over tp, d_model over dp; wo transposed
        (r"attn/w[qkv]/w$", [((-1, "tp"), (-2, "dp")), ((-1, "tp"),)]),
        (r"attn/w[qkv]/b$", [((-1, "tp"),)]),
        (r"attn/wo/w$", [((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
        # dense MLP: ff over tp, d_model over dp
        (r"mlp/w[13]/w$", [((-1, "tp"), (-2, "dp")), ((-1, "tp"),)]),
        (r"mlp/w2/w$", [((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
    ]
    if moe:
        if moe_dp_dim == "d_model":
            # EP over tp + d_model over dp
            r += [
                (r"moe/w[13]$", [((-3, "ep"), (-2, "dp")), ((-3, "ep"),),
                                 ((-1, "tp"), (-2, "dp")), ((-1, "tp"),)]),
                (r"moe/w2$", [((-3, "ep"), (-1, "dp")), ((-3, "ep"),),
                              ((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
                (r"moe/router", [()]),
            ]
        else:
            r += [
                # experts: EP over tp + ff over dp; fallbacks degrade gracefully
                (r"moe/w[13]$", [((-3, "ep"), (-1, "dp")), ((-3, "ep"),),
                                 ((-1, "tp"), (-2, "dp")), ((-1, "tp"),)]),
                (r"moe/w2$", [((-3, "ep"), (-2, "dp")), ((-3, "ep"),),
                              ((-2, "tp"), (-1, "dp")), ((-2, "tp"),)]),
                (r"moe/router", [()]),
            ]
    r.append((r".*", [()]))
    return ShardingRules(r)


def lm_rules_dp_only() -> ShardingRules:
    """Pure data parallelism: params replicated (ZeRO-1 still dp-shards the
    optimizer moments)."""
    return ShardingRules([(r".*", [()])])


def biencoder_rules() -> ShardingRules:
    base = lm_rules(moe=False).rules
    return ShardingRules([(r"(^|/)proj/w$", [((-2, "tp"),)])] + base)


def gnn_rules() -> ShardingRules:
    # GNN params are small MLPs — replicate everything; parallelism lives in
    # the edge/node data sharding.
    return ShardingRules([(r".*", [()])])


def recsys_rules() -> ShardingRules:
    return ShardingRules([
        # big embedding tables: rows FSDP-sharded over every mesh axis
        (r"tables/\d+$", [((0, "fsdp"),), ((0, "tp"),)]),
        (r"(user|item)_embed$", [((0, "fsdp"),), ((0, "tp"),)]),
        (r"first_order/\d+$", [((0, "fsdp"),), ((0, "tp"),)]),
        # MLPs: modest — shard the wide hidden dims where divisible
        (r"(bot_mlp|top_mlp|deep_mlp|user_tower|item_tower)/\d+/w$",
         [((-1, "tp"),)]),
        (r".*", [()]),
    ])
