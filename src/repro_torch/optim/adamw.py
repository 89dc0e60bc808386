"""AdamW (port of ``repro/optim/adamw.py``: the update, without ZeRO-1).

Parameters, gradients and moments are mappings from a parameter's name
(``named_parameters()``) to its tensor. The update is the reference's
arithmetic in float32 and in its order: the global-norm clip, the ``b1`` /
``b2`` moments, bias correction by ``b ** step``, ``eps`` outside the square
root, decoupled weight decay on the parameters that the decay mask names,
and the parameter update rounded to the parameter's dtype. It writes the
parameters and moments in place.

The reference decays a leaf of its tree whose ``ndim >= 2`` (matrices).
``adamw_init`` takes the mask, by name, because the port's tensor need not
be the reference's leaf: a model whose reference stacks its layers has
per-layer norms that are ``(L, d)`` leaves there and decay
(``convert.decay_mask``). Without one, the rule applies to the tensors as
given.

``zero1_specs`` and ``opt_state_specs`` give the ZeRO-1 layout of the
moments: each parameter's spec with one more dim sharded over the data
axes. They take the reference's trees (``convert.reference_shapes``), as
the specs describe its stacked leaves.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from repro_torch.par.mesh import DeviceMesh
from repro_torch.par.sharding import P, PartitionSpec, axis_sizes, logical_to_physical
from repro_torch.util import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Mapping[str, torch.Tensor],
               decay: Mapping[str, bool] | None = None) -> dict:
    """Zero f32 moments beside each parameter, an int32 step of 0 on the
    parameters' device, and the decay mask: ``decay[name]`` says whether
    the parameter decays (default: ``p.ndim >= 2``)."""
    params = dict(params)
    dev = next(iter(params.values())).device if params else torch.device("cpu")
    if decay is None:
        decay = {n: p.ndim >= 2 for n, p in params.items()}
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "decay": {n: bool(decay[n]) for n in params}}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm of all the tensors together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors.values()))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], lr,
                 cfg: AdamWConfig = AdamWConfig()) -> None:
    """One AdamW step: ``params`` and ``state`` (``adamw_init``'s) are
    updated in place from ``grads`` at learning rate ``lr`` (a float or a
    0-d f32 tensor)."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-9), 1.0)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for name, p in params.items():
        g = grads[name].float() * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if state["decay"][name]:    # the reference's matrices (llama convention)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of the moments
# ---------------------------------------------------------------------------


def zero1_specs(param_spec_tree, params_shape, mesh: DeviceMesh):
    """Extend each param spec by sharding one more dim over the dp axes."""
    dp = logical_to_physical("dp", mesh)
    sizes = axis_sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def extend(spec: PartitionSpec, leaf) -> PartitionSpec:
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used: set = set()
        for part in parts:
            if part is None:
                continue
            used.update(part if isinstance(part, tuple) else (part,))
        if used.intersection(dp):   # dp axes already consumed (e.g. FSDP rows)
            return P(*parts)
        for d, cur in enumerate(parts):
            if cur is None and leaf.shape[d] % dp_size == 0 and leaf.shape[d] > 1:
                parts[d] = dp if len(dp) > 1 else dp[0]
                return P(*parts)
        return P(*parts)

    return tree_map(extend, param_spec_tree, params_shape)


def opt_state_specs(param_spec_tree, params_shape, mesh: DeviceMesh, *,
                    zero1: bool = True) -> dict:
    mom = (zero1_specs(param_spec_tree, params_shape, mesh)
           if zero1 else param_spec_tree)
    return {"mu": mom, "nu": mom, "step": P()}
