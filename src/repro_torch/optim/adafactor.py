"""Adafactor (factored second moments) — the 480B-scale optimizer (port of
``repro/optim/adafactor.py``).

For a (..., r, c) param the second moment is stored as row/col means
(O(r+c) memory instead of O(r·c)); vectors fall back to full moments.
No first moment (beta1=0 variant).

The update is not elementwise: the factored moments and the RMS clip read
a whole leaf. So it runs on the reference's tree, whose layer leaves are
stacked on a leading L axis (``convert.stack_layers``): a stacked (L, d)
norm scale is factored across layers there, and a (L, r, c) matrix clips
over all its layers at once. Parameters, gradients and state are nested
mappings of tensors in that layout; the update writes the parameter leaves
and the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.util import flatten_with_paths, map_with_paths


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8          # beta2 exponent schedule: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _factored(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor_init(params: Any, device=None) -> dict:
    """Zero f32 statistics per leaf (``vr`` / ``vc`` where factored, else
    ``v``) and an int32 step of 0, on ``device`` (default: each leaf's)."""
    def init(_, p):
        dev = device or p.device
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=dev)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=dev)}

    leaves = flatten_with_paths(params)
    dev = device or (leaves[0][1].device if leaves else torch.device("cpu"))
    return {"v": map_with_paths(init, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(grads: Any, state: dict, params: Any, lr,
                     cfg: AdafactorConfig = AdafactorConfig()) -> None:
    """One step at learning rate ``lr``: ``params`` (a tree of tensors) and
    ``state`` (``adafactor_init``'s) updated in place from ``grads`` (a tree
    of the same structure)."""
    step = state["step"] + 1
    beta2 = 1.0 - torch.pow(step.float(), -cfg.decay)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    grads = dict(flatten_with_paths(grads))
    stats = dict(flatten_with_paths(state["v"]))
    for path, p in flatten_with_paths(params):
        g = grads[path].float()
        g2 = g * g + cfg.eps
        if _factored(p):
            vr, vc = stats[path + "/vr"], stats[path + "/vc"]
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            # denom broadcasts against vr[..., None]: add the trailing axis
            denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), cfg.eps)[..., None]
            u = g * torch.rsqrt(vr[..., None] / denom) * torch.rsqrt(vc[..., None, :])
        else:
            v = stats[path + "/v"]
            v.copy_(beta2 * v + (1 - beta2) * g2)
            u = g * torch.rsqrt(v)
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms / cfg.clip_threshold, 1.0)
        if cfg.weight_decay and p.ndim >= 2:
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    state["step"] = step
