"""Mixture-of-Experts FFN with GShard-style capacity dispatch (port of
``repro/models/moe.py``).

The reference's formulation, kept so that dropped tokens drop the same way:
tokens are split into groups of ``group_size``; within a group each expert
accepts at most ``C = ⌊group_size · top_k · capacity_factor / n_experts⌋``
tokens, in token order (a cumulative count per expert). Dispatch and
combine are one-hot (G, S, E, C) tensors contracted by ``einsum``, the
expert weights (E, d, f) batched products. A gather / scatter would compute
another function once a token overflows its expert. The router is
Mixtral-style top-k with softmax renormalisation, plus the Switch / GShard
load-balancing loss.

Two points where PyTorch differs from XLA and the port follows XLA:
``torch.topk`` does not promise the lowest index on ties, which decides
where the padded tokens of the last group (all logits -1e9) are routed and
so the aux loss, so the top k come from a stable descending sort; and the
positions within an expert are an f32 cumulative sum, exact to 2^24.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import _ACTS, ParamTree, gen_device, init_dense


def init_moe(generator: torch.Generator | None, d_model: int, d_ff: int, n_experts: int, *,
             gated: bool = True, dtype=torch.float32) -> ParamTree:
    """``router`` (d, E) and the experts' ``w1`` / ``w3`` (E, d, f) and ``w2``
    (E, f, d): N(0, 1) / sqrt(d_in), drawn f32 and cast one tensor at a time."""
    g, dev = generator, gen_device(generator)
    scale_in = 1.0 / np.sqrt(d_model)
    scale_out = 1.0 / np.sqrt(d_ff)

    def draw(*shape, scale):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    p = {"router": init_dense(g, d_model, n_experts, dtype=dtype),
         "w1": draw(n_experts, d_model, d_ff, scale=scale_in),
         "w2": draw(n_experts, d_ff, d_model, scale=scale_out)}
    if gated:
        p["w3"] = draw(n_experts, d_model, d_ff, scale=scale_in)
    return ParamTree(p)


def _route(logits: torch.Tensor, top_k: int, n_experts: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. logits: (G, S, E). Returns (gates (G,S,E) with top-k
    softmax-renormalised weights, mask (G,S,E) in {0,1}, aux_loss scalar)."""
    probs = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k: the largest first, the lowest index first among equals
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :top_k], top_idx[..., :top_k]
    top_w = torch.softmax(top_vals.float(), dim=-1)                 # renormalise
    mask = F.one_hot(top_idx, n_experts).float()                    # (G,S,k,E)
    gates = (top_w[..., None] * mask).sum(dim=2)                    # (G,S,E)
    mask_any = mask.sum(dim=2)                                      # (G,S,E)
    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f = mask_any.mean(dim=(0, 1))                                   # fraction routed
    P = probs.mean(dim=(0, 1))                                      # router prob mass
    aux = n_experts * torch.sum(f * P)
    return gates, mask_any, aux


def apply_moe(p, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 256,
              act: str = "silu", compute_dtype=torch.bfloat16
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) -> (B, S, d), plus the aux load-balance loss.

    Tokens are flattened and regrouped to ``group_size``; remainder tokens
    are padded into the last group (their router logits are -1e9, their
    outputs dropped)."""
    B, S, d = x.shape
    T = B * S
    g = min(group_size, T)
    G = -(-T // g)
    pad = G * g - T
    xt = x.reshape(T, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(G, g, d)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"]["w"].float())
    if pad:
        valid = (torch.arange(G * g, device=x.device) < T).reshape(G, g)
        logits = torch.where(valid[..., None], logits, torch.full_like(logits, -1e9))
    gates, mask, aux = _route(logits, top_k, n_experts)

    capacity = max(1, int(g * top_k * capacity_factor / n_experts))
    # position of each token within its expert's buffer (per group), in f32
    pos_in_expert = (torch.cumsum(mask, dim=1) - 1.0) * mask        # (G,S,E)
    keep = mask * (pos_in_expert < capacity)
    gates = gates * keep
    # renormalise combine weights after capacity drops
    gsum = gates.sum(-1, keepdim=True)
    combine = (gates / torch.clamp_min(gsum, 1e-9)) * (gsum > 0)
    onehot_c = (pos_in_expert[..., None]
                == torch.arange(capacity, dtype=torch.float32, device=x.device)).float()
    dispatch = keep[..., None] * onehot_c                           # (G,S,E,C)

    cdt = compute_dtype
    xc = xg.to(cdt)
    disp = dispatch.to(cdt)
    comb = (combine[..., None] * onehot_c).to(cdt)                  # (G,S,E,C)

    expert_in = torch.einsum("gsec,gsd->egcd", disp, xc)            # (E,G,C,d)
    h = torch.einsum("egcd,edf->egcf", expert_in, p["w1"].to(cdt))
    a = _ACTS[act](h)
    if "w3" in p:
        a = a * torch.einsum("egcd,edf->egcf", expert_in, p["w3"].to(cdt))
    expert_out = torch.einsum("egcf,efd->egcd", a, p["w2"].to(cdt))
    yg = torch.einsum("gsec,egcd->gsd", comb, expert_out)           # (G,S,d)

    y = yg.reshape(G * g, d)[:T].reshape(B, S, d)
    return y.to(x.dtype), aux
