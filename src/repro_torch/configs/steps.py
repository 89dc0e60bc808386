"""Training steps and step bundles (port of ``repro/configs/steps.py``: the
decoder-LM and bi-encoder families).

A ``StepBundle`` is what the launcher needs for one (arch × shape × mesh)
cell: the step function, shape stand-ins for every input (meta tensors in
the reference's trees, layers stacked: nothing is allocated), the spec trees
the arch's sharding rules resolve on the mesh (``par.sharding``) and the
analytic ``meta`` (model FLOPs, bytes, tokens, micro-batches). It has no
``jit`` and no ``lower``: the port runs eagerly, and places nothing by the
specs (one card); the launcher writes them into its checkpoints.

The step (``make_train_step``) takes a model, its optimizer state and a
batch, and updates both in place. With ``microbatch`` K > 1 the batch's
rows are cut into K sequential micro-batches; each one's gradients are cast
to ``accum_dtype`` and summed there (autograd would accumulate ``.grad`` in
the parameter's dtype), then loss and gradients are divided by K, as the
reference's scan does. The bi-encoder never micro-batches: in-batch
negatives make its loss a function of the whole batch.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from typing import Any

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.convert import (adamw_state_tree, decay_mask, reference_shapes, stack_layers,
                                 unstack_layers)
from repro_torch.models import biencoder as BE, transformer as T
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update, opt_state_specs
from repro_torch.optim.schedule import constant_lr
from repro_torch.par import sharding as SH
from repro_torch.par.mesh import DeviceMesh
from repro_torch.par.sharding import P
from repro_torch.util import tree_map


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """A shape stand-in: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple
    in_specs: tuple
    out_specs: Any
    mesh: DeviceMesh
    donate: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# shared optimizer plumbing
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn: Callable, model: nn.Module, batch: Mapping
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``(loss, grads)``: ``loss_fn(model, batch)`` (gradients enabled) and
    its gradient with respect to each of the model's parameters, by name.
    The parameters' ``.grad`` is left alone."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _adafactor_update(grads, state, named, lr) -> None:
    """Adafactor on the reference's stacked leaves (its statistics and clip
    read a whole stacked leaf), written back into the per-layer tensors."""
    params = stack_layers(named)
    adafactor_update(stack_layers(grads), state, params, lr)
    for name, t in unstack_layers(params).items():
        if t.data_ptr() != named[name].data_ptr():
            named[name].copy_(t)


def _opt_pack(optimizer: str):
    """``(init, update)``: ``init(model)`` the optimizer state, ``update(grads,
    state, named_params, lr)`` one step in place."""
    if optimizer == "adafactor":
        return (lambda model: adafactor_init(reference_shapes(dict(model.named_parameters())),
                                             device=next(model.parameters()).device),
                torch.no_grad()(_adafactor_update))
    if optimizer == "adamw":
        def init(model):
            named = dict(model.named_parameters())
            return adamw_init(named, decay_mask(named))
        return init, adamw_update
    raise ValueError(f"optimizer {optimizer!r}: the port has 'adamw' and 'adafactor'; the "
                     f"rowwise optimizer waits for the recsys family")


def _zero1_like(opt_sds: Any, base_specs: Any, params_sds: Any, mesh: DeviceMesh,
                optimizer: str) -> Any:
    if optimizer == "adamw":
        return opt_state_specs(base_specs, params_sds, mesh, zero1=True)
    # adafactor: factored leaves don't mirror param structure — dp-shard the
    # first divisible dim of each state leaf (ZeRO-1 flavoured)
    dp = SH.logical_to_physical("dp", mesh)
    sizes = SH.axis_sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def leaf_spec(leaf):
        for d, n in enumerate(leaf.shape):
            if n % dp_size == 0 and n > 1:
                parts = [None] * len(leaf.shape)
                parts[d] = dp if len(dp) > 1 else dp[0]
                return P(*parts)
        return P()

    return {"v": tree_map(leaf_spec, opt_sds["v"]), "step": P()}


def make_train_step(loss_fn: Callable, optimizer: str = "adamw", lr=1e-4,
                    microbatch: int = 1, accum_dtype=torch.float32):
    """``(step, opt_init)``: ``step(model, opt_state, batch, t=0)`` computes
    the loss and its gradients (over ``microbatch`` sequential slices of
    the batch's rows, gradients summed in ``accum_dtype``) and applies one
    optimizer update, in place, at ``lr``: a constant (the reference's,
    1e-4) or a schedule ``t -> lr`` (``optim.schedule``) read at step index
    ``t``; it returns ``{"loss": loss}``. ``opt_init(model)`` is the
    optimizer state (AdamW with the reference's decay mask, or Adafactor on
    the reference's stacked leaves). The model's parameters must require
    gradients."""
    opt_init, opt_update = _opt_pack(optimizer)
    lr_fn = lr if callable(lr) else constant_lr(lr)
    accum_dtype = torch_dtype(accum_dtype) if isinstance(accum_dtype, str) else accum_dtype

    def step(model: nn.Module, opt_state: dict, batch: Mapping, t: int = 0) -> dict:
        if microbatch <= 1:
            loss, grads = value_and_grad(loss_fn, model, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatch:
                raise ValueError(f"a batch of {rows} rows does not split into "
                                 f"{microbatch} micro-batches")
            b = rows // microbatch
            acc = {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for n, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatch):
                l, g = value_and_grad(loss_fn, model,
                                      {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
                for n, a in acc.items():
                    a.add_(g[n].to(accum_dtype))
                loss = loss + l
                del g
            loss = loss / microbatch
            grads = {n: a / microbatch for n, a in acc.items()}
            del acc
        opt_update(grads, opt_state, dict(model.named_parameters()), lr_fn(t))
        return {"loss": loss}

    return step, opt_init


def _microbatch_of(cfg) -> tuple[int, torch.dtype]:
    mb = getattr(cfg, "microbatch", 1) or 1
    return mb, torch_dtype(getattr(cfg, "grad_accum_dtype", "float32"))


def _dp(mesh: DeviceMesh):
    dp = SH.logical_to_physical("dp", mesh)
    return dp if len(dp) > 1 else dp[0]


def _opt_sds(named_meta: Mapping, optimizer: str) -> dict:
    """The optimizer state's shape tree (the reference's ``eval_shape`` of
    its ``opt_init``)."""
    if optimizer == "adafactor":
        return adafactor_init(reference_shapes(named_meta))
    return adamw_state_tree(adamw_init(named_meta))


def _train_bundle(name, mesh, named_meta, param_spec, batch_sds, batch_spec, loss_fn,
                  optimizer, meta, microbatch: int = 1,
                  accum_dtype=torch.float32) -> StepBundle:
    step, _ = make_train_step(loss_fn, optimizer, microbatch=microbatch,
                              accum_dtype=accum_dtype)
    params_sds = reference_shapes(named_meta)
    opt_sds = _opt_sds(named_meta, optimizer)
    opt_spec = _zero1_like(opt_sds, param_spec, params_sds, mesh, optimizer)
    return StepBundle(
        name=name, fn=step, mesh=mesh,
        args=(params_sds, opt_sds, batch_sds),
        in_specs=(param_spec, opt_spec, batch_spec),
        out_specs=(param_spec, opt_spec, {"loss": P()}),
        donate=(0, 1),
        meta=meta)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_param_sds(cfg: T.TransformerConfig, serve: bool):
    """(the parameters on the meta device by port name, the config): serving
    takes bf16 parameters, as the reference's serving bundles do."""
    c = dataclasses.replace(cfg, param_dtype="bfloat16") if serve else cfg
    return dict(T.init_lm(c, generator=None, device="meta").named_parameters()), c


def _lm_mem_bytes(cfg: T.TransformerConfig, kind: str, B: int, S: int) -> int:
    """Analytic global HBM traffic per step (the reference's napkin model).
    Attention interiors are assumed on-chip (a flash kernel)."""
    P_ = cfg.param_count()
    Pa = cfg.active_param_count()
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    kv = cfg.n_kv_heads * cfg.hd
    tokens = B * S
    if kind == "train":
        params = 3 * P_ * 2 + 2 * P_ * 4 + 4 * P_ * 4 + P_ * 4  # casts+grads+adam
        acts = L * tokens * d * 2 * 20          # fwd+bwd+remat tensor passes
        logits = 2 * 2 * tokens * V * 4 / max(1, S // 2048)  # chunked, fwd+bwd
        return int(params + acts + logits)
    if kind == "prefill":
        return int(P_ * 2 + L * tokens * d * 2 * 6 + 2 * L * tokens * kv * 2)
    if kind == "decode":
        cache = 2 * L * B * S * kv * 2
        return int(Pa * 2 + cache + B * V * 4)
    # decode_long: rolling window cache
    W = cfg.sliding_window or S
    return int(Pa * 2 + 2 * L * B * W * kv * 2 + B * V * 4)


def _lm_loss(model: T.LM, batch: Mapping) -> torch.Tensor:
    return T.forward_train(model, batch["tokens"], batch["labels"])


def lm_bundle(spec_: ArchSpec, cell: ShapeCell, mesh: DeviceMesh) -> StepBundle:
    cfg: T.TransformerConfig = spec_.cfg
    rules = (SH.lm_rules_dp_only() if cfg.parallelism == "dp_only"
             else SH.lm_rules(moe=cfg.n_experts > 0, moe_dp_dim=cfg.moe_dp_dim))
    S, B = cell.dims["seq_len"], cell.dims["global_batch"]
    dp = _dp(mesh)
    meta = dict(family="lm", arch=spec_.arch_id, shape=cell.name,
                params=cfg.param_count(), active_params=cfg.active_param_count(),
                dims=dict(cell.dims), n_layers=cfg.n_layers, d_model=cfg.d_model,
                vocab=cfg.vocab,
                analytic_bytes=_lm_mem_bytes(cfg, cell.kind, B, S))
    name = f"{spec_.arch_id}:{cell.name}"

    if cell.kind == "train":
        named, _ = _lm_param_sds(cfg, serve=False)
        pspec = SH.param_specs(reference_shapes(named), mesh, rules)
        batch_sds = {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
        bspec = {"tokens": P(dp, None), "labels": P(dp, None)}
        meta["model_flops"] = 6 * cfg.active_param_count() * B * S
        meta["tokens"] = B * S
        mb, adt = _microbatch_of(cfg)
        meta["microbatch"] = mb
        return _train_bundle(name, mesh, named, pspec, batch_sds, bspec, _lm_loss,
                             spec_.optimizer, meta, microbatch=mb, accum_dtype=adt)

    named, cfg_s = _lm_param_sds(cfg, serve=True)
    params_sds = reference_shapes(named)
    pspec = SH.param_specs(params_sds, mesh, rules)
    hd = cfg.hd
    meta["model_flops"] = 2 * cfg.active_param_count() * B * (
        S if cell.kind == "prefill" else 1)

    if cell.kind == "prefill":
        cache_spec = P(None, dp, "model", None, None)  # seq-sharded KV
        return StepBundle(
            name=name, fn=T.prefill, mesh=mesh,
            args=(params_sds, sds((B, S), torch.int32)),
            in_specs=(pspec, P(dp, None)),
            out_specs=(P(dp, None), (cache_spec, cache_spec)),
            meta=meta)

    if cell.kind == "decode":
        cache_sds = sds((cfg.n_layers, B, S, cfg.n_kv_heads, hd), torch.bfloat16)
        cache_spec = P(None, dp, "model", None, None)
        return StepBundle(
            name=name, fn=T.decode_step, mesh=mesh,
            args=(params_sds, (cache_sds, cache_sds),
                  sds((B,), torch.int32), sds((), torch.int32)),
            in_specs=(pspec, (cache_spec, cache_spec), P(dp), P()),
            out_specs=(P(dp, None), (cache_spec, cache_spec)),
            donate=(1,),
            meta=meta)

    if cell.kind == "decode_long":
        # sliding-window rolling buffer: live cache = window, not seq_len
        W = cfg.sliding_window
        if W is None:
            raise ValueError("long_500k requires a sub-quadratic arch")
        cache_sds = sds((cfg.n_layers, B, W, cfg.n_kv_heads, hd), torch.bfloat16)
        cache_spec = P(None, None, "model", None, None)  # B=1: shard window
        meta["window"] = W
        return StepBundle(
            name=name, fn=T.decode_step_sliding, mesh=mesh,
            args=(params_sds, (cache_sds, cache_sds),
                  sds((B,), torch.int32), sds((), torch.int32)),
            in_specs=(pspec, (cache_spec, cache_spec), P(), P()),
            out_specs=(P(None, None), (cache_spec, cache_spec)),
            donate=(1,),
            meta=meta)

    raise ValueError(f"unknown LM cell kind {cell.kind}")


# ---------------------------------------------------------------------------
# BiEncoder family (the paper's own model — examples/launcher, not a cell)
# ---------------------------------------------------------------------------


def biencoder_bundle(spec_: ArchSpec, cell: ShapeCell, mesh: DeviceMesh) -> StepBundle:
    cfg: BE.BiEncoderConfig = spec_.cfg
    rules = SH.biencoder_rules()
    dp = _dp(mesh)
    S, B = cell.dims["seq_len"], cell.dims["global_batch"]
    named = dict(BE.init_biencoder(cfg, generator=None, device="meta").named_parameters())
    pspec = SH.param_specs(reference_shapes(named), mesh, rules)
    n_params = cfg.param_count()
    tok = 2 * B * S
    mem = (3 * n_params * 2 + 11 * n_params * 4 + cfg.n_layers * tok * cfg.d_model * 2 * 20
           if cell.kind == "train" else
           n_params * 2 + cfg.n_layers * B * S * cfg.d_model * 2 * 6)
    meta = dict(family="biencoder", arch=spec_.arch_id, shape=cell.name,
                params=n_params, active_params=n_params, dims=dict(cell.dims),
                analytic_bytes=int(mem))
    name = f"{spec_.arch_id}:{cell.name}"

    if cell.kind == "train":
        batch_sds = {k: sds((B, S), torch.int32)
                     for k in ("q_tokens", "q_mask", "d_tokens", "d_mask")}
        bspec = {k: P(dp, None) for k in batch_sds}
        meta["model_flops"] = 6 * n_params * 2 * B * S
        return _train_bundle(name, mesh, named, pspec, batch_sds, bspec,
                             BE.contrastive_loss, spec_.optimizer, meta)

    meta["model_flops"] = 2 * n_params * B * S
    return StepBundle(
        name=name, fn=BE.encode, mesh=mesh,
        args=(reference_shapes(named), sds((B, S), torch.int32), sds((B, S), torch.int32)),
        in_specs=(pspec, P(dp, None), P(dp, None)),
        out_specs=P(dp, None), meta=meta)


BUNDLE_BUILDERS = {
    "lm": lm_bundle,
    "biencoder": biencoder_bundle,
}
