"""Training steps and step bundles (port of ``repro/configs/steps.py``: the
decoder-LM, GNN, recsys and bi-encoder families).

A ``StepBundle`` is what the launcher needs for one (arch × shape × mesh)
cell: the step function, shape stand-ins for every input (meta tensors in
the reference's trees, layers stacked: nothing is allocated), the spec trees
the arch's sharding rules resolve on the mesh (``par.sharding``) and the
analytic ``meta`` (model FLOPs, bytes, tokens, micro-batches), and the
model on the meta device (``model``) with, for a train step, its optimizer
state's init (``opt_init``): what ``launch.flops`` runs the step on to
count it. It has no ``jit`` and no ``lower``: the port runs eagerly, and
places nothing by the specs (one card); the launcher writes them into its
checkpoints.

The step (``make_train_step``) takes a model, its optimizer state and a
batch, and updates both in place. With ``microbatch`` K > 1 the batch's
rows are cut into K sequential micro-batches; each one's gradients are cast
to ``accum_dtype`` and summed there (autograd would accumulate ``.grad`` in
the parameter's dtype), then loss and gradients are divided by K, as the
reference's scan does. The bi-encoder never micro-batches: in-batch
negatives make its loss a function of the whole batch.

The recsys CTR models train with the rowwise step
(``_recsys_rowwise_bundle``): table rows are gathered outside autograd,
the loss is differentiated with respect to the rows and the other
parameters, AdamW updates the rest and rowwise AdaGrad the tables, in
place. Retrieval cells search through the port's index machinery: one
``topk_score`` per slot of the mesh (the kernel on the card) and the
staged merge.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from typing import Any

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchSpec, ShapeCell, round_up
from repro_torch.convert import (adamw_state_tree, decay_mask, reference_shapes, stack_layers,
                                 unstack_layers)
from repro_torch.core.index import (ShardedDenseIndex, _delta_topk, _topk_merge,
                                    merge_segment_topk, project_queries)
from repro_torch.models import biencoder as BE, gnn as G, recsys as R, transformer as T
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update, opt_state_specs
from repro_torch.optim.rowwise import rowwise_adagrad_update, rowwise_init_table
from repro_torch.optim.schedule import constant_lr
from repro_torch.par import sharding as SH
from repro_torch.par.mesh import DeviceMesh
from repro_torch.par.sharding import P
from repro_torch.util import as_tensor, tree_map

TOPK_SERVE = 100  # retrieval top-k


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
    model: nn.Module | None = None          # the parameters on the meta device
    opt_init: Callable | None = None        # model -> optimizer state (train steps)


# ---------------------------------------------------------------------------
# shared optimizer plumbing
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn: Callable, model: nn.Module, batch: Mapping
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``(loss, grads)``: ``loss_fn(model, batch)`` (gradients enabled) and
    its gradient with respect to each of the model's parameters, by name.
    A parameter the loss does not reach raises, unless the model names it
    in ``unreached_params`` (the GNN's last edge norm): that one gets zeros,
    as JAX gives. The parameters' ``.grad`` is left alone."""
    params = dict(model.named_parameters())
    unreached = frozenset(getattr(model, "unreached_params", ()))
    live = [n for n in params if n not in unreached]
    with torch.enable_grad():
        loss = loss_fn(model, batch)
        grads = dict(zip(live, torch.autograd.grad(loss, [params[n] for n in live])))
    return loss.detach(), {n: grads[n] if n in grads else torch.zeros_like(p)
                           for n, p in params.items()}


def _is_table(name: str) -> bool:
    return name.split(".")[0] == "tables"


def rowwise_opt_init(model: nn.Module) -> dict:
    """Rowwise-AdaGrad tables + AdamW rest (see ``optim.rowwise``): AdamW
    over every parameter but ``tables``, one f32 accumulator a table row."""
    rest = {n: p for n, p in model.named_parameters() if not _is_table(n)}
    return {"adamw": adamw_init(rest), "acc": [rowwise_init_table(t) for t in model.tables]}


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
    if optimizer == "rowwise":
        return rowwise_opt_init, None   # the update lives in the rowwise bundle
    if optimizer == "adamw":
        def init(model):
            named = dict(model.named_parameters())
            return adamw_init(named, decay_mask(named))
        return init, adamw_update
    raise ValueError(f"optimizer {optimizer!r}: the port has 'adamw', 'adafactor' and "
                     f"'rowwise'")


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
    if opt_update is None:
        raise ValueError(f"optimizer {optimizer!r}: its update lives in the rowwise bundle "
                         f"(_recsys_rowwise_bundle); make_train_step takes 'adamw' or "
                         f"'adafactor'")
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


def _train_bundle(name, mesh, model, param_spec, batch_sds, batch_spec, loss_fn,
                  optimizer, meta, microbatch: int = 1,
                  accum_dtype=torch.float32) -> StepBundle:
    step, opt_init = make_train_step(loss_fn, optimizer, microbatch=microbatch,
                                     accum_dtype=accum_dtype)
    named_meta = dict(model.named_parameters())
    params_sds = reference_shapes(named_meta)
    opt_sds = _opt_sds(named_meta, optimizer)
    opt_spec = _zero1_like(opt_sds, param_spec, params_sds, mesh, optimizer)
    return StepBundle(
        name=name, fn=step, mesh=mesh,
        args=(params_sds, opt_sds, batch_sds),
        in_specs=(param_spec, opt_spec, batch_spec),
        out_specs=(param_spec, opt_spec, {"loss": P()}),
        donate=(0, 1),
        meta=meta, model=model, opt_init=opt_init)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_param_sds(cfg: T.TransformerConfig, serve: bool):
    """(the model on the meta device, the config): serving takes bf16
    parameters, as the reference's serving bundles do."""
    c = dataclasses.replace(cfg, param_dtype="bfloat16") if serve else cfg
    return T.init_lm(c, generator=None, device="meta"), c


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
        model, _ = _lm_param_sds(cfg, serve=False)
        pspec = SH.param_specs(reference_shapes(dict(model.named_parameters())), mesh, rules)
        batch_sds = {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
        bspec = {"tokens": P(dp, None), "labels": P(dp, None)}
        meta["model_flops"] = 6 * cfg.active_param_count() * B * S
        meta["tokens"] = B * S
        mb, adt = _microbatch_of(cfg)
        meta["microbatch"] = mb
        return _train_bundle(name, mesh, model, pspec, batch_sds, bspec, _lm_loss,
                             spec_.optimizer, meta, microbatch=mb, accum_dtype=adt)

    model, cfg_s = _lm_param_sds(cfg, serve=True)
    params_sds = reference_shapes(dict(model.named_parameters()))
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
            meta=meta, model=model)

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
            meta=meta, model=model)

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
            meta=meta, model=model)

    raise ValueError(f"unknown LM cell kind {cell.kind}")


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_bundle(spec_: ArchSpec, cell: ShapeCell, mesh: DeviceMesh) -> StepBundle:
    cfg: G.GNNConfig = spec_.cfg
    d = cell.dims
    all_axes = tuple(mesh.axis_names)

    if cell.kind == "train_sampled":
        # static padded subgraph from the CSR fanout sampler
        bn, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
        N = bn + bn * f0 + bn * f0 * f1
        E = bn * f0 + bn * f0 * f1
    elif cell.name == "molecule":
        N = d["batch"] * d["n_nodes"]
        E = d["batch"] * d["n_edges"]
    else:
        N, E = d["n_nodes"], d["n_edges"]
    d_feat = d["d_feat"]

    big = E >= 1_000_000
    E_pad = round_up(E, 512) if big else E
    cfg_r = dataclasses.replace(cfg, d_in=d_feat)

    model = G.init_gnn(cfg_r, generator=None, device="meta")
    pspec = SH.param_specs(reference_shapes(dict(model.named_parameters())), mesh,
                           SH.gnn_rules())

    batch_sds = {
        "nodes": sds((N, d_feat)),
        "edges": sds((E_pad, cfg.d_edge_in)),
        "edge_index": sds((2, E_pad), torch.int32),
        "edge_mask": sds((E_pad,)),
        "targets": sds((N, cfg.d_out)),
        "node_mask": sds((N,)),
    }
    # big graphs: edges shard over every axis (pure data); node tables
    # replicate. Small graphs (< 1M edges, not shard-even) replicate fully.
    if big:
        bspec = {"nodes": P(), "edges": P(all_axes, None),
                 "edge_index": P(None, all_axes), "edge_mask": P(all_axes),
                 "targets": P(), "node_mask": P()}
    else:
        bspec = {k: P() if v.ndim == 1 else P(*([None] * v.ndim))
                 for k, v in batch_sds.items()}

    h = cfg.d_hidden
    fwd_flops = 2 * (E * (4 * h * h) + N * (3 * h * h)) * cfg.n_layers \
        + 2 * N * (d_feat * h + h * h) + 2 * E_pad * (cfg.d_edge_in * h + h * h) \
        + 2 * N * (h * h + h * cfg.d_out)
    # traffic: per layer, gather 2 endpoint features + write messages +
    # scatter-add, fwd+bwd+remat (~3x); params negligible
    mem = 3 * cfg.n_layers * (3 * E * h * 4 + 4 * N * h * 4) \
        + 3 * N * (d_feat + cfg.d_out) * 4
    meta = dict(family="gnn", arch=spec_.arch_id, shape=cell.name,
                params=cfg_r.param_count(), active_params=cfg_r.param_count(),
                model_flops=3 * fwd_flops,  # fwd + bwd(2x)
                n_nodes=N, n_edges=E_pad, d_hidden=h,
                dims=dict(cell.dims), analytic_bytes=int(mem))
    return _train_bundle(f"{spec_.arch_id}:{cell.name}", mesh, model, pspec, batch_sds,
                         bspec, G.mse_loss, spec_.optimizer, meta)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------


def _recsys_mem_bytes(cfg: R.RecsysConfig, kind: str, B: int, C: int = 0) -> int:
    """Analytic global HBM traffic (the reference's model). NOTE the
    dense-optimizer reality: AdamW moments for the full embedding tables
    are read+written every step — the dominant term for DLRM-scale tables
    (what the rowwise optimizer removes)."""
    e = cfg.embed_dim
    if cfg.kind == "two_tower":
        table_p = (cfg.user_vocab + cfg.item_vocab) * e
        dims = (e,) + cfg.tower_mlp
        mlp_p = 2 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        if kind == "train":
            return int(3 * 2 * B * e * 4 + 6 * table_p * 4 + 7 * mlp_p * 4
                       + 3 * B * B * 4)
        if kind == "serve":
            return int(2 * B * e * 4 + mlp_p * 4 + 3 * B * sum(dims) * 4)
        return int(C * cfg.tower_mlp[-1] * 4 + mlp_p * 4 + e * 4)
    F = cfg.n_sparse
    table_p = sum(cfg.vocab_sizes) * e
    mlp_p = cfg.param_count() - table_p
    act_w = F * e + (sum(cfg.bot_mlp) + sum(cfg.top_mlp)
                     + sum(cfg.deep_mlp) + cfg.n_attn_layers
                     * cfg.n_heads * cfg.d_attn * F)
    if kind == "train":
        return int(3 * B * F * e * 4 + 6 * table_p * 4 + 7 * mlp_p * 4
                   + 3 * B * act_w * 4)
    if kind == "serve":
        return int(B * F * e * 4 + mlp_p * 4 + B * act_w * 4)
    f_item = F - F // 2
    return int(C * f_item * e * 4 + mlp_p * 4 + C * act_w * 4)


def _recsys_active(cfg: R.RecsysConfig) -> int:
    """Params actually touched per sample (few embedding rows, all MLPs)."""
    e = cfg.embed_dim
    emb_rows = (cfg.n_sparse if cfg.kind != "two_tower" else 2) * e
    total = cfg.param_count()
    table_rows = (sum(cfg.vocab_sizes) * e if cfg.kind != "two_tower"
                  else (cfg.user_vocab + cfg.item_vocab) * e)
    return total - table_rows + emb_rows


def _ctr_flops_per_sample(cfg: R.RecsysConfig) -> int:
    e = cfg.embed_dim
    F = cfg.n_sparse
    if cfg.kind == "dlrm":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        bot = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        f = F + 1
        inter = 2 * f * f * e
        d_int = f * (f - 1) // 2 + cfg.bot_mlp[-1]
        dims = (d_int,) + cfg.top_mlp
        top = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return bot + inter + top
    if cfg.kind == "deepfm":
        dims = (F * e,) + cfg.deep_mlp + (1,)
        deep = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return deep + 4 * F * e
    if cfg.kind == "autoint":
        d_l = [e] + [cfg.n_heads * cfg.d_attn] * cfg.n_attn_layers
        fl = 0
        for i in range(cfg.n_attn_layers):
            fl += 2 * F * d_l[i] * (4 * d_l[i + 1]) + 2 * F * F * d_l[i + 1] * 2
        return fl + 2 * F * d_l[-1]
    dims = (e,) + cfg.tower_mlp
    return 2 * sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def recsys_bundle(spec_: ArchSpec, cell: ShapeCell, mesh: DeviceMesh) -> StepBundle:
    cfg: R.RecsysConfig = spec_.cfg
    rules = SH.recsys_rules()
    dp = _dp(mesh)
    all_axes = tuple(mesh.axis_names)
    model = R.init_recsys(cfg, generator=None, device="meta")
    named = dict(model.named_parameters())
    params_sds = reference_shapes(named)
    pspec = SH.param_specs(params_sds, mesh, rules)
    B = cell.dims["batch"]
    C0 = round_up(cell.dims.get("n_candidates", 0), 512)
    meta = dict(family="recsys", arch=spec_.arch_id, shape=cell.name,
                params=cfg.param_count(), active_params=_recsys_active(cfg),
                model_flops=None, dims=dict(cell.dims),
                analytic_bytes=_recsys_mem_bytes(cfg, cell.kind, B, C0))
    name = f"{spec_.arch_id}:{cell.name}"

    if cfg.kind == "two_tower":
        return _two_tower_bundle(spec_, cell, mesh, cfg, model, pspec, meta)

    F = cfg.n_sparse
    batch_sds = {"sparse": sds((B, F), torch.int32), "label": sds((B,), torch.float32)}
    bspec = {"sparse": P(dp, None), "label": P(dp)}
    if cfg.kind == "dlrm":
        batch_sds["dense"] = sds((B, cfg.n_dense), torch.float32)
        bspec["dense"] = P(dp, None)

    per_sample = _ctr_flops_per_sample(cfg)
    if cell.kind == "train":
        meta["model_flops"] = 3 * per_sample * B
        if spec_.optimizer == "rowwise":
            # sparse-grad table path: optimizer traffic O(batch·dim), see
            # optim.rowwise. Analytic bytes shrink accordingly.
            e = cfg.embed_dim
            meta["analytic_bytes"] = int(
                6 * B * cfg.n_sparse * e * 4      # gather + grad + scatter
                + 7 * (meta["params"] - sum(cfg.vocab_sizes) * e) * 4
                + 3 * B * 4096)
            return _recsys_rowwise_bundle(name, mesh, model, pspec, batch_sds, bspec, meta)
        return _train_bundle(name, mesh, model, pspec, batch_sds, bspec, R.bce_loss,
                             spec_.optimizer, meta)

    if cell.kind == "serve":
        meta["model_flops"] = per_sample * B
        return StepBundle(
            name=name, fn=R.forward_ctr, mesh=mesh,
            args=(params_sds, batch_sds),
            in_specs=(pspec, bspec), out_specs=P(dp),
            meta=meta, model=model)

    # retrieval: 1 user context vs C candidate items
    C = round_up(cell.dims["n_candidates"], 512)
    f_user, f_item = R.ctr_user_item_split(cfg)
    user_sds = {"sparse": sds((1, f_user), torch.int32)}
    uspec = {"sparse": P()}
    if cfg.kind == "dlrm":
        user_sds["dense"] = sds((1, cfg.n_dense), torch.float32)
        uspec["dense"] = P()
    meta["model_flops"] = per_sample * C
    meta["n_candidates"] = C

    def fn(model, user_batch, cand_sparse):
        scores = R.ctr_retrieval_scores(model, user_batch, cand_sparse)
        return _sharded_topk_1d(scores, TOPK_SERVE, mesh)

    return StepBundle(
        name=name, fn=fn, mesh=mesh,
        args=(params_sds, user_sds, sds((C, f_item), torch.int32)),
        in_specs=(pspec, uspec, P(all_axes, None)),
        out_specs=(P(), P()),
        meta=meta, model=model)


def _recsys_rowwise_bundle(name, mesh, model, pspec, batch_sds, bspec, meta) -> StepBundle:
    """CTR train step with rows gathered OUTSIDE autograd + rowwise AdaGrad.

    ``step(model, opt_state, batch, t=0)``: each table's rows at the
    batch's ids are gathered without autograd (dense table grads never
    exist), the loss is differentiated with respect to the rows and every
    non-table parameter, AdamW updates the rest and the rowwise update the
    tables and their accumulators, in place, at the reference's constant
    lr of 1e-4. The non-table parameters must require gradients.
    """
    lr = 1e-4

    def step(model: R.RecsysModel, opt_state: dict, batch: Mapping, t: int = 0) -> dict:
        dev = model.device
        batch = {k: as_tensor(v, dev) for k, v in batch.items()}
        idx = batch["sparse"]                                   # (B, F)
        tables = list(model.tables)
        with torch.no_grad():
            rows = [tab[idx[:, f].long()] for f, tab in enumerate(tables)]
        rest = {n: p for n, p in model.named_parameters() if not _is_table(n)}
        with torch.enable_grad():
            rows = [r.requires_grad_(True) for r in rows]
            emb = torch.stack(rows, dim=1).float()
            logit = R.forward_ctr_from_emb(model, emb, batch)
            loss = R.bce_from_logit(logit, batch["label"].float())
            grads = torch.autograd.grad(loss, [*rest.values(), *rows])
        adamw_update(dict(zip(rest, grads[:len(rest)])), opt_state["adamw"], rest, lr)
        for f, (tab, acc, g) in enumerate(zip(tables, opt_state["acc"], grads[len(rest):])):
            rowwise_adagrad_update(tab, acc, idx[:, f], g, lr)
        return {"loss": loss.detach()}

    named = dict(model.named_parameters())
    rest_named = {n: t for n, t in named.items() if not _is_table(n)}
    rest_sds = reference_shapes(rest_named)
    params_sds = reference_shapes(named)
    opt_sds = {"adamw": adamw_state_tree(adamw_init(rest_named)),
               "acc": [sds((t.shape[0],)) for t in params_sds["tables"]]}
    rest_spec = {k: v for k, v in pspec.items() if k != "tables"}
    opt_spec = {"adamw": opt_state_specs(rest_spec, rest_sds, mesh),
                "acc": [P(s[0]) for s in pspec["tables"]]}   # rows spec of each table
    meta["optimizer"] = "rowwise-adagrad"
    return StepBundle(
        name=name, fn=step, mesh=mesh,
        args=(params_sds, opt_sds, batch_sds),
        in_specs=(pspec, opt_spec, bspec),
        out_specs=(pspec, opt_spec, {"loss": P()}),
        donate=(0, 1),
        meta=meta, model=model, opt_init=rowwise_opt_init)


def _two_tower_bundle(spec_, cell, mesh, cfg, model, pspec, meta) -> StepBundle:
    dp = _dp(mesh)
    all_axes = tuple(mesh.axis_names)
    B = cell.dims["batch"]
    per_sample = _ctr_flops_per_sample(cfg)
    name = f"{spec_.arch_id}:{cell.name}"
    params_sds = reference_shapes(dict(model.named_parameters()))

    if cell.kind == "train":
        batch_sds = {"user_ids": sds((B,), torch.int32),
                     "item_ids": sds((B,), torch.int32),
                     "item_logq": sds((B,), torch.float32)}
        bspec = {"user_ids": P(dp), "item_ids": P(dp), "item_logq": P(dp)}
        meta["model_flops"] = 3 * (per_sample * B + 2 * B * B * cfg.tower_mlp[-1])
        return _train_bundle(name, mesh, model, pspec, batch_sds, bspec, R.two_tower_loss,
                             spec_.optimizer, meta)

    if cell.kind == "serve":
        batch_sds = {"user_ids": sds((B,), torch.int32),
                     "item_ids": sds((B,), torch.int32)}
        bspec = {"user_ids": P(dp), "item_ids": P(dp)}
        meta["model_flops"] = per_sample * B

        def serve(model, batch):
            u = R.user_embedding(model, batch["user_ids"])
            v = R.item_embedding(model, batch["item_ids"])
            return (u * v).sum(-1)

        return StepBundle(
            name=name, fn=serve, mesh=mesh,
            args=(params_sds, batch_sds),
            in_specs=(pspec, bspec), out_specs=P(dp), meta=meta, model=model)

    # retrieval_cand: THE paper cell — user query vs precomputed item index.
    # dims overrides (variants): index_dim = m after PCA pruning, int8 =
    # quantised index (+ per-dim scale folded into the query).
    C = round_up(cell.dims["n_candidates"], 512)
    d_full = cfg.tower_mlp[-1]
    m = int(cell.dims.get("index_dim", d_full))
    int8 = bool(cell.dims.get("int8", 0))
    store = torch.int8 if int8 else torch.float32
    index_sds = sds((C, m), store)
    meta["model_flops"] = per_sample // 2 + 2 * C * m + 2 * d_full * m
    meta["n_candidates"] = C
    meta["index_dim"] = m
    meta["index_int8"] = int8
    meta["analytic_bytes"] = int(C * m * (1 if int8 else 4)
                                 + 2 * cfg.param_count() // 1000)

    hier = bool(cell.dims.get("hier_merge", 0))
    delta_rows = int(cell.dims.get("delta_rows", 0))
    if delta_rows:
        delta_rows = round_up(delta_rows, 128)
        meta["delta_rows"] = delta_rows
        meta["model_flops"] += 2 * delta_rows * m
        meta["analytic_bytes"] += delta_rows * m * (1 if int8 else 4)
    if m == d_full and not int8 and not delta_rows:
        def fn(model, item_index, user_ids):
            u = R.user_embedding(model, user_ids)               # (1, d)
            return _sharded_index_topk(item_index, u, TOPK_SERVE, mesh, hierarchical=hier)

        args = (params_sds, index_sds, sds((1,), torch.int32))
        in_specs = (pspec, P(all_axes, None), P())
    elif delta_rows:
        # live segmented serving: sharded immutable base + one replicated
        # open delta at fixed padded capacity with its OWN scale and a live
        # row count — the query projects once unfolded, folds each
        # segment's scale separately, and the two candidate lists merge
        # with global id offsets (delta ids start at C) via the same
        # merge_segment_topk the serving index uses
        def fn(model, item_index, W_m, scale, delta_seg, delta_scale, delta_n, user_ids):
            u = R.user_embedding(model, user_ids)               # (1, d)
            q = project_queries(u, W_m)                         # unfolded
            fold = q if scale is None else q * scale[None, :]
            base = _sharded_index_topk(item_index, fold, TOPK_SERVE, mesh, hierarchical=hier)
            delta = _delta_topk(delta_seg, delta_scale, q, delta_n, C, TOPK_SERVE)
            return merge_segment_topk([base, delta], TOPK_SERVE)

        args = (params_sds, index_sds, sds((d_full, m)), sds((m,)),
                sds((delta_rows, m), store), sds((m,)), sds((), torch.int32),
                sds((1,), torch.int32))
        in_specs = (pspec, P(all_axes, None), P(), P(), P(None, None), P(), P(), P())
    else:
        # PCA-pruned (optionally int8) index: q̂ = (q @ W_m) ⊙ scale
        def fn(model, item_index, W_m, scale, user_ids):
            u = R.user_embedding(model, user_ids)               # (1, d)
            q = project_queries(u, W_m, scale=scale)            # O(dm) transform
            return _sharded_index_topk(item_index, q, TOPK_SERVE, mesh, hierarchical=hier)

        args = (params_sds, index_sds, sds((d_full, m)), sds((m,)), sds((1,), torch.int32))
        in_specs = (pspec, P(all_axes, None), P(), P(), P())

    return StepBundle(
        name=name, fn=fn, mesh=mesh,
        args=args, in_specs=in_specs,
        out_specs=(P(), P()),
        meta=meta, model=model)


# ---------------------------------------------------------------------------
# BiEncoder family (the paper's own model — examples/launcher, not a cell)
# ---------------------------------------------------------------------------


def biencoder_bundle(spec_: ArchSpec, cell: ShapeCell, mesh: DeviceMesh) -> StepBundle:
    cfg: BE.BiEncoderConfig = spec_.cfg
    rules = SH.biencoder_rules()
    dp = _dp(mesh)
    S, B = cell.dims["seq_len"], cell.dims["global_batch"]
    model = BE.init_biencoder(cfg, generator=None, device="meta")
    named = dict(model.named_parameters())
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
        return _train_bundle(name, mesh, model, pspec, batch_sds, bspec,
                             BE.contrastive_loss, spec_.optimizer, meta)

    meta["model_flops"] = 2 * n_params * B * S
    return StepBundle(
        name=name, fn=BE.encode, mesh=mesh,
        args=(reference_shapes(named), sds((B, S), torch.int32), sds((B, S), torch.int32)),
        in_specs=(pspec, P(dp, None), P(dp, None)),
        out_specs=P(dp, None), meta=meta, model=model)


# ---------------------------------------------------------------------------
# Sharded top-k helpers (retrieval serving across the whole mesh)
# ---------------------------------------------------------------------------


def _sharded_index_topk(index: torch.Tensor, q: torch.Tensor, k: int, mesh: DeviceMesh,
                        hierarchical: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of q @ indexᵀ with the index rows laid over every slot of
    ``mesh`` (``ShardedDenseIndex.from_rows``: a row view a slot on the
    rows' device): one ``topk_score`` per slot (the kernel on the card,
    ``_scan_topk`` on the CPU) with ids offset to global rows, then the
    staged merge, flat or hierarchical (the minor axis — ``model`` on the
    bundles' meshes — first, then the rest). ``q`` is the folded query."""
    sharded = ShardedDenseIndex.from_rows(index, mesh)
    return sharded._topk(torch.atleast_2d(q).float(), k,
                         "hierarchical" if hierarchical else "flat")


def _sharded_topk_1d(scores: torch.Tensor, k: int, mesh: DeviceMesh
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a 1-D score vector laid over every slot of ``mesh``: each
    slot's top-min(k, rows) (first-occurrence ties), ids offset to global
    positions, then one merge of the slots' lists in slot order."""
    n = scores.shape[0]
    rows_per = n // mesh.size
    kk = min(k, rows_per)
    ss, ii = [], []
    for i in range(mesh.size):
        local = scores[i * rows_per:(i + 1) * rows_per]
        ids = torch.arange(i * rows_per, (i + 1) * rows_per, dtype=torch.int32,
                           device=scores.device)
        s, si = _topk_merge(local[None], ids[None], kk)
        ss.append(s)
        ii.append(si)
    s, si = _topk_merge(torch.cat(ss, 1), torch.cat(ii, 1), k)
    return s[0], si[0]


BUNDLE_BUILDERS = {
    "lm": lm_bundle,
    "gnn": gnn_bundle,
    "recsys": recsys_bundle,
    "biencoder": biencoder_bundle,
}
