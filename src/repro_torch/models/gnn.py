"""Encoder-processor-decoder message-passing GNN, GraphCast-style (port of
``repro/models/gnn.py``).

Messages are gathered per edge (rows of the node table by ``src`` and
``dst``), transformed by an edge MLP, and aggregated by ``dst`` with the
config's aggregator (``sum``, ``mean`` or ``max``); the node MLP then
updates each node from its state and its aggregate. Graph batches of small
graphs (the molecule shape) are one block-diagonal graph with offset edge
ids; sampled minibatches are the padded subgraphs of
``repro_torch.data.graph``'s CSR fanout sampler.

Determinism. A scatter-add on the card (``index_add_``, ``scatter_add_``,
the backward of ``index_select`` or of advanced indexing) sums with float
atomics, in an order that changes from run to run, so a resumed run would
not replay bitwise. Here every sum over edges goes through one plan a
batch (``edge_plan``): a stable sort of the edge ids by ``dst`` and by
``src`` and the offsets (N + 1) of each node's run in them, from
``torch.searchsorted``. ``segment_sum`` / ``segment_max`` gather the
messages into ``dst`` order and reduce each run with
``torch.segment_reduce`` (one thread a (segment, feature), summing the run
in order); ``gather_rows``'s backward is the same segment sum by ``src``.
All shapes are static (no ``bincount``, no ``unique``), so the step also
runs on meta tensors (the dry run counts it there). On the CPU each run is
summed in edge order, as the reference's scatter-add does, so bf16 sums are
bitwise the reference's.

``max``: an empty segment is -inf and clamps to 0, as the reference's
``segment_max`` and its ``where``; the gradient is split evenly over tied
maxima, as JAX's is. ``mean`` is the sum over a segment sum of ones in the
compute dtype (in bf16 such a count stops at 256, as the reference's does).

With ``cfg.remat`` and gradients enabled each processor layer is recomputed
in the backward (``torch.utils.checkpoint``: the reference's
``jax.checkpoint`` of its scan body). No Pallas kernel of the reference is
on this path; the products are ``torch.matmul`` (cuBLAS on the card).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import torch_dtype
from repro_torch.util import as_tensor, default_device


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    n_layers: int = 16
    d_hidden: int = 512
    d_in: int = 227            # node input features (n_vars for graphcast)
    d_edge_in: int = 4         # edge input features (e.g. displacement+len)
    d_out: int = 227
    aggregator: str = "sum"
    mesh_refinement: int = 6   # recorded for provenance (graphcast config)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True

    def param_count(self) -> int:
        """The reference's count: weights only (no biases, no norms)."""
        h = self.d_hidden
        enc = self.d_in * h + h * h + self.d_edge_in * h + h * h
        proc = self.n_layers * ((3 * h) * h + h * h   # edge MLP [src,dst,e]->h
                                + (2 * h) * h + h * h)  # node MLP [h,agg]->h
        dec = h * h + h * self.d_out
        return enc + proc + dec


def _stack_module(v) -> nn.Module:
    """An MLP stack (a list of dense dicts) as a ``ModuleList``; modules
    pass through."""
    return v if isinstance(v, nn.Module) else nn.ModuleList([L.as_module(p) for p in v])


class GNN(nn.Module):
    """The GNN's parameters under the reference's tree: ``node_encoder``,
    ``edge_encoder`` and ``decoder`` MLP stacks, and ``layers`` (one
    ``edge_mlp`` / ``node_mlp`` / ``edge_norm`` / ``node_norm`` entry per
    layer, unstacked). ``params`` holds tensors, lists, mappings or
    modules; modules and ``nn.Parameter``s are shared, not copied."""

    def __init__(self, cfg: GNNConfig, params: Mapping):
        super().__init__()
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers given for a "
                             f"{cfg.n_layers}-layer config")
        self.cfg = cfg
        self.node_encoder = _stack_module(params["node_encoder"])
        self.edge_encoder = _stack_module(params["edge_encoder"])
        self.layers = nn.ModuleList([
            lp if isinstance(lp, nn.Module) else nn.ModuleDict({
                "edge_mlp": _stack_module(lp["edge_mlp"]),
                "node_mlp": _stack_module(lp["node_mlp"]),
                "edge_norm": L.as_module(lp["edge_norm"]),
                "node_norm": L.as_module(lp["node_norm"])})
            for lp in params["layers"]])
        self.decoder = _stack_module(params["decoder"])

    @property
    def device(self) -> torch.device:
        return self.decoder[0]["w"].device

    @property
    def unreached_params(self) -> tuple[str, ...]:
        """The parameters the loss does not reach: the last layer's edge
        norm, whose output no later layer reads. ``steps.value_and_grad``
        gives them zero gradients, as JAX does."""
        i = len(self.layers) - 1
        return tuple(f"layers.{i}.edge_norm.{n}"
                     for n, _ in self.layers[i]["edge_norm"].named_parameters())

    def forward(self, nodes, edges, edge_index, edge_mask=None) -> torch.Tensor:
        return forward(self, nodes, edges, edge_index, edge_mask)


def init_gnn(cfg: GNNConfig, *, generator: torch.Generator | None, device=None) -> GNN:
    """The reference's init distributions: N(0, 1) / sqrt(d_in) for every
    dense weight, zero biases, ones / zeros for the layer norms. Draws come
    from ``generator`` on its device in a fixed order (node encoder, edge
    encoder, each layer's edge then node MLP, decoder), so a seed gives the
    same weights on the CPU and the card; the model then goes to ``device``
    (default: the card). Without a generator, shapes only: ``device`` must
    be ``"meta"``."""
    dev = default_device(device)
    h = cfg.d_hidden
    pdt = torch_dtype(cfg.param_dtype)
    g, gd = generator, L.gen_device(generator)
    node_encoder = L.init_mlp_stack(g, (cfg.d_in, h, h), dtype=pdt)
    edge_encoder = L.init_mlp_stack(g, (cfg.d_edge_in, h, h), dtype=pdt)
    layers = [{"edge_mlp": L.init_mlp_stack(g, (3 * h, h, h), dtype=pdt),
               "node_mlp": L.init_mlp_stack(g, (2 * h, h, h), dtype=pdt),
               "edge_norm": L.init_layernorm(h, pdt, gd),
               "node_norm": L.init_layernorm(h, pdt, gd)}
              for _ in range(cfg.n_layers)]
    decoder = L.init_mlp_stack(g, (h, h, cfg.d_out), dtype=pdt)
    return GNN(cfg, dict(node_encoder=node_encoder, edge_encoder=edge_encoder,
                         layers=layers, decoder=decoder)).to(dev)


# ---------------------------------------------------------------------------
# deterministic gathers and segment reductions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """One batch's edges grouped by endpoint: ``src`` / ``dst`` (E,) int64,
    and for each side the stable order that sorts the edges by it and the
    (N + 1,) offsets of each node's run in that order."""

    src: torch.Tensor
    dst: torch.Tensor
    src_order: torch.Tensor
    src_offsets: torch.Tensor
    dst_order: torch.Tensor
    dst_offsets: torch.Tensor
    n_nodes: int


def edge_plan(edge_index: torch.Tensor, n_nodes: int) -> EdgePlan:
    """The plan of ``edge_index`` (2, E) [src; dst] over ``n_nodes`` nodes:
    two stable sorts and two ``searchsorted``s, all of static shape."""
    bounds = torch.arange(n_nodes + 1, device=edge_index.device)

    def side(idx):
        order = torch.argsort(idx, stable=True)
        return order, torch.searchsorted(idx[order], bounds)

    src, dst = edge_index[0].long(), edge_index[1].long()
    so, soff = side(src)
    do, doff = side(dst)
    return EdgePlan(src, dst, so, soff, do, doff, n_nodes)


def _run_sum(v: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` (E, ...) summed over each run of ``order``: (N, ...),
    each run in edge order, an empty run 0."""
    return torch.segment_reduce(v.index_select(0, order), "sum", offsets=offsets,
                                axis=0, unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, plan):
        ctx.plan = plan
        return _run_sum(m, plan.dst_order, plan.dst_offsets)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.plan.dst), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, by_src):
        ctx.plan, ctx.by_src = plan, by_src
        return x.index_select(0, plan.src if by_src else plan.dst)

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        if ctx.by_src:
            return _run_sum(g, p.src_order, p.src_offsets), None, None
        return _run_sum(g, p.dst_order, p.dst_offsets), None, None


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, plan):
        agg = torch.segment_reduce(m.index_select(0, plan.dst_order), "max",
                                   offsets=plan.dst_offsets, axis=0, unsafe=True)
        ctx.plan = plan
        ctx.save_for_backward(m, agg)
        return agg

    @staticmethod
    def backward(ctx, g):
        m, agg = ctx.saved_tensors
        p = ctx.plan
        hit = (m == agg.index_select(0, p.dst)).to(g.dtype)
        ties = _run_sum(hit, p.dst_order, p.dst_offsets)
        share = g / torch.clamp_min(ties, 1)
        return hit * share.index_select(0, p.dst), None


def segment_sum(m: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """(E, ...) -> (N, ...): the rows of ``m`` summed by ``plan.dst``; the
    backward gathers by ``dst``. No float atomics either way."""
    return _SegmentSum.apply(m, plan)


def segment_max(m: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """(E, ...) -> (N, ...): the rows' maximum by ``plan.dst``, -inf on an
    empty segment; the gradient split evenly over tied maxima."""
    return _SegmentMax.apply(m, plan)


def gather_rows(x: torch.Tensor, plan: EdgePlan, by_src: bool) -> torch.Tensor:
    """(N, ...) -> (E, ...): ``x``'s rows at ``plan.src`` (or ``dst``); the
    backward is the deterministic segment sum by the same ids."""
    return _GatherRows.apply(x, plan, by_src)


def _aggregate(m: torch.Tensor, plan: EdgePlan, aggregator: str) -> torch.Tensor:
    if aggregator == "sum":
        return segment_sum(m, plan)
    if aggregator == "mean":
        s = segment_sum(m, plan)
        c = _run_sum(torch.ones((m.shape[0], 1), dtype=m.dtype, device=m.device),
                     plan.dst_order, plan.dst_offsets)
        return s / torch.clamp_min(c, 1.0)
    if aggregator == "max":  # isolated nodes get -inf from the max: clamp to 0
        agg = segment_max(m, plan)
        return torch.where(torch.isfinite(agg), agg, torch.zeros((), dtype=agg.dtype,
                                                                  device=agg.device))
    raise ValueError(f"unknown aggregator {aggregator!r}; the port has 'sum', 'mean', 'max'")


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


def _layer(x: torch.Tensor, e: torch.Tensor, lp, plan: EdgePlan, mask, cfg: GNNConfig
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One processor layer (the reference's scan body): (x, e) -> (x', e')."""
    cdt = torch_dtype(cfg.compute_dtype)
    msg_in = torch.cat([gather_rows(x, plan, True), gather_rows(x, plan, False), e], dim=-1)
    m = L.apply_mlp_stack(lp["edge_mlp"], msg_in, act="silu", compute_dtype=cdt)
    if mask is not None:
        m = m * mask
    e_new = L.apply_layernorm(lp["edge_norm"], e + m)
    agg = _aggregate(m, plan, cfg.aggregator)
    u = L.apply_mlp_stack(lp["node_mlp"], torch.cat([x, agg], dim=-1), act="silu",
                          compute_dtype=cdt)
    return L.apply_layernorm(lp["node_norm"], x + u), e_new


def forward(model: GNN, nodes, edges, edge_index, edge_mask=None) -> torch.Tensor:
    """nodes: (N, d_in); edges: (E, d_edge_in); edge_index: (2, E) [src; dst].

    ``edge_mask`` (E,) zeroes messages from padding edges. Returns per-node
    outputs (N, d_out) in the compute dtype, on the model's device."""
    cfg = model.cfg
    cdt = torch_dtype(cfg.compute_dtype)
    dev = model.device
    nodes, edges = as_tensor(nodes, dev), as_tensor(edges, dev)
    plan = edge_plan(as_tensor(edge_index, dev), nodes.shape[0])
    mask = None if edge_mask is None else as_tensor(edge_mask, dev).to(cdt)[:, None]

    x = L.apply_mlp_stack(model.node_encoder, nodes.to(cdt), act="silu", compute_dtype=cdt)
    e = L.apply_mlp_stack(model.edge_encoder, edges.to(cdt), act="silu", compute_dtype=cdt)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in model.layers:
        if remat:
            x, e = checkpoint(_layer, x, e, lp, plan, mask, cfg, use_reentrant=False)
        else:
            x, e = _layer(x, e, lp, plan, mask, cfg)
    return L.apply_mlp_stack(model.decoder, x, act="silu", compute_dtype=cdt)


def mse_loss(model: GNN, batch: Mapping) -> torch.Tensor:
    """Node-regression loss with an optional per-node weight/validity mask."""
    out = forward(model, batch["nodes"], batch["edges"], batch["edge_index"],
                  edge_mask=batch.get("edge_mask"))
    err = (out - as_tensor(batch["targets"], out.device).to(out.dtype)) ** 2
    w = batch.get("node_mask")
    if w is not None:
        w = as_tensor(w, out.device).to(out.dtype)[:, None]
        return (err * w).sum() / torch.clamp_min(w.sum() * model.cfg.d_out, 1.0)
    return err.mean()
