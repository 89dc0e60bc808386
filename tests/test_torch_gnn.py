"""The GNN family through the port against ``repro``: the graph data
(generators and the fanout sampler, bitwise), the config and registry, the
init's tree and the converters, the forward for each aggregator with and
without an edge mask and under remat, the bf16 path, the gradients, the
loss, one AdamW step against the reference's ``_make_train_step``, the step
bundles on both production meshes, and ``launch.train --arch graphcast``
against the reference's launcher (losses, a bitwise resume, checkpoints
crossing both ways). Each case feeds the same numpy inputs (made from a
seed) to both packages.

Tolerances: f32 forward at rtol = atol = 1e-5; gradients per leaf within
1e-4 of the leaf's largest entry; parameters and moments after one AdamW
step at rtol = atol = 1e-6; launcher losses at rtol = atol = 1e-5. bf16:
the gathers, the segment reductions and the whole forward run eagerly in
JAX (``jax.disable_jit``) are bitwise the port's (eager PyTorch rounds each
operation to bf16 as eager JAX does, and each segment is summed in edge
order on both sides); the compiled reference forward is held by cosine
>= 0.999 per node row, since XLA may keep an intermediate in f32.
"""
import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import graphcast as jgraphcast, registry as jreg
from repro.configs.steps import _gnn_loss, _make_train_step
from repro.data import graph as jgraph
from repro.launch import train as jtrain
from repro.models import gnn as JG, layers as JL
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import graphcast, registry, steps
from repro_torch.data import graph
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import gnn as G, layers as L
from repro_torch.util import flatten_with_paths

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
KEY = jax.random.PRNGKey(0)
AGGS = ("sum", "mean", "max")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _cfg(agg="sum", cdt="float32", remat=False, **kw):
    base = dict(n_layers=2, d_hidden=32, d_in=16, d_edge_in=4, d_out=8)
    base.update(kw)
    return dict(base, aggregator=agg, compute_dtype=cdt, remat=remat)


def _pair(**kw):
    return JG.GNNConfig(**_cfg(**kw)), G.GNNConfig(**_cfg(**kw))


def _graph(seed=0, N=24, E=80, d_in=16, d_edge=4, d_out=8, n_dup=10, live=20):
    """A graph with exact ties and isolated nodes: nodes ``live``.. receive
    no edge, and the first ``n_dup`` edges are repeated (the same ends and
    features), so their messages tie in every segment max."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, live, E).astype(np.int32)
    edges = rng.standard_normal((E, d_edge)).astype(np.float32)
    ei = np.stack([np.concatenate([src, src[:n_dup]]), np.concatenate([dst, dst[:n_dup]])])
    edges = np.concatenate([edges, edges[:n_dup]])
    E2 = ei.shape[1]
    return {"nodes": rng.standard_normal((N, d_in)).astype(np.float32),
            "edges": edges, "edge_index": ei.astype(np.int32),
            "edge_mask": (rng.random(E2) < 0.8).astype(np.float32),
            "targets": rng.standard_normal((N, d_out)).astype(np.float32),
            "node_mask": (rng.random(N) < 0.7).astype(np.float32)}


def _ref_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JG.init_gnn(jax.random.PRNGKey(seed), jcfg))


def _model(jcfg, tcfg, seed=0):
    return convert.gnn_from_numpy(_ref_params(jcfg, seed), tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _cos_rows(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close_trees(got, want, what, **tol):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert got.keys() == want.keys(), what
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=f"{what}/{p}", **tol)


# ---------------------------------------------------------------------------
# graph data
# ---------------------------------------------------------------------------


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("power_law", [True, False])
def test_random_graph_and_csr_bitwise(power_law):
    for seed in (0, 3):
        want = jgraph.random_graph(500, 6, seed=seed, power_law=power_law)
        got = graph.random_graph(500, 6, seed=seed, power_law=power_law)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        jg, tg = (mod.CSRGraph.from_edge_index(want, 500) for mod in (jgraph, graph))
        assert tg.n_nodes == jg.n_nodes
        _same({"indptr": tg.indptr, "indices": tg.indices},
              {"indptr": jg.indptr, "indices": jg.indices})


@pytest.mark.parametrize("batch", [1, 3, 128])
def test_batched_molecules_bitwise(batch):
    _same(graph.batched_molecules(batch, 30, 64, 32, 4, seed=7),
          jgraph.batched_molecules(batch, 30, 64, 32, 4, seed=7))


@pytest.mark.parametrize("fanouts,seeds", [((15, 10), None), ((4, 3, 2), None),
                                           ((5,), np.array([3, 17, 3 + 400, 9]))])
def test_neighbor_sampler_bitwise(fanouts, seeds):
    """The sampler's draws, the searchsorted remap (the reference's dict)
    and the padding, over a power-law graph with nodes of degree 0."""
    ei = jgraph.random_graph(2000, 5, seed=1)
    g_ref = jgraph.CSRGraph.from_edge_index(ei, 2000)
    g_port = graph.CSRGraph.from_edge_index(ei, 2000)
    assert (np.diff(g_ref.indptr) == 0).any()      # degree-0 nodes emit self-loops
    js = jgraph.NeighborSampler(g_ref, fanouts, batch_nodes=len(seeds) if seeds is not None
                                else 64, seed=5)
    ts = graph.NeighborSampler(g_port, fanouts, batch_nodes=js.batch_nodes, seed=5)
    assert (ts.max_nodes, ts.max_edges) == (js.max_nodes, js.max_edges)
    for _ in range(2):
        _same(ts.sample(seeds), js.sample(seeds))


# ---------------------------------------------------------------------------
# config, registry, init, converters
# ---------------------------------------------------------------------------


def test_graphcast_config_and_registry():
    js, ts = jreg.get_arch("graphcast"), registry.get_arch("graphcast")
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert (ts.arch_id, ts.family, ts.source, ts.optimizer, ts.notes) == (
        js.arch_id, js.family, js.source, js.optimizer, js.notes)
    assert [dataclasses.asdict(c) for c in ts.shapes] == [dataclasses.asdict(c)
                                                         for c in js.shapes]
    assert dataclasses.asdict(registry.get_smoke_cfg("graphcast")) == dataclasses.asdict(
        jreg.get_smoke_cfg("graphcast"))
    assert graphcast.N_VARS == jgraphcast.N_VARS
    for cfg in (ts.cfg, graphcast.smoke_cfg(), dataclasses.replace(ts.cfg, d_in=1433),
                G.GNNConfig()):
        assert cfg.param_count() == JG.GNNConfig(**dataclasses.asdict(cfg)).param_count()


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_init_tree_and_distributions(pdt):
    jcfg, tcfg = _pair(param_dtype=pdt, n_layers=3)
    model = G.init_gnn(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = dict(flatten_with_paths(jax.eval_shape(lambda: JG.init_gnn(KEY, jcfg))))
    got = dict(flatten_with_paths(convert.stack_layers(dict(model.named_parameters()))))
    assert got.keys() == want.keys()
    for p, w in want.items():
        assert tuple(got[p].shape) == w.shape, p
        assert str(got[p].dtype).replace("torch.", "") == str(w.dtype), p
    assert not any(p.requires_grad for p in model.parameters())
    w = model.layers[1]["edge_mlp"][0]["w"].float()
    assert abs(float(w.std()) * np.sqrt(3 * 32) - 1) < 0.1
    assert torch.equal(model.layers[2]["node_norm"]["scale"].float(), torch.ones(32))
    assert not model.decoder[1]["b"].float().any()
    meta = G.init_gnn(tcfg, generator=None, device="meta")
    assert meta.device.type == "meta"
    again = G.init_gnn(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_converters_round_trip_bitwise():
    """``layers/edge_mlp/0/w`` is (L, 3h, h): the vmap'd init's stacked
    list; it comes across and back bit for bit, bf16 leaves too."""
    for pdt in ("float32", "bfloat16"):
        jcfg, tcfg = _pair(param_dtype=pdt, n_layers=3)
        ref = jax.tree.map(np.asarray, JG.init_gnn(KEY, jcfg))
        assert ref["layers"]["edge_mlp"][0]["w"].shape == (3, 96, 32)
        model = convert.gnn_from_numpy(ref, tcfg, device="cpu")
        assert len(model.layers) == 3
        back = convert.gnn_to_numpy(model)
        want = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), ref)
        got, want = dict(flatten_with_paths(back)), dict(flatten_with_paths(want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_decay_mask_decays_every_stacked_leaf():
    _, tcfg = _pair()
    model = G.init_gnn(tcfg, generator=None, device="meta")
    mask = convert.decay_mask(dict(model.named_parameters()))
    assert mask["layers.0.edge_norm.scale"] and mask["layers.1.node_mlp.1.b"]
    assert not mask["node_encoder.0.b"] and not mask["decoder.1.b"]
    assert mask["node_encoder.0.w"] and mask["decoder.1.w"]


# ---------------------------------------------------------------------------
# forward, bf16, gradients, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_forward_f32(agg, masked, remat):
    jcfg, tcfg = _pair(agg=agg, remat=remat)
    b = _graph(1)
    mask = b["edge_mask"] if masked else None
    want = JG.forward(jax.tree.map(jnp.asarray, _ref_params(jcfg)), b["nodes"], b["edges"],
                      b["edge_index"], jcfg, edge_mask=mask)
    model = _model(jcfg, tcfg)
    with torch.enable_grad():     # remat applies only with gradients on
        got = G.forward(model, b["nodes"], b["edges"], b["edge_index"], edge_mask=mask)
    assert got.shape == (24, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("agg", AGGS)
def test_bf16_gathers_and_segment_reductions_bitwise(agg):
    """The take by src and dst, and each aggregator's reduction, in bf16 on
    a (E, h) message table: bitwise the reference's jnp.take and
    jax.ops.segment_* (mean's count a bf16 sum of ones)."""
    b = _graph(2, N=300, E=4000, live=250)
    rng = np.random.default_rng(4)
    x32 = rng.standard_normal((300, 64)).astype(np.float32)
    m32 = rng.standard_normal((b["edge_index"].shape[1], 64)).astype(np.float32)
    src, dst = (jnp.asarray(b["edge_index"][i]) for i in (0, 1))
    xj, mj = jnp.asarray(x32, jnp.bfloat16), jnp.asarray(m32, jnp.bfloat16)
    xt, mt = torch.from_numpy(x32).bfloat16(), torch.from_numpy(m32).bfloat16()
    plan = G.edge_plan(torch.from_numpy(b["edge_index"]), 300)
    for by_src, idx in ((True, src), (False, dst)):
        np.testing.assert_array_equal(_bf16_bits(G.gather_rows(xt, plan, by_src)),
                                      _bf16_bits(jnp.take(xj, idx, axis=0)))
    if agg == "sum":
        want = jax.ops.segment_sum(mj, dst, num_segments=300)
    elif agg == "mean":
        s = jax.ops.segment_sum(mj, dst, num_segments=300)
        c = jax.ops.segment_sum(jnp.ones((mj.shape[0], 1), jnp.bfloat16), dst,
                                num_segments=300)
        want = s / jnp.maximum(c, 1.0)
    else:
        want = jax.ops.segment_max(mj, dst, num_segments=300)
        want = jnp.where(jnp.isfinite(want), want, 0.0)
    got = G._aggregate(mt, plan, agg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def _ref_layer(x, e, lp, src, dst, mask, cfg):
    """The reference's processor layer (``repro/models/gnn.py``'s scan body),
    step by step through its own functions, for eager runs on given
    inputs."""
    cdt = jnp.dtype(cfg.compute_dtype)
    msg_in = jnp.concatenate([jnp.take(x, src, axis=0), jnp.take(x, dst, axis=0), e], -1)
    m = JL.apply_mlp_stack(lp["edge_mlp"], msg_in, act="silu", compute_dtype=cdt)
    if mask is not None:
        m = m * mask.astype(cdt)[:, None]
    e_new = JL.apply_layernorm(lp["edge_norm"], e + m)
    n = x.shape[0]
    if cfg.aggregator == "sum":
        agg = jax.ops.segment_sum(m, dst, num_segments=n)
    elif cfg.aggregator == "mean":
        s = jax.ops.segment_sum(m, dst, num_segments=n)
        c = jax.ops.segment_sum(jnp.ones((m.shape[0], 1), cdt), dst, num_segments=n)
        agg = s / jnp.maximum(c, 1.0)
    else:
        agg = jax.ops.segment_max(m, dst, num_segments=n)
        agg = jnp.where(jnp.isfinite(agg), agg, 0.0)
    u = JL.apply_mlp_stack(lp["node_mlp"], jnp.concatenate([x, agg], -1), act="silu",
                           compute_dtype=cdt)
    return JL.apply_layernorm(lp["node_norm"], x + u), e_new


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_bf16_layer_bitwise_and_forward_cosine(agg, masked):
    """f32 parameters, bf16 compute and graphcast's 227 outputs. One
    processor layer (``_layer``) on bf16 node and edge states, against the
    reference's layer run eagerly: x' and e' the same bits on at least 98 %
    of entries, the rest within rtol 2^-6 (two bf16 ULPs) and atol 2^-8.
    The products' f32 sums run in each library's own order, so an edge
    message now and then rounds one ULP apart; the segment sum carries it
    into its node's aggregate and the layer norm across that row (measured:
    at most 1 of 13,440 edge entries and 19 of 2,560 node entries, 0.7 %).
    The gathers and segment reductions alone are bitwise (the test above).
    The whole
    forward at three layers: cosine >= 0.999 per node row against the
    compiled reference, and >= 0.99998 against the eager one (layer norms
    and products reduce in f32 in their own orders, so a rare bf16 rounding
    differs by an ULP and grows through the layers). Measured lowest
    cosines: 0.99986 against compiled, 0.99999 against eager; the compiled
    reference is no closer to its own eager run (at 8 outputs a row, as
    the smoke config has, its max case is at 0.99900 from it)."""
    b = _graph(3, N=40, E=200, live=30, d_out=227)
    mask = b["edge_mask"] if masked else None
    jcfg, tcfg = _pair(agg=agg, cdt="bfloat16", n_layers=3, d_hidden=64, d_out=227)
    params = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    model = _model(jcfg, tcfg)
    rng = np.random.default_rng(9)
    x32 = rng.standard_normal((40, 64)).astype(np.float32)
    e32 = rng.standard_normal((b["edge_index"].shape[1], 64)).astype(np.float32)
    ei = jnp.asarray(b["edge_index"])
    for i in range(3):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        with jax.disable_jit():
            wx, we = _ref_layer(jnp.asarray(x32, jnp.bfloat16), jnp.asarray(e32, jnp.bfloat16),
                                lp, ei[0], ei[1], None if mask is None else jnp.asarray(mask),
                                jcfg)
        plan = G.edge_plan(torch.from_numpy(b["edge_index"]), 40)
        tmask = None if mask is None else torch.from_numpy(mask).bfloat16()[:, None]
        gx, ge = G._layer(torch.from_numpy(x32).bfloat16(), torch.from_numpy(e32).bfloat16(),
                          model.layers[i], plan, tmask, tcfg)
        for got_, want_ in ((gx, wx), (ge, we)):
            assert (_bf16_bits(got_) != _bf16_bits(want_)).mean() <= 0.02
            np.testing.assert_allclose(_np(got_), _np(want_), rtol=2**-6, atol=2**-8)
    with jax.disable_jit():
        eager = JG.forward(params, b["nodes"], b["edges"], b["edge_index"], jcfg,
                           edge_mask=mask)
    compiled = jax.jit(partial(JG.forward, cfg=jcfg))(params, b["nodes"], b["edges"],
                                                      b["edge_index"], edge_mask=mask)
    got = G.forward(model, b["nodes"], b["edges"], b["edge_index"], edge_mask=mask)
    assert got.dtype == torch.bfloat16
    assert _cos_rows(_np(got), _np(compiled)).min() >= 0.999
    assert _cos_rows(_np(got), _np(eager)).min() >= 0.99998


def _grads(jcfg, tcfg, b):
    params = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    jl, jg = jax.value_and_grad(JG.mse_loss)(params, _j(b), jcfg)
    model = _model(jcfg, tcfg)
    model.requires_grad_(True)
    tl, tg = steps.value_and_grad(G.mse_loss, model, b)
    return (float(jl), jax.device_get(jg)), (float(tl), convert._numpy_tree(
        convert.stack_layers(tg)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_gradients_per_leaf(agg, remat):
    """Loss at 1e-5; each leaf's gradient within 1e-4 of its largest entry.
    The graph has tied messages (repeated edges: the max's gradient split
    between them, as JAX splits it) and isolated nodes (the clamped -inf);
    the last layer's edge norm, which the loss does not reach, gets zeros."""
    jcfg, tcfg = _pair(agg=agg, remat=remat)
    (jl, jg), (tl, tg) = _grads(jcfg, tcfg, _graph(5))
    np.testing.assert_allclose(tl, jl, **TOL)
    want, got = dict(flatten_with_paths(jg)), dict(flatten_with_paths(tg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        assert np.abs(got[k] - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), k
    assert not got["layers/edge_norm/scale"][-1].any()


def test_value_and_grad_zero_fills_only_declared_leaves():
    """Only the leaves a model names in ``unreached_params`` get zeros; a
    parameter that any other model's loss does not reach still raises."""
    jcfg, tcfg = _pair()
    model = _model(jcfg, tcfg).requires_grad_(True)
    assert model.unreached_params == ("layers.1.edge_norm.bias", "layers.1.edge_norm.scale")
    _, grads = steps.value_and_grad(G.mse_loss, model, _graph(5))
    assert all(not grads[n].any() for n in model.unreached_params)
    assert all(grads[n].any() for n in grads if n not in model.unreached_params)
    cut = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="not have been used"):
        steps.value_and_grad(lambda m, b: m.weight.sum(), cut, {})


def test_silu_gradient_is_jaxs_and_finite():
    """Below x = -88 exp(-x) is inf; differentiating 1 / (1 + exp(-x)) by
    its formula gives 0 · inf = NaN, JAX's logistic gradient gives 0."""
    x = torch.tensor([-200.0, -90.0, -10.0, -1.0, 0.0, 1.0, 10.0, 90.0], requires_grad=True)
    L.silu(x).sum().backward()
    want = jax.grad(lambda v: jax.nn.silu(v).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_gradients_with_a_hub_node(agg):
    """A node that takes 600 messages (a power-law graph's hub): its
    aggregate drives node-MLP pre-activations far below -88; the gradients
    stay finite and within 1e-4 of JAX's, leaf by leaf."""
    jcfg, tcfg = _pair(agg=agg, d_hidden=64)
    b = _graph(11, N=40, E=700, live=30)
    b["edge_index"][1, :600] = 0
    b["nodes"] *= 30.0
    (jl, jg), (tl, tg) = _grads(jcfg, tcfg, b)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for k, w in dict(flatten_with_paths(jg)).items():
        got = dict(flatten_with_paths(tg))[k]
        assert np.isfinite(got).all(), k
        w = np.asarray(w, np.float32)
        assert np.abs(got - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-30), k


def test_max_gradient_splits_ties_evenly():
    """Two equal messages into one node share its gradient half and half;
    an isolated node passes none."""
    m = torch.tensor([[1.0, 5.0], [3.0, 5.0], [3.0, 2.0], [0.5, 0.5]], requires_grad=True)
    plan = G.edge_plan(torch.tensor([[0, 1, 2, 3], [0, 0, 0, 2]]), 3)
    out = G._aggregate(m, plan, "max")
    out.sum().backward()
    dst = jnp.array([0, 0, 0, 2])
    jf = lambda v: jnp.where(jnp.isfinite(s := jax.ops.segment_max(v, dst, num_segments=3)),
                             s, 0.0).sum()
    np.testing.assert_array_equal(m.grad.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(
        m.detach().numpy()))))
    assert m.grad[:3].tolist() == [[0.0, 0.5], [0.5, 0.5], [0.5, 0.0]]
    np.testing.assert_array_equal(out.detach().numpy()[1], [0.0, 0.0])


@pytest.mark.parametrize("with_mask", [False, True])
def test_mse_loss(with_mask):
    jcfg, tcfg = _pair(agg="mean")
    b = _graph(6)
    if not with_mask:
        b.pop("node_mask")
    want = JG.mse_loss(jax.tree.map(jnp.asarray, _ref_params(jcfg)), _j(b), jcfg)
    got = G.mse_loss(_model(jcfg, tcfg), b)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    b["node_mask"] = np.zeros(24, np.float32)        # an all-zero mask: 0 / max(0, 1)
    assert float(G.mse_loss(_model(jcfg, tcfg), b)) == 0.0


@pytest.mark.parametrize("agg", AGGS)
def test_adamw_step_matches_make_train_step(agg):
    """One AdamW step (lr 1e-4, the reference's decay mask: every stacked
    leaf decays) against the reference's jitted ``_make_train_step``."""
    jcfg, tcfg = _pair(agg=agg, remat=True)
    b = _graph(8)
    jstep, jinit = _make_train_step(partial(_gnn_loss, cfg=jcfg), "adamw")
    jp = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    jp2, jo2, jm = jax.jit(jstep)(jp, jinit(jp), _j(b))
    model = _model(jcfg, tcfg)
    model.requires_grad_(True)
    step, init = steps.make_train_step(G.mse_loss, "adamw")
    opt = init(model)
    met = step(model, opt, b)
    np.testing.assert_allclose(float(met["loss"]), float(jm["loss"]), **TOL)
    _close_trees(convert.gnn_to_numpy(model), jax.device_get(jp2), "params", **STEP_TOL)
    _close_trees(convert.adamw_state_to_numpy(opt), jax.device_get(jo2), "opt", **STEP_TOL)


# ---------------------------------------------------------------------------
# step bundles on the production meshes
# ---------------------------------------------------------------------------

_REF_BUNDLES = r"""
import json, sys
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ShapeCell
from repro.configs.steps import gnn_bundle
from repro.launch.mesh import make_production_mesh
import dataclasses

def specs(tree):
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return [[list(p) if isinstance(p, tuple) else p for p in s] for s in leaves]

out = {}
spec = registry.get_arch("graphcast")
smoke = dataclasses.replace(spec, cfg=registry.get_smoke_cfg("graphcast"),
                            shapes=(ShapeCell("smoke", "train", dict(
                                n_nodes=120, n_edges=480, batch=4, d_feat=16)),))
for mesh_name in ("pod", "multipod"):
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    for sp, cell in [(spec, c) for c in spec.shapes] + [(smoke, smoke.shapes[0])]:
        b = gnn_bundle(sp, cell, mesh)
        out[f"{cell.name}/{mesh_name}"] = dict(
            name=b.name, donate=list(b.donate), meta=b.meta,
            args=[[list(a.shape), str(a.dtype)] for a in jax.tree.leaves(b.args)],
            in_specs=specs(b.in_specs), out_specs=specs(b.out_specs))
print(json.dumps(out))
"""


def ref_subprocess(code: str, devices: int = 512) -> dict:
    """Run ``code`` (printing one JSON line last) under the reference with
    ``devices`` forced host devices, as its dry run runs."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_bundles():
    return ref_subprocess(_REF_BUNDLES)


def _port_specs(tree):
    return [s.to_json() for _, s in convert._leaves(_jax_order([tree]))]


def _jax_order(tree):
    if isinstance(tree, (tuple, list)):
        return [_jax_order(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    return tree


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_gnn_bundles_match_the_reference(ref_bundles, mesh_name):
    """Every graphcast cell and the launcher's smoke cell on the (16, 16)
    and (2, 16, 16) production meshes: name, donation, meta (model FLOPs,
    analytic bytes, N, E_pad rounded to 512 past 10^6 edges), argument
    shapes and dtypes, and the spec trees (edges over every axis on the big
    graphs, ZeRO-1 moments)."""
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    spec = registry.get_arch("graphcast")
    smoke = train_cli._smoke_spec("graphcast")
    for sp, cell in [(spec, c) for c in spec.shapes] + [(smoke, smoke.shapes[0])]:
        want = ref_bundles[f"{cell.name}/{mesh_name}"]
        b = steps.gnn_bundle(sp, cell, mesh)
        assert b.name == want["name"] and list(b.donate) == want["donate"]
        assert json.loads(json.dumps(b.meta)) == want["meta"], cell.name
        got_args = [[list(a.shape), str(a.dtype).replace("torch.", "")]
                    for _, a in convert._leaves(_jax_order(list(b.args)))]
        assert got_args == want["args"], cell.name
        assert _port_specs(b.in_specs) == want["in_specs"], cell.name
        assert _port_specs(b.out_specs) == want["out_specs"], cell.name
        assert b.model.device.type == "meta" and b.model.cfg.d_in == cell.dims["d_feat"]


# ---------------------------------------------------------------------------
# launch.train --arch graphcast
# ---------------------------------------------------------------------------


def _ref_init_into_port(monkeypatch, seed=0):
    """Make the port's launcher start from the reference's init for ``seed``
    (the two packages draw from different generators)."""
    jcfg = jreg.get_smoke_cfg("graphcast")
    ref = _ref_params(jcfg, seed)
    monkeypatch.setitem(train_cli._INITS, "gnn",
                        lambda cfg, generator, device: convert.gnn_from_numpy(ref, cfg, device))
    return jcfg, ref


def _ref_train(**kw):
    return jtrain.train("graphcast", smoke=True, shape=None, resume="auto", seed=0,
                        log_every=0, **kw)


def test_launch_train_gnn_matches_the_reference_launcher(monkeypatch):
    """Three smoke steps from the same init: the reference launcher's losses
    within 1e-5, and the same bundle meta."""
    _ref_init_into_port(monkeypatch)
    want = _ref_train(steps=3, ckpt_dir=None, ckpt_every=0)
    got = train_cli.train("graphcast", steps=3, smoke=True, ckpt_dir=None, ckpt_every=0,
                          resume="none", seed=0, device="cpu", log_every=0)
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert got["bundle"].meta == jtrain.BUNDLE_BUILDERS["gnn"](
        jtrain._smoke_spec("graphcast"), jtrain._smoke_spec("graphcast").shapes[0],
        jtrain.make_host_mesh()).meta


def test_launch_train_gnn_resumes_bitwise_and_crosses_checkpoints(tmp_path, monkeypatch):
    """6 steps with checkpoints every 3, then a resume for 3: bitwise an
    uninterrupted 9-step run. The port's checkpoint restores in the
    reference's manager, and a checkpoint the reference's launcher wrote
    resumes in the port's."""
    jcfg, ref = _ref_init_into_port(monkeypatch)
    run = dict(smoke=True, ckpt_every=3, seed=0, device="cpu", log_every=0)
    full = train_cli.train("graphcast", steps=9, ckpt_dir=None, resume="none", **run)
    ck = str(tmp_path / "ck")
    train_cli.train("graphcast", steps=6, ckpt_dir=ck, resume="auto", **run)
    out2 = train_cli.train("graphcast", steps=3, ckpt_dir=ck, resume="auto", **run)
    assert out2["losses"] == full["losses"][6:]
    assert all(torch.equal(a, b) for a, b in zip(out2["model"].parameters(),
                                                 full["model"].parameters()))
    assert CheckpointManager(ck).all_steps() == [3, 6, 9]
    jp = jax.tree.map(jnp.asarray, ref)
    jinit, _ = __import__("repro.configs.steps", fromlist=["_opt_pack"])._opt_pack("adamw")
    (rp, ro), step = JaxManager(ck).restore((jp, jinit(jp)))
    assert step == 9 and int(ro["step"]) == 9
    _close_trees(convert.gnn_to_numpy(out2["model"]), jax.device_get(rp), "params",
                 rtol=0, atol=0)
    # the reference's launcher writes, the port resumes
    jck = str(tmp_path / "jck")
    _ref_train(steps=6, ckpt_dir=jck, ckpt_every=3)
    out3 = train_cli.train("graphcast", steps=3, ckpt_dir=jck, resume="auto", **run)
    np.testing.assert_allclose(out3["losses"], full["losses"][6:], **TOL)


def test_launch_train_gnn_cli(capsys):
    out = train_cli.main(["--arch", "graphcast", "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seed", "1"])
    assert out["steps_run"] == 2 and out["model"].cfg == registry.get_smoke_cfg("graphcast")
    assert out["bundle"].meta["dims"] == {"n_nodes": 120, "n_edges": 480, "batch": 2,
                                          "d_feat": 16}
    assert capsys.readouterr().out.strip().endswith(
        f"[train] done: 2 steps, final loss {out['final_loss']:.4f}")
    ts, js = train_cli._smoke_spec("graphcast"), jtrain._smoke_spec("graphcast")
    _same(train_cli.make_batch_fn(ts, ts.shapes[0], 0)(1),
          jtrain.make_batch_fn(js, js.shapes[0], 0)(1))
