"""The recsys family's steps, bundles and launcher through the port against
``repro``: the registry, every arch's step bundle (meta, argument shapes,
spec trees), each arch's smoke step against the reference bundle's ``fn``
(the rowwise step for DLRM, DeepFM and AutoInt, the two-tower's AdamW
step), the gradients the rowwise step takes, the two-tower
``retrieval_cand`` variants (full, pruned f32 and int8, int8 with a delta,
the hierarchical merge) and the CTR retrieval cell, the rowwise state's
converters, and ``launch.train`` for recsys (a bitwise resume, a checkpoint
the reference's manager reads, the reference's steps from the same init).

The reference's recsys launcher cannot train on JAX 0.9.0 (its sharding
constraints need Auto axes, and ``make_host_mesh`` builds Explicit ones),
but its bundles run on an Auto-axes (1, 1) mesh with the step jitted
inside ``with mesh:``; the port is held to those.

Tolerances: f32 losses at rtol = atol = 1e-5; gradients per leaf within
1e-4 of the leaf's largest entry; parameters, optimizer states, rowwise
tables and accumulators after a step at rtol = atol = 1e-6; ids exactly.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as JP

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import registry as jreg, steps as jsteps
from repro.configs.base import ShapeCell as JCell
from repro.core.index import project_queries as j_project_queries
from repro.core.pruning import StaticPruner as JPruner
from repro.core.quantization import quantize_int8_per_dim as j_quantize
from repro.data import recsys as jdata
from repro.models import recsys as JR
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry, steps
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import train as train_cli
from repro_torch.models import recsys as R
from repro_torch.par import sharding as SH
from repro_torch.par.mesh import make_mesh
from repro_torch.util import flatten_with_paths

RECSYS = ("two-tower-retrieval", "dlrm-mlperf", "deepfm", "autoint")
CTR = RECSYS[1:]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
SMOKE = dict(batch=32)


def _auto_mesh(shape=(1, 1)):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * len(shape))


def _smoke_specs(arch, cell):
    """(reference spec, port spec) on the smoke config with one cell."""
    js = jreg.get_arch(arch)
    ts = registry.get_arch(arch)
    return (dataclasses.replace(js, cfg=jreg.get_smoke_cfg(arch),
                                shapes=(JCell(cell.name, cell.kind, dict(cell.dims)),)),
            dataclasses.replace(ts, cfg=registry.get_smoke_cfg(arch), shapes=(cell,)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed=0):
    return jax.tree.map(np.asarray, JR.init_recsys(jax.random.PRNGKey(seed),
                                                   jreg.get_smoke_cfg(arch)))


def _batch(cfg, B=32, step=0):
    if cfg.kind == "two_tower":
        return jdata.two_tower_batch(0, step, batch=B, user_vocab=cfg.user_vocab,
                                     item_vocab=cfg.item_vocab)
    return jdata.ctr_batch(0, step, batch=B, vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_trees(got, want, what, **tol):
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert got.keys() == want.keys(), what
    for p in want:
        np.testing.assert_allclose(np.asarray(got[p]), np.asarray(want[p]),
                                   err_msg=f"{what}/{p}", **tol)


def _jax_order(tree):
    """Dicts with their keys sorted and tuples as lists: ``convert._leaves``
    then walks the leaves in JAX's flattening order."""
    if isinstance(tree, (tuple, list)):
        return [_jax_order(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    return tree


# ---------------------------------------------------------------------------
# registry and bundles
# ---------------------------------------------------------------------------


def test_registry_lists_the_recsys_family():
    assert registry.list_archs() == jreg.list_archs()
    for arch in RECSYS:
        assert registry.get_arch(arch).family == "recsys"
        assert dataclasses.asdict(registry.get_smoke_cfg(arch)) == dataclasses.asdict(
            jreg.get_smoke_cfg(arch))
    got = [(s.arch_id, c.name) for s, c in registry.cells() if s.family == "recsys"]
    want = [(s.arch_id, c.name) for s, c in jreg.cells() if s.family == "recsys"]
    assert got == want and len(got) == 16
    assert registry.get_arch("graphcast").family == jreg.get_arch("graphcast").family == "gnn"


BUNDLE_CELLS = [(a, c) for a in RECSYS
                for c in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")]
VARIANTS = {"pruned_int8": dict(index_dim=128, int8=1),
            "pruned_f32_hier": dict(index_dim=128, hier_merge=1),
            "int8_delta": dict(index_dim=128, int8=1, delta_rows=4000)}


def _specs(tree, is_j):
    if is_j:
        leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))
        return [json.dumps(SH.PartitionSpec(*s).to_json()) for s in leaves]
    return [json.dumps(s.to_json()) for _, s in convert._leaves(_jax_order([tree]))]


def _check_bundle(jb, tb, tm):
    assert tb.name == jb.name and tb.donate == jb.donate and tb.meta == jb.meta
    assert tb.mesh is tm
    want = [(tuple(v.shape), str(v.dtype)) for v in jax.tree.leaves(jb.args)]
    got = [(tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for _, v in convert._leaves(_jax_order(list(tb.args)))]
    assert got == want
    assert _specs(tb.in_specs, False) == _specs(jb.in_specs, True)
    assert _specs(tb.out_specs, False) == _specs(jb.out_specs, True)


@pytest.mark.parametrize("arch,cell", BUNDLE_CELLS, ids=[f"{a}:{c}" for a, c in BUNDLE_CELLS])
def test_recsys_bundle_matches_the_reference(arch, cell):
    """``make_step_bundle`` on a (2, 2) mesh at full width: the reference's
    meta (model FLOPs, analytic bytes, optimizer), argument shapes and spec
    trees, the rowwise state's included."""
    jm = jax.make_mesh((2, 2), ("data", "model"))
    tm = make_mesh((2, 2), ("data", "model"), "meta")
    _check_bundle(jreg.make_step_bundle(arch, cell, jm),
                  registry.make_step_bundle(arch, cell, tm), tm)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_retrieval_cand_variant_bundles_match_the_reference(variant):
    jm = jax.make_mesh((2, 2), ("data", "model"))
    tm = make_mesh((2, 2), ("data", "model"), "meta")
    js, ts = jreg.get_arch("two-tower-retrieval"), registry.get_arch("two-tower-retrieval")
    dims = {**js.cell("retrieval_cand").dims, **VARIANTS[variant]}
    jb = jsteps.recsys_bundle(js, JCell("retrieval_cand", "retrieval", dims), jm)
    tb = steps.recsys_bundle(ts, ShapeCell("retrieval_cand", "retrieval", dims), tm)
    _check_bundle(jb, tb, tm)


# ---------------------------------------------------------------------------
# the smoke steps against the reference bundles
# ---------------------------------------------------------------------------


def _ref_step(arch, p, opt, batch, optimizer=None):
    js, _ = _smoke_specs(arch, ShapeCell("smoke", "train", SMOKE))
    js = dataclasses.replace(js, optimizer=optimizer or js.optimizer)
    jm = _auto_mesh()
    jb = jsteps.recsys_bundle(js, js.shapes[0], jm)
    with jm:
        return jax.jit(jb.fn)(p, opt, _j(batch))


def _port_setup(arch, seed=0, optimizer=None):
    _, ts = _smoke_specs(arch, ShapeCell("smoke", "train", SMOKE))
    ts = dataclasses.replace(ts, optimizer=optimizer or ts.optimizer)
    model = convert.recsys_from_numpy(_ref_params(arch, seed), ts.cfg, device="cpu")
    model.requires_grad_(True)
    opt_init, _ = steps._opt_pack(ts.optimizer)
    tb = steps.recsys_bundle(ts, ts.shapes[0], make_mesh((1, 1), ("data", "model"), "cpu"))
    return ts, model, opt_init(model), tb


def _port_opt_tree(opt):
    return (convert.rowwise_state_to_numpy(opt) if "acc" in opt
            else convert.adamw_state_to_numpy(opt))


STEP_CASES = [(a, None) for a in RECSYS] + [("dlrm-mlperf", "adamw")]


@pytest.mark.parametrize("arch,optimizer", STEP_CASES,
                         ids=[a + (f"-{o}" if o else "") for a, o in STEP_CASES])
def test_smoke_step_matches_the_reference_bundle(arch, optimizer):
    """Two steps from the same weights and batches: the loss at 1e-5, every
    parameter (rowwise tables included) and every optimizer-state leaf
    (AdamW moments and step, rowwise accumulators) at 1e-6; DLRM also
    under AdamW (the bundle's dense train step with the BCE loss)."""
    ts, model, opt, tb = _port_setup(arch, optimizer=optimizer)
    jp = jax.tree.map(jnp.asarray, _ref_params(arch))
    init, _ = jsteps._opt_pack(ts.optimizer)
    jo = init(jp)
    for t in range(2):
        b = _batch(ts.cfg, step=t)
        jp, jo, jmet = _ref_step(arch, jp, jo, b, optimizer)
        met = tb.fn(model, opt, {k: torch.as_tensor(v) for k, v in b.items()}, t)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), **TOL)
    _close_trees(convert.recsys_to_numpy(model), jax.device_get(jp), "params", **STEP_TOL)
    _close_trees(_port_opt_tree(opt), jax.device_get(jo), "opt", **STEP_TOL)
    if ts.optimizer == "rowwise":
        assert tb.meta["optimizer"] == "rowwise-adagrad"
        touched = np.unique(_batch(ts.cfg, step=0)["sparse"][:, 0])
        acc0 = opt["acc"][0].numpy()
        assert np.all(acc0[touched] > 0)
        assert np.count_nonzero(acc0) <= len(np.unique(np.concatenate(
            [_batch(ts.cfg, step=t)["sparse"][:, 0] for t in range(2)])))


@pytest.mark.parametrize("arch", CTR)
def test_rowwise_gradients_match_the_reference(arch):
    """The rowwise step's loss as a function of the gathered rows and the
    other parameters: each gradient leaf within 1e-4 of its largest entry."""
    jc = jreg.get_smoke_cfg(arch)
    p = _ref_params(arch)
    b = _batch(jc)
    jp = jax.tree.map(jnp.asarray, p)
    rest = {k: v for k, v in jp.items() if k != "tables"}
    rows = [jnp.take(t, jnp.asarray(b["sparse"][:, f]), axis=0)
            for f, t in enumerate(jp["tables"])]

    def jloss(rest_, rows_):
        emb = jnp.stack(rows_, axis=1)
        logit = JR.forward_ctr_from_emb(rest_, emb, _j(b), jc)
        y = jnp.asarray(b["label"])
        return jnp.mean(jnp.maximum(logit, 0) - logit * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    jl, (jg_rest, jg_rows) = jax.value_and_grad(jloss, argnums=(0, 1))(rest, rows)
    model = convert.recsys_from_numpy(p, registry.get_smoke_cfg(arch), device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    trows = [t[tb["sparse"][:, f].long()].requires_grad_(True)
             for f, t in enumerate(model.tables)]
    named = {n: q.requires_grad_(True) for n, q in model.named_parameters()
             if not n.startswith("tables.")}
    loss = R.bce_from_logit(R.forward_ctr_from_emb(model, torch.stack(trows, 1), tb),
                            tb["label"])
    grads = torch.autograd.grad(loss, [*named.values(), *trows])
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jg_rest))
    for n, g in zip(named, grads):
        w = want[n]
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * max(np.abs(w).max(), 1e-30), n
    for g, w in zip(grads[len(named):], jg_rows):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * np.abs(w).max()


def test_rowwise_state_converters_round_trip():
    arch = "deepfm"
    ts, model, opt, tb = _port_setup(arch)
    tb.fn(model, opt, _batch(ts.cfg))
    tree = convert.rowwise_state_to_numpy(opt)
    assert set(tree) == {"adamw", "acc"} and isinstance(tree["acc"], list)
    back = convert.rowwise_state_from_numpy(tree, device="cpu")
    assert back["adamw"]["decay"] == opt["adamw"]["decay"]
    assert all(torch.equal(a, b) for a, b in zip(back["acc"], opt["acc"]))
    for k in ("mu", "nu"):
        assert all(torch.equal(back["adamw"][k][n], v) for n, v in opt["adamw"][k].items())
    assert int(back["adamw"]["step"]) == 1
    # the reference's rowwise init has this tree
    jo = jsteps.rowwise_opt_init(jax.tree.map(jnp.asarray, _ref_params(arch)))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jo)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tree))


# ---------------------------------------------------------------------------
# retrieval cells
# ---------------------------------------------------------------------------


RETRIEVAL = {"full": {}, "pruned_f32": dict(index_dim=16),
             "pruned_int8": dict(index_dim=16, int8=1),
             "int8_delta": dict(index_dim=16, int8=1, delta_rows=100),
             "full_hier": dict(hier_merge=1),
             "pruned_int8_hier": dict(index_dim=16, int8=1, hier_merge=1)}


@functools.lru_cache(maxsize=None)
def _retrieval_inputs():
    """The smoke two-tower's item index over C = 1,024 items, its pruner
    (m = 16 of 32) and int8 form, and a 100-row delta of new items at
    capacity 128 under its own scale, all from the reference."""
    jc = jreg.get_smoke_cfg("two-tower-retrieval")
    jp = jax.tree.map(jnp.asarray, _ref_params("two-tower-retrieval"))
    C = 1024
    full = JR.item_embedding(jp, jnp.arange(C, dtype=jnp.int32))
    pruner = JPruner(m=16).fit(full)
    W, _ = pruner.projection()
    pruned = pruner.prune_index(full)
    q8, scale = j_quantize(pruned)
    new = JR.item_embedding(jp, jnp.arange(100, dtype=jnp.int32) + 7)
    d8, dscale = j_quantize(j_project_queries(new, W))
    delta = jnp.zeros((128, 16), jnp.int8).at[:100].set(d8)
    return {k: np.asarray(v) for k, v in dict(full=full, W=W, pruned=pruned, q8=q8,
                                              scale=scale, delta=delta,
                                              dscale=dscale).items()}


@pytest.mark.parametrize("variant", list(RETRIEVAL))
def test_retrieval_cand_matches_the_reference(variant):
    """``retrieval_cand`` at smoke width: the reference bundle's fn on an
    Auto-axes mesh ((2, 2) under the hierarchical merge, (1, 1) else) and
    the port's on the same shape of CPU slots: ids equal, scores at 1e-5."""
    arch = "two-tower-retrieval"
    dims = dict(batch=1, n_candidates=1000, **RETRIEVAL[variant])
    shape = (2, 2) if dims.get("hier_merge") else (1, 1)
    js, ts = _smoke_specs(arch, ShapeCell("retrieval_cand", "retrieval", dims))
    jm = _auto_mesh(shape)
    tm = make_mesh(shape, ("data", "model"), "cpu")
    jb = jsteps.recsys_bundle(js, js.shapes[0], jm)
    tb = steps.recsys_bundle(ts, ts.shapes[0], tm)
    x = _retrieval_inputs()
    if "index_dim" not in dims:
        args = (x["full"],)
    elif dims.get("delta_rows"):
        args = (x["q8"], x["W"], x["scale"], x["delta"], x["dscale"], np.int32(100))
    elif dims.get("int8"):
        args = (x["q8"], x["W"], x["scale"])
    else:
        args = (x["pruned"], x["W"], np.ones(16, np.float32))
    users = np.array([5], np.int32)
    with jm:
        ws, wi = jax.jit(jb.fn)(jax.tree.map(jnp.asarray, _ref_params(arch)),
                                *map(jnp.asarray, args), jnp.asarray(users))
    model = convert.recsys_from_numpy(_ref_params(arch), ts.cfg, device="cpu")
    targs = [torch.as_tensor(a) for a in args]
    if dims.get("delta_rows"):
        targs[-1] = 100
    with torch.no_grad():
        gs, gi = tb.fn(model, *targs, torch.as_tensor(users))
    assert gi.shape == (1, steps.TOPK_SERVE)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    if dims.get("delta_rows"):
        assert (gi.numpy() >= 1024).any()       # delta rows compete with the base


@pytest.mark.parametrize("arch", CTR)
def test_ctr_retrieval_cell_matches_the_reference(arch):
    """The CTR retrieval cell at 2,048 candidates over the slots of a (2, 2)
    mesh: ids equal (first-occurrence ties), scores at 1e-5."""
    dims = dict(batch=1, n_candidates=2048)
    js, ts = _smoke_specs(arch, ShapeCell("retrieval_cand", "retrieval", dims))
    jm = _auto_mesh((2, 2))
    jb = jsteps.recsys_bundle(js, js.shapes[0], jm)
    tb = steps.recsys_bundle(ts, ts.shapes[0], make_mesh((2, 2), ("data", "model"), "cpu"))
    cfg = ts.cfg
    f_user, _ = R.ctr_user_item_split(cfg)
    b = _batch(cfg, B=1)
    user = {"sparse": b["sparse"][:, :f_user]}
    if cfg.n_dense:
        user["dense"] = b["dense"]
    cand = _batch(cfg, B=2048, step=1)["sparse"][:, f_user:]
    with jm:
        ws, wi = jax.jit(jb.fn)(jax.tree.map(jnp.asarray, _ref_params(arch)), _j(user),
                                jnp.asarray(cand))
    model = convert.recsys_from_numpy(_ref_params(arch), cfg, device="cpu")
    with torch.no_grad():
        gs, gi = tb.fn(model, {k: torch.as_tensor(v) for k, v in user.items()},
                       torch.as_tensor(cand))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


@pytest.mark.parametrize("arch", RECSYS)
def test_serve_cells_match_the_reference(arch):
    cell = ShapeCell("serve_p99", "serve", dict(batch=64))
    js, ts = _smoke_specs(arch, cell)
    jm = _auto_mesh()
    jb = jsteps.recsys_bundle(js, js.shapes[0], jm)
    tb = steps.recsys_bundle(ts, ts.shapes[0], make_mesh((1, 1), ("data", "model"), "cpu"))
    b = _batch(ts.cfg, B=64)
    if arch == "two-tower-retrieval":
        b = {k: v for k, v in b.items() if k != "item_logq"}
    with jm:
        want = jax.jit(jb.fn)(jax.tree.map(jnp.asarray, _ref_params(arch)), _j(b))
    model = convert.recsys_from_numpy(_ref_params(arch), ts.cfg, device="cpu")
    with torch.no_grad():
        got = tb.fn(model, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# launch.train for recsys
# ---------------------------------------------------------------------------


def _train(tmp_path, arch, steps_, resume, ckpt="ck"):
    return train_cli.train(arch, steps=steps_, smoke=True, ckpt_dir=str(tmp_path / ckpt),
                           ckpt_every=3, resume=resume, seed=0, device="cpu", log_every=0)


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "dlrm-mlperf"])
def test_launch_train_recsys_resumes_bitwise(tmp_path, arch, capsys):
    """6 steps with checkpoints every 3, then ``--resume auto`` for 3: the
    resumed losses, parameters and optimizer state are bitwise an
    uninterrupted 9-step run's; the manifest's specs are the bundle's on the
    run's mesh; the reference's manager restores the checkpoint into its
    own init's structure with the same values."""
    out1 = _train(tmp_path, arch, 6, "none")
    assert out1["steps_run"] == 6 and all(np.isfinite(out1["losses"]))
    out2 = _train(tmp_path, arch, 3, "auto")
    assert "[train] resumed from step 6" in capsys.readouterr().out
    full = _train(tmp_path, arch, 9, "none", ckpt="full")
    assert out2["losses"] == full["losses"][6:]
    assert all(torch.equal(a, b) for a, b in zip(out2["model"].parameters(),
                                                 full["model"].parameters()))
    got_opt = _port_opt_tree(out2["opt_state"])
    for (pa, a), (pb, b) in zip(flatten_with_paths(got_opt),
                                flatten_with_paths(_port_opt_tree(full["opt_state"]))):
        assert pa == pb and np.array_equal(a, b), pa
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [3, 6, 9]
    bundle = out2["bundle"]
    m = json.loads((tmp_path / "ck" / "step_0000000009" / "manifest.json").read_text())
    want = {p: s.to_json() for p, s in flatten_with_paths(bundle.in_specs[:2])}
    assert {e["path"]: e["spec"] for e in m["leaves"]} == want
    assert any(e["path"] == "0/tables/0" or e["path"] == "0/user_embed" for e in m["leaves"])
    jc = jreg.get_smoke_cfg(arch)
    jp = JR.init_recsys(jax.random.PRNGKey(0), jc)
    init, _ = jsteps._opt_pack(jreg.get_arch(arch).optimizer)
    (rp, ro), step = JaxManager(str(tmp_path / "ck")).restore((jp, init(jp)))
    assert step == 9
    _close_trees(convert.recsys_to_numpy(out2["model"]), jax.device_get(rp), "params",
                 rtol=0, atol=0)
    _close_trees(got_opt, jax.device_get(ro), "opt", rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "autoint"])
def test_launch_train_recsys_matches_the_reference_steps(arch):
    """Three smoke steps of ``launch.train`` from the port's seeded init: the
    reference bundle's step from the same weights and batches gives the same
    losses."""
    out = train_cli.train(arch, steps=3, smoke=True, ckpt_dir=None, ckpt_every=0,
                          resume="none", seed=0, device="cpu", log_every=0)
    tc = registry.get_smoke_cfg(arch)
    init = R.init_recsys(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.recsys_to_numpy(init))
    jinit, _ = jsteps._opt_pack(jreg.get_arch(arch).optimizer)
    jo = jinit(jp)
    losses = []
    for t in range(3):
        jp, jo, met = _ref_step(arch, jp, jo, _batch(tc, step=t))
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(out["losses"], losses, **TOL)


def test_launch_train_recsys_cli(capsys):
    out = train_cli.main(["--arch", "deepfm", "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "16", "--seed", "1"])
    assert out["steps_run"] == 2 and out["model"].cfg == registry.get_smoke_cfg("deepfm")
    assert out["bundle"].meta["dims"] == {"batch": 16}
    assert capsys.readouterr().out.strip().endswith(
        f"[train] done: 2 steps, final loss {out['final_loss']:.4f}")
    with pytest.raises(ValueError, match="not a train cell"):
        train_cli.train("autoint", steps=1, smoke=False, ckpt_dir=None, ckpt_every=0,
                        resume="none", seed=0, shape="serve_p99", device="cpu")
    gnn = train_cli.train("graphcast", steps=1, smoke=True, ckpt_dir=None, ckpt_every=0,
                          resume="none", seed=0, device="cpu")
    assert gnn["steps_run"] == 1 and gnn["bundle"].meta["family"] == "gnn"
