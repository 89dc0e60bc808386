"""The port's sharding specs (``par/sharding.py``), the ZeRO-1 specs of its
optimizers and its checkpoints with specs, against ``repro``'s.

Specs are compared exactly, as the manifest writes them (``[None,
"model", ["pod", "data"]]``), for all five LM configs at full shapes on
(1, 1), (1, 4), (2, 2) and (4, 1) meshes of the four forced host devices and
on the (16, 16) production mesh (``jax.sharding.AbstractMesh`` on the
reference side). The port reads its shapes from models built on the meta
device; the reference from ``jax.eval_shape``. ``shard_index`` is held to
``jax.device_put(..., NamedSharding)``'s ``addressable_shards``.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.checkpoint import manager as JM
from repro.configs import registry as jreg
from repro.configs.steps import _zero1_like as jax_zero1_like
from repro.launch.mesh import make_production_mesh as jax_production_mesh
from repro.models import transformer as JT
from repro.optim import adafactor as JAF, adamw as JA
from repro.par import sharding as JSH
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_pytree, manager, save_pytree
from repro_torch.configs import registry
from repro_torch.configs.steps import _opt_sds, _zero1_like
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import init_lm
from repro_torch.optim import adamw as TA
from repro_torch.par import sharding as SH
from repro_torch.par.mesh import make_mesh
from repro_torch.par.sharding import P, ShardedTensor, place, shard_index

LM_ARCHS = ("smollm-135m", "qwen2-1.5b", "phi3-medium-14b", "mixtral-8x7b", "arctic-480b")
MESHES = ("1x1", "1x4", "2x2", "4x1", "16x16")


def _shape(name):
    return tuple(int(x) for x in name.split("x"))


def _meshes(name):
    """(reference mesh, port mesh) of one shape, axes ("data", "model")."""
    shape = _shape(name)
    names = ("data", "model")
    if np.prod(shape) > jax.device_count():
        return AbstractMesh(shape, names), make_mesh(shape, names, "meta")
    return jax.make_mesh(shape, names), make_mesh(shape, names, "cpu")


def _json_tree(tree, to_json):
    """A spec tree as {path: manifest JSON}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update({f"{k}/{p}" if p else k: j for p, j in _json_tree(v, to_json).items()})
        return out
    return {"": to_json(tree)}


def _jjson(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            JM._spec_to_json(s) for path, s in flat}


def _tjson(tree):
    return _json_tree(tree, SH.PartitionSpec.to_json)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jreg.get_arch(arch).cfg
    params = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    return (params, jax.eval_shape(JA.adamw_init, params),
            jax.eval_shape(JAF.adafactor_init, params))


@functools.lru_cache(maxsize=None)
def _port_named(arch):
    cfg = registry.get_arch(arch).cfg
    return dict(init_lm(cfg, generator=None, device="meta").named_parameters())


def _rules(mod, cfg):
    return (mod.lm_rules_dp_only() if cfg.parallelism == "dp_only"
            else mod.lm_rules(moe=cfg.n_experts > 0, moe_dp_dim=cfg.moe_dp_dim))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_partition_spec_json_matches_the_reference():
    cases = [(), (None,), ("model",), (None, "model", "data"), (("pod", "data"), None),
             (None, ("data", "model"))]
    for parts in cases:
        t, j = P(*parts), JP(*parts)
        assert t.to_json() == JM._spec_to_json(j)
        assert SH.PartitionSpec.from_json(JM._spec_to_json(j)) == t
        assert tuple(JM._spec_from_json(t.to_json())) == tuple(j)
        assert json.loads(json.dumps(t.to_json())) == t.to_json()
    assert P("a", None) == P("a", None) and P("a") != P("a", None) and P() != P(None)
    assert len({P("a"), P("a"), P(("a", "b"))}) == 2
    assert list(P(None, ["a", "b"])) == [None, ("a", "b")]


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "16x16", "2x16x16"])
def test_logical_to_physical_and_data_spec(mesh):
    if mesh == "2x16x16":
        names = ("pod", "data", "model")
        jm, tm = AbstractMesh((2, 16, 16), names), make_production_mesh(multi_pod=True)
    else:
        jm, tm = _meshes(mesh)
    for logical in ("dp", "tp", "ep", "sp", "fsdp"):
        assert SH.logical_to_physical(logical, tm) == JSH.logical_to_physical(logical, jm)
    with pytest.raises(ValueError, match="unknown logical axis"):
        SH.logical_to_physical("xx", tm)
    for ndim, kw in [(2, {}), (3, dict(extra={2: "sp"})), (3, dict(batch_dim=1))]:
        assert SH.data_spec(tm, ndim, **kw).to_json() == JM._spec_to_json(
            JSH.data_spec(jm, ndim, **kw))
    assert SH.replicated(3) == P()


def test_production_mesh_matches_the_reference_shapes():
    for multi in (False, True):
        tm = make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        assert tm.shape == shape and tm.device.type == "meta"
        assert tm.axis_names == (("pod", "data", "model") if multi else ("data", "model"))
    with pytest.raises(ValueError):          # the reference's needs 256 devices
        jax_production_mesh()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_match_the_reference(arch, mesh):
    """param_specs, zero1_specs, opt_state_specs and Adafactor's
    ``_zero1_like`` at full shapes, exactly."""
    jm, tm = _meshes(mesh)
    cfg, jcfg = registry.get_arch(arch).cfg, jreg.get_arch(arch).cfg
    jparams, jadam, jfactor = _ref_shapes(arch)
    named = _port_named(arch)
    tparams = convert.reference_shapes(named)
    assert {p: tuple(v.shape) for p, v in convert._leaves(tparams)} == {
        tuple(str(k.key) for k in path): v.shape
        for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    jspec = JSH.param_specs(jparams, jm, _rules(JSH, jcfg))
    tspec = SH.param_specs(tparams, tm, _rules(SH, cfg))
    assert _tjson(tspec) == _jjson(jspec)
    assert _tjson(TA.zero1_specs(tspec, tparams, tm)) == _jjson(
        JA.zero1_specs(jspec, jparams, jm))
    assert _tjson(TA.opt_state_specs(tspec, tparams, tm)) == _jjson(
        JA.opt_state_specs(jspec, jparams, jm))
    assert _tjson(TA.opt_state_specs(tspec, tparams, tm, zero1=False)) == _jjson(
        JA.opt_state_specs(jspec, jparams, jm, zero1=False))
    # the optimizer states' shape trees, then their ZeRO-1 specs
    for opt, jsds in (("adamw", jadam), ("adafactor", jfactor)):
        tsds = _opt_sds(named, opt)
        assert {p: tuple(v.shape) for p, v in manager.flatten_with_paths(tsds)} == {
            "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(jsds)[0]}
        assert _tjson(_zero1_like(tsds, tspec, tparams, tm, opt)) == _jjson(
            jax_zero1_like(jsds, jspec, jparams, jm, opt))


@pytest.mark.parametrize("family", ["biencoder", "gnn", "recsys"])
def test_other_rule_sets_match_the_reference(family):
    paths = ["proj/w", "embed", "pos_embed", "layers/attn/wq/w", "layers/attn/wq/b",
             "layers/mlp/w2/w", "tables/3", "user_embed", "first_order/0",
             "bot_mlp/1/w", "item_tower/0/w", "layers/mlp/w1/b"]
    shapes = [(768, 768), (30522, 768), (512, 64), (12, 768, 768), (12, 768), (4, 96, 48),
              (4096, 64), (1000, 32), (1000, 1), (512, 256), (100, 64), (3, 30)]
    for mesh in ("2x2", "1x4", "16x16"):
        jm, tm = _meshes(mesh)
        jr, tr = getattr(JSH, f"{family}_rules")(), getattr(SH, f"{family}_rules")()
        for path, shape in zip(paths, shapes):
            assert tr.spec(path, shape, tm).to_json() == JM._spec_to_json(
                jr.spec(path, shape, jm)), (mesh, path)
    for moe_dp_dim in ("ff", "d_model"):
        jr, tr = JSH.lm_rules(True, moe_dp_dim), SH.lm_rules(True, moe_dp_dim)
        jm, tm = _meshes("2x2")
        for path, shape in [("layers/moe/w1", (2, 8, 64, 96)), ("layers/moe/w2", (2, 8, 96, 64)),
                            ("layers/moe/w3", (2, 6, 64, 96)), ("layers/moe/router/w", (2, 64, 8))]:
            assert tr.spec(path, shape, tm).to_json() == JM._spec_to_json(
                jr.spec(path, shape, jm)), (moe_dp_dim, path)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

PLACE_CASES = [((8, 12), ("data", "model")), ((8, 12), ("model", "data")),
               ((8, 12), (("data", "model"), None)), ((8, 12), (None, ("model", "data"))),
               ((3, 8, 4), (None, "model")), ((6, 4), ()), ((4, 6, 8), ("data", None, "model"))]


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "4x1"])
@pytest.mark.parametrize("shape,parts", PLACE_CASES, ids=[str(c[1]) for c in PLACE_CASES])
def test_shard_index_matches_named_sharding(mesh, shape, parts):
    jm, tm = _meshes(mesh)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, NamedSharding(jm, JP(*parts)))
    by_dev = {s.device: s for s in arr.addressable_shards}
    placed = place(torch.from_numpy(x), P(*parts), tm)
    assert isinstance(placed, ShardedTensor) and len(placed.shards) == 4
    for slot, dev in enumerate(jm.devices.flat):
        want = by_dev[dev]
        got = shard_index(shape, P(*parts), tm, slot)
        assert [s.indices(n) for s, n in zip(got, shape)] == [
            s.indices(n) for s, n in zip(want.index, shape)]
        np.testing.assert_array_equal(placed.shards[slot].numpy(), np.asarray(want.data))
    assert torch.equal(placed.full(), torch.from_numpy(x))


def test_place_gives_views_on_the_tensors_device():
    tm = make_mesh((2, 2), ("data", "model"), "cpu")
    t = torch.arange(32.0).reshape(4, 8)
    placed = place(t, P("data", "model"), tm)
    placed.shards[3].fill_(-1)               # a view: writes reach t
    assert (t[2:, 4:] == -1).all()
    with pytest.raises(ValueError, match="does not split"):
        shard_index((5, 8), P("data"), tm, 0)
    cols = place(t, P(None, "model"), tm)
    assert cols.shards[1].shape == (4, 4) and torch.equal(cols.full(), t)


def test_fit_spec_matches_the_reference():
    cases = [(P("data", "model"), (8, 12)), (P("model", "data"), (6, 12)),
             (P(("pod", "data"), None), (8, 4)), (P(None, "data"), (4, 3)), (P(), (4,)),
             (P("model"), (4, 4, 4))]
    for mesh in ("1x4", "2x2", "4x1"):
        jm, tm = _meshes(mesh)
        for spec, shape in cases:
            assert manager._fit_spec(spec, shape, tm).to_json() == JM._spec_to_json(
                JM._fit_spec(JP(*spec), shape, jm)), (mesh, spec, shape)


# ---------------------------------------------------------------------------
# checkpoints with specs
# ---------------------------------------------------------------------------


def _lm_ckpt(arch="qwen2-1.5b", mesh="2x2"):
    """(port tree, port spec tree, reference tree, reference spec tree,
    meshes) for a smoke LM and its AdamW state, the same values."""
    jcfg, cfg = jreg.get_smoke_cfg(arch), registry.get_smoke_cfg(arch)
    jp = JT.init_lm(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    jo = JA.adamw_init(jp)
    jo = {"mu": jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                             jo["mu"]),
          "nu": jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), jo["nu"]),
          "step": np.int32(5)}
    jp = jax.tree.map(np.asarray, jp)
    jm, tm = _meshes(mesh)
    jspec = JSH.param_specs(jp, jm, _rules(JSH, jcfg))
    jtree_spec = (jspec, JA.opt_state_specs(jspec, jp, jm))
    model = convert.lm_from_numpy(jp, cfg, device="cpu")
    opt = convert.adamw_state_from_numpy(jo, device="cpu")
    port = convert.checkpoint_tree(model, opt)
    tparams = convert.reference_shapes(dict(model.named_parameters()))
    tspec = SH.param_specs(tparams, tm, _rules(SH, cfg))
    tree_spec = (tspec, TA.opt_state_specs(tspec, tparams, tm))
    return port, tree_spec, (jp, jo), jtree_spec, jm, tm


def test_checkpoint_with_specs_bytes_equal_the_reference(tmp_path):
    port, tspec, ref, jspec, _, _ = _lm_ckpt()
    save_pytree(str(tmp_path / "port"), port, tspec, extra={"step": 5})
    JM.save_pytree(str(tmp_path / "ref"), ref, jspec, extra={"step": 5})
    files = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
    m = json.loads((tmp_path / "port" / "manifest.json").read_text())
    specs = {e["path"]: e["spec"] for e in m["leaves"]}
    assert specs["0/layers/attn/wq/w"] == [None, "data", "model"]
    assert specs["1/mu/embed"] == ["model", "data"] and specs["1/step"] == []


@pytest.mark.parametrize("onto", ["2x2", "1x4", "4x1", "1x1"])
def test_checkpoint_elastic_restore_crosses_both_ways(tmp_path, onto):
    """Written with (2, 2) specs by each package, restored by the other onto
    ``onto``: every slot's block and value equal the reference's placement
    of the same leaf under the refitted spec."""
    port, tspec, ref, jspec, _, _ = _lm_ckpt(mesh="2x2")
    jm, tm = _meshes(onto)
    CheckpointManager(str(tmp_path / "p")).save(5, port, tspec, async_=False)
    JM.CheckpointManager(str(tmp_path / "j")).save(5, ref, jspec, async_=False)
    jgot, step = JM.CheckpointManager(str(tmp_path / "p")).restore(ref, mesh=jm)
    tgot, tstep = CheckpointManager(str(tmp_path / "j")).restore(port, mesh=tm)
    assert step == tstep == 5
    jleaves = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): a
               for path, a in jax.tree_util.tree_flatten_with_path(jgot)[0]}
    for path, st in manager.flatten_with_paths(tgot):
        a = jleaves[path]
        assert isinstance(st, ShardedTensor) and st.mesh is tm
        assert st.spec.to_json() == JM._spec_to_json(a.sharding.spec), path
        by_dev = {s.device: s for s in a.addressable_shards}
        for slot, dev in enumerate(jm.devices.flat):
            np.testing.assert_array_equal(st.shards[slot].float().numpy(),
                                          np.asarray(by_dev[dev].data, np.float32), err_msg=path)
    # and a restore with a resolver, replicated
    rep = load_pytree(str(tmp_path / "j" / "step_0000000005"), port, mesh=tm,
                      spec_resolver=lambda path, shape: P())
    leaf = rep[0]["embed"]
    assert leaf.spec == P(*[None] * 2) and all(torch.equal(s, leaf.full()) for s in leaf.shards)
