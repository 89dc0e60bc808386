"""The recsys family's building blocks through the port against ``repro``:
the four configs and their shape cells, the synthetic batches, the MLP
stacks, ``init_recsys``'s tree and the converters, the embedding substrate
(single- and multi-hot bags, the row-sharded bag over four slots), the
DLRM / FM / AutoInt interactions, the CTR forward and loss, the two-tower
embeddings and in-batch softmax (plain and over four slots), CTR retrieval
scores, ``score_candidates``, the rowwise AdaGrad update, int8 gradient
compression with error feedback over four slots, and table compression.
Each case feeds the same numpy inputs (made from a seed) to both packages,
with the reference's weights carried into the port by
``convert.recsys_from_numpy``; the sharded cases run the reference under
``shard_map`` on the four forced host devices and the port on a mesh of
four CPU slots.

Tolerances: f32 values at rtol = atol = 1e-5; gradients per leaf within
1e-4 of the leaf's largest entry; the rowwise update's tables and
accumulators at rtol = atol = 1e-6; ids exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as JP

from repro.configs import autoint as j_autoint, base as jbase, deepfm as j_deepfm
from repro.configs import dlrm_mlperf as j_dlrm, two_tower_retrieval as j_tt
from repro.core import table_compress as JTC
from repro.data import recsys as jdata
from repro.models import layers as JL, recsys as JR
from repro.optim import grad_compress as JGC, rowwise as JRW
from repro.par import compat
from repro_torch import convert
from repro_torch.configs import autoint, base, deepfm, dlrm_mlperf, two_tower_retrieval
from repro_torch.core import table_compress as TC
from repro_torch.data import recsys as data
from repro_torch.models import layers as L, recsys as R
from repro_torch.optim import grad_compress as GC, rowwise as RW
from repro_torch.par.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4     # of the leaf's largest entry
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
CONFIGS = {"two-tower-retrieval": (j_tt, two_tower_retrieval),
           "dlrm-mlperf": (j_dlrm, dlrm_mlperf),
           "deepfm": (j_deepfm, deepfm),
           "autoint": (j_autoint, autoint)}
CTR = ("dlrm-mlperf", "deepfm", "autoint")


def _fields(c):
    return dataclasses.asdict(c)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed=0):
    jc = CONFIGS[arch][0].smoke_cfg()
    return jax.tree.map(np.asarray, JR.init_recsys(jax.random.PRNGKey(seed), jc))


def _carried(arch, seed=0):
    """(reference config, port config, reference params as jnp, port model)."""
    jc, tc = CONFIGS[arch][0].smoke_cfg(), CONFIGS[arch][1].smoke_cfg()
    p = _ref_params(arch, seed)
    return jc, tc, jax.tree.map(jnp.asarray, p), convert.recsys_from_numpy(p, tc, device="cpu")


def _ctr(cfg, B=32, step=0):
    return jdata.ctr_batch(0, step, batch=B, vocab_sizes=cfg.vocab_sizes, n_dense=cfg.n_dense)


def _tt(cfg, B=32, step=0):
    return jdata.two_tower_batch(0, step, batch=B, user_vocab=cfg.user_vocab,
                                 item_vocab=cfg.item_vocab)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _ids_match(gi, wi, ws, tol=1e-5):
    """Ids equal under the parity contract: a position may differ only
    where the reference's score there lies within ``tol`` of a neighbour's
    (another sum order may swap a near-tie). Returns the near-ties."""
    gi, wi, ws = np.asarray(gi), np.asarray(wi), np.asarray(ws)
    assert gi.shape == wi.shape
    near = 0
    for b, j in zip(*np.nonzero(gi != wi)):
        nb = [abs(ws[b, j] - ws[b, jj]) <= tol for jj in (j - 1, j + 1)
              if 0 <= jj < ws.shape[1]]
        assert any(nb), (b, j, wi[b, max(j - 1, 0):j + 2], gi[b, max(j - 1, 0):j + 2])
        near += 1
    return near


def _leaf_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, what


def _grads_close(model, loss_fn_t, jgrads):
    """The port's autograd gradients by parameter name against the
    reference's gradient tree, leaf by leaf."""
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn_t(model)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    model.requires_grad_(False)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jgrads))
    for (n, _), g in zip(named.items(), grads):
        gw = want[n]
        if g is None:       # a parameter the loss does not read
            assert not np.any(gw), n
            continue
        _leaf_close(g.detach().numpy(), gw, n)
    return loss.detach()


# ---------------------------------------------------------------------------
# configs, shapes, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_configs_match_the_reference(arch):
    jm, tm = CONFIGS[arch]
    js, ts = jm.spec(), tm.spec()
    assert _fields(ts.cfg) == _fields(js.cfg)
    assert _fields(tm.smoke_cfg()) == _fields(jm.smoke_cfg())
    for f in ("arch_id", "family", "source", "optimizer", "notes"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.cfg.param_count() == js.cfg.param_count()
    assert tm.smoke_cfg().param_count() == jm.smoke_cfg().param_count()
    assert ts.cfg.n_sparse == js.cfg.n_sparse


def test_recsys_shapes_match_the_reference():
    assert [dataclasses.asdict(c) for c in base.RECSYS_SHAPES] == [
        dataclasses.asdict(c) for c in jbase.RECSYS_SHAPES]


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17)])
def test_batches_are_the_references_bitwise(seed, step):
    cfg = dlrm_mlperf.CFG
    for kw in (dict(vocab_sizes=cfg.vocab_sizes, n_dense=13), dict(vocab_sizes=(7, 513))):
        got = data.ctr_batch(seed, step, batch=257, **kw)
        want = jdata.ctr_batch(seed, step, batch=257, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    c = two_tower_retrieval.CFG
    got = data.two_tower_batch(seed, step, batch=300, user_vocab=c.user_vocab,
                               item_vocab=c.item_vocab)
    want = jdata.two_tower_batch(seed, step, batch=300, user_vocab=c.user_vocab,
                                 item_vocab=c.item_vocab)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# MLP stacks, init, converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,final_act", [("relu", False), ("relu", True), ("silu", False),
                                           ("silu", True)])
def test_mlp_stack_matches_the_reference(act, final_act):
    dims = (13, 32, 16, 1)
    jp = jax.tree.map(np.asarray, JL.init_mlp_stack(jax.random.PRNGKey(1), dims))
    stack = L.init_mlp_stack(torch.Generator().manual_seed(1), dims)
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in stack] == [
        {k: v.shape for k, v in p.items()} for p in jp]
    assert all(not torch.any(p["b"]) for p in stack)
    ported = convert._tensor_tree(jp, "cpu")
    x = np.random.default_rng(0).standard_normal((9, 13)).astype(np.float32)
    want = JL.apply_mlp_stack(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), act=act,
                              final_act=final_act)
    got = L.apply_mlp_stack([L.as_module(p) for p in ported], torch.as_tensor(x), act=act,
                            final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown activation"):
        L.apply_mlp_stack(stack, torch.as_tensor(x), act="tanh")


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_init_recsys_tree_matches_the_reference(arch):
    """The port's init has the reference's tree (paths, shapes, dtypes, lists
    as lists) on the CPU and on the meta device, its distributions (unit
    rows scaled by 1/sqrt(dim), zero biases), and the converters carry a
    reference tree across and back exactly."""
    jc, tc, jp, model = _carried(arch)
    ref = _ref_params(arch)
    for m in (R.init_recsys(tc, generator=torch.Generator().manual_seed(0), device="cpu"),
              R.init_recsys(tc, generator=None, device="meta")):
        tree = convert.stack_layers(dict(m.named_parameters()))
        got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for p, v in convert._leaves(tree)}
        want = {p: (tuple(v.shape), str(v.dtype)) for p, v in convert._leaves(ref)}
        assert got == want
        assert jax.tree.structure(jax.tree.map(lambda _: 0, ref)) == jax.tree.structure(
            jax.tree.map(lambda _: 0, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    init = R.init_recsys(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    big = init.user_embed if arch == "two-tower-retrieval" else init.tables[0]
    assert abs(float(big.std()) * np.sqrt(big.shape[1]) - 1.0) < 0.05
    for n, p in init.named_parameters():
        if n.endswith(".b") or n == "bias":
            assert not torch.any(p), n
    back = convert.recsys_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the model shares what it is given
    again = R.RecsysModel(tc, dict(model.named_children()) | dict(model.named_parameters(
        recurse=False)))
    assert all(a is b for a, b in zip(again.parameters(), model.parameters()))


# ---------------------------------------------------------------------------
# embedding substrate and interactions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,combiner", [((40,), "mean"), ((40, 3), "mean"),
                                           ((40, 3), "sum")])
def test_embedding_bag_matches_the_reference(shape, combiner):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, shape).astype(np.int32)
    idx.flat[:5] = 7                                  # duplicates
    want, jg = jax.value_and_grad(
        lambda t: (JR.embedding_bag(t, jnp.asarray(idx), combiner=combiner) ** 2).sum())(
        jnp.asarray(table))
    t = torch.as_tensor(table).requires_grad_(True)
    got = (R.embedding_bag(t, torch.as_tensor(idx), combiner=combiner) ** 2).sum()
    (g,) = torch.autograd.grad(got, [t])
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    _leaf_close(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("shape", [(24,), (24, 3)])
def test_sharded_embedding_bag_matches_the_reference(shape):
    """Four slots of ``model``: the reference under ``shard_map`` on the four
    forced host devices, the port over a (1, 4) mesh of CPU slots; both
    equal the unsharded bag."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, shape).astype(np.int32)
    jmesh = jax.make_mesh((1, 4), ("data", "model"))
    fn = compat.shard_map(
        lambda t, i: JR.sharded_embedding_bag(t, i, axis="model", vocab=64),
        mesh=jmesh, in_specs=(JP("model", None), JP()), out_specs=JP(), check_vma=False)
    want = np.asarray(fn(jnp.asarray(table), jnp.asarray(idx)))
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    got = R.sharded_embedding_bag(torch.as_tensor(table), torch.as_tensor(idx), mesh,
                                  axis="model", vocab=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        got.numpy(), R.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx)).numpy())


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_the_reference(self_interaction):
    x = np.random.default_rng(2).standard_normal((6, 5, 4)).astype(np.float32)
    want, jg = jax.value_and_grad(lambda v: JR.dot_interaction(
        v, self_interaction=self_interaction).sum())(jnp.asarray(x))
    want_v = JR.dot_interaction(jnp.asarray(x), self_interaction=self_interaction)
    t = torch.as_tensor(x).requires_grad_(True)
    got = R.dot_interaction(t, self_interaction=self_interaction)
    (g,) = torch.autograd.grad(got.sum(), [t])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_v), **TOL)
    _leaf_close(g.numpy(), np.asarray(jg))


def test_fm_and_autoint_attention_match_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(R.fm_interaction(torch.as_tensor(x)).numpy(),
                               np.asarray(JR.fm_interaction(jnp.asarray(x))), **TOL)
    jp = jax.tree.map(np.asarray, JR.init_autoint_attn(jax.random.PRNGKey(0), 8, 2, 4))
    tp = R.init_autoint_attn(torch.Generator().manual_seed(0), 8, 2, 4)
    assert {k: tuple(v["w"].shape) for k, v in tp.items()} == {k: v["w"].shape
                                                                for k, v in jp.items()}
    want, jg = jax.value_and_grad(
        lambda p: JR.apply_autoint_attn(p, jnp.asarray(x), 2, 4).sum())(
        jax.tree.map(jnp.asarray, jp))
    mod = L.as_module(convert._tensor_tree(jp, "cpu")).requires_grad_(True)
    got = R.apply_autoint_attn(mod, torch.as_tensor(x), 2, 4)
    assert got.shape == (6, 5, 8)
    np.testing.assert_allclose(float(got.sum()), float(want), **TOL)
    named = dict(mod.named_parameters())
    grads = torch.autograd.grad(got.sum(), list(named.values()))
    flat = convert.unstack_layers(jax.tree.map(np.asarray, jg))
    for n, g in zip(named, grads):
        _leaf_close(g.numpy(), flat[n], n)


# ---------------------------------------------------------------------------
# CTR forward and loss, two-tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", CTR)
def test_forward_ctr_and_bce_match_the_reference(arch):
    jc, tc, jp, model = _carried(arch)
    b = _ctr(jc)
    want = JR.forward_ctr(jp, _j(b), jc)
    got = R.forward_ctr(model, _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # numpy in, CPU model: the batch goes to the model's device
    np.testing.assert_array_equal(R.forward_ctr(model, b).numpy(), got.numpy())
    jl, jg = jax.value_and_grad(lambda p: JR.bce_loss(p, _j(b), jc))(jp)
    loss = _grads_close(model, lambda m: R.bce_loss(m, _t(b)), jg)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)


@pytest.mark.parametrize("arch", CTR)
def test_forward_ctr_row_sharded_matches_the_reference(arch):
    """``forward_ctr`` with every table row-sharded over the four slots of
    ``model`` against the reference's inside ``shard_map``."""
    jc, tc, jp, model = _carried(arch)
    b = _ctr(jc, B=16)
    jmesh = jax.make_mesh((1, 4), ("data", "model"))
    specs = {k: jax.tree.map(lambda _: JP(), v) for k, v in jp.items()}
    specs["tables"] = [JP("model", None)] * len(jp["tables"])
    fn = compat.shard_map(lambda p, x: JR.forward_ctr(p, x, jc, mesh_axis="model"),
                          mesh=jmesh, in_specs=(specs, jax.tree.map(lambda _: JP(), _j(b))),
                          out_specs=JP(), check_vma=False)
    want = np.asarray(fn(jp, _j(b)))
    got = R.forward_ctr(model, _t(b), mesh=make_mesh((1, 4), ("data", "model"), "cpu"),
                        axis="model")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_two_tower_embeddings_and_loss_match_the_reference():
    jc, tc, jp, model = _carried("two-tower-retrieval")
    b = _tt(jc)
    for jf, tf, key in ((JR.user_embedding, R.user_embedding, "user_ids"),
                        (JR.item_embedding, R.item_embedding, "item_ids")):
        want = np.asarray(jf(jp, jnp.asarray(b[key])))
        got = tf(model, torch.as_tensor(b[key])).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    jl, jg = jax.value_and_grad(lambda p: JR.two_tower_loss(p, _j(b), jc))(jp)
    loss = _grads_close(model, lambda m: R.two_tower_loss(m, _t(b)), jg)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)


@pytest.mark.parametrize("shape,axis", [((4,), "data"), ((2, 2), ("data", "model"))])
def test_two_tower_loss_sharded_matches_the_reference(shape, axis):
    names = ("data",) if len(shape) == 1 else ("data", "model")
    jc, tc, jp, model = _carried("two-tower-retrieval")
    b = _tt(jc)
    jmesh = jax.make_mesh(shape, names)
    bspec = {k: JP(axis) for k in b}
    fn = compat.shard_map(lambda p, x: JR.two_tower_loss_sharded(p, x, jc, axis),
                          mesh=jmesh, in_specs=(jax.tree.map(lambda _: JP(), jp), bspec),
                          out_specs=JP(), check_vma=False)
    with jax.set_mesh(jmesh):
        jl, jg = jax.value_and_grad(lambda p: fn(p, _j(b)))(jp)
    mesh = make_mesh(shape, names, "cpu")
    loss = _grads_close(model, lambda m: R.two_tower_loss_sharded(m, _t(b), mesh, axis), jg)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    with pytest.raises(ValueError, match="does not split"):
        R.two_tower_loss_sharded(model, _t(_tt(jc, B=30)), mesh, axis)


@pytest.mark.parametrize("arch", CTR)
def test_ctr_retrieval_scores_match_the_reference(arch):
    jc, tc, jp, model = _carried(arch)
    f_user, f_item = R.ctr_user_item_split(tc)
    assert (f_user, f_item) == JR.ctr_user_item_split(jc)
    b = _ctr(jc, B=1)
    user = {"sparse": b["sparse"][:, :f_user]}
    if jc.n_dense:
        user["dense"] = b["dense"]
    cand = _ctr(jc, B=50, step=1)["sparse"][:, f_user:]
    want = JR.ctr_retrieval_scores(jp, _j(user), jnp.asarray(cand), jc)
    got = R.ctr_retrieval_scores(model, _t(user), torch.as_tensor(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k", [10, 100, 700])
def test_score_candidates_matches_the_reference(k):
    """User queries against the item tower's index (600 rows): the
    reference's ``_scan_topk`` and the port's index dispatch give the same
    ids; k past n clamps to n."""
    jc, tc, jp, model = _carried("two-tower-retrieval")
    items = np.arange(600, dtype=np.int32)
    index = np.asarray(JR.item_embedding(jp, jnp.asarray(items)))
    users = np.array([3, 900, 2047], np.int32)
    ws, wi = JR.score_candidates(jp, jnp.asarray(users), jnp.asarray(index), k=k)
    gs, gi = R.score_candidates(model, torch.as_tensor(users), torch.as_tensor(index), k=k)
    assert gi.shape == (3, min(k, 600))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    assert _ids_match(gi, wi, ws) <= 2


# ---------------------------------------------------------------------------
# rowwise AdaGrad
# ---------------------------------------------------------------------------


def test_combine_duplicate_rows_matches_the_reference():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 9, 40).astype(np.int32)
    g = rng.standard_normal((40, 5)).astype(np.float32)
    wi, wg, wv = (np.asarray(x) for x in JRW.combine_duplicate_rows(jnp.asarray(idx),
                                                                   jnp.asarray(g)))
    ti, tg, tv = RW.combine_duplicate_rows(torch.as_tensor(idx), torch.as_tensor(g))
    np.testing.assert_array_equal(tv.numpy(), wv)
    np.testing.assert_array_equal(ti.numpy(), wi)
    np.testing.assert_allclose(tg.numpy(), wg, **STEP_TOL)
    n = int(wv.sum())
    assert not np.any(tg.numpy()[n:]) and list(ti.numpy()[:n]) == sorted(set(idx.tolist()))


@pytest.mark.parametrize("lr", [1e-4, 0.1])
def test_rowwise_update_matches_the_reference_in_place(lr):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    acc = np.abs(rng.standard_normal(50)).astype(np.float32)
    idx = np.concatenate([[0, 0, 0], rng.integers(0, 50, 61)]).astype(np.int32)
    g = rng.standard_normal((64, 8)).astype(np.float32)
    wt, wa = JRW.rowwise_adagrad_update(jnp.asarray(table), jnp.asarray(acc),
                                        jnp.asarray(idx), jnp.asarray(g), jnp.float32(lr))
    t, a = torch.as_tensor(table.copy()), torch.as_tensor(acc.copy())
    pt, pa = t.data_ptr(), a.data_ptr()
    nt, na = RW.rowwise_adagrad_update(t, a, torch.as_tensor(idx), torch.as_tensor(g), lr)
    assert nt is t and na is a and t.data_ptr() == pt and a.data_ptr() == pa
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), **STEP_TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), **STEP_TOL)
    untouched = np.setdiff1d(np.arange(50), idx)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    assert RW.rowwise_init_table(t).shape == (50,) and RW.RowwiseConfig() == dataclasses.replace(
        RW.RowwiseConfig(), lr_scale=JRW.RowwiseConfig().lr_scale, eps=JRW.RowwiseConfig().eps)


def test_rowwise_update_is_deterministic():
    """Many duplicates of few ids, twice from the same state: bitwise equal."""
    rng = np.random.default_rng(6)
    idx = torch.as_tensor(rng.integers(0, 4, 4096).astype(np.int32))
    g = torch.as_tensor(rng.standard_normal((4096, 16)).astype(np.float32))
    outs = []
    for _ in range(2):
        t, a = torch.ones(8, 16), torch.zeros(8)
        RW.rowwise_adagrad_update(t, a, idx, g, 0.01)
        outs.append((t, a))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# gradient compression over four slots
# ---------------------------------------------------------------------------


def test_compress_int8_matches_the_reference():
    g = np.random.default_rng(7).standard_normal((33, 5)).astype(np.float32) * 3
    scale = np.float32(np.abs(g).max() / 127.0)
    wq = np.asarray(JGC.compress_int8(jnp.asarray(g), jnp.asarray(scale)))
    tq = GC.compress_int8(torch.as_tensor(g), torch.as_tensor(scale))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), wq)
    np.testing.assert_array_equal(
        GC.decompress_int8(tq, torch.as_tensor(scale)).numpy(),
        np.asarray(JGC.decompress_int8(jnp.asarray(wq), jnp.asarray(scale))))


def _per_slot(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * (i + 1)).astype(np.float32) for i in range(n)]


def test_compressed_psum_matches_the_reference():
    gs = _per_slot(4, (17, 3), 8)
    jmesh = jax.make_mesh((4,), ("data",))
    fn = compat.shard_map(lambda g: JGC.compressed_psum(g[0], "data")[None], mesh=jmesh,
                          in_specs=JP("data"), out_specs=JP("data"), check_vma=False)
    want = np.asarray(fn(jnp.asarray(np.stack(gs))))
    got = GC.compressed_psum([torch.as_tensor(g) for g in gs])
    for w in want:                                      # replicated on every slot
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_allclose(got.numpy(), np.sum(gs, 0), atol=4 * np.abs(gs).max() / 127)


def test_error_feedback_step_matches_the_reference():
    """Two steps over four slots of a two-leaf tree: mean-reduced grads (the
    same on every slot) and each slot's residual."""
    n = 4
    jmesh = jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,))
    shapes = {"w": (6, 3), "b": (3,)}
    grads = [{k: _per_slot(n, s, 9 + t)[i] for k, s in shapes.items()}
             for t in range(2) for i in range(n)]
    grads = [grads[:n], grads[n:]]

    def body(g, r):
        m, nr = JGC.error_feedback_step(jax.tree.map(lambda x: x[0], g),
                                        jax.tree.map(lambda x: x[0], r), "data")
        return jax.tree.map(lambda x: x[None], m), jax.tree.map(lambda x: x[None], nr)

    spec = {k: JP("data") for k in shapes}
    fn = compat.shard_map(body, mesh=jmesh, in_specs=(spec, spec), out_specs=(spec, spec),
                          check_vma=False)
    jr = {k: jnp.zeros((n, *s)) for k, s in shapes.items()}
    tr = [GC.init_residual({k: torch.zeros(s) for k, s in shapes.items()}) for _ in range(n)]
    assert all(v.dtype == torch.float32 and not torch.any(v) for v in tr[0].values())
    for step in grads:
        jm, jr = fn({k: jnp.asarray(np.stack([g[k] for g in step])) for k in shapes}, jr)
        tm, tr = GC.error_feedback_step([{k: torch.as_tensor(v) for k, v in g.items()}
                                         for g in step], tr)
        for k in shapes:
            for i in range(n):
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k][i]), **STEP_TOL)
                np.testing.assert_allclose(tr[i][k].numpy(), np.asarray(jr[k][i]), **STEP_TOL)


# ---------------------------------------------------------------------------
# table compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cutoff,fit_rows", [(0.5, 100_000), (0.25, 90)])
def test_compress_tables_matches_the_reference(cutoff, fit_rows):
    """Three 32-wide tables (one shorter than its share of the sample): the
    shared fit's kept dims, the kept subspace (its projector within 1e-4),
    each pruned table up to the sign of each kept component within 1e-4 of
    the table's largest entry (an fp32 eigensolver moves a component by
    about eps · lambda_1 / gap), and the byte accounting."""
    rng = np.random.default_rng(10)
    basis = rng.standard_normal((32, 32)) * np.linspace(4.0, 1.0, 32)[:, None]
    tables = [(rng.standard_normal((v, 32)) @ basis).astype(np.float32) for v in (200, 20, 150)]
    wp, wpr = JTC.compress_tables([jnp.asarray(t) for t in tables], cutoff=cutoff,
                                  fit_rows=fit_rows)
    tp, tpr = TC.compress_tables([torch.as_tensor(t) for t in tables], cutoff=cutoff,
                                 fit_rows=fit_rows)
    assert tpr.kept_dims == wpr.kept_dims
    wt, ww = tpr.projection()[0].numpy(), np.asarray(wpr.projection()[0])
    np.testing.assert_allclose(wt @ wt.T, ww @ ww.T, atol=1e-4)
    for got, want in zip(tp, wp):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        sign = np.sign((got * want).sum(0))
        np.testing.assert_allclose(got * sign, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    tb = TC.compressed_table_bytes([torch.as_tensor(t) for t in tables], cutoff=cutoff)
    wb = JTC.compressed_table_bytes([jnp.asarray(t) for t in tables], cutoff=cutoff)
    assert tb == {k: (float(v) if k == "ratio" else int(v)) for k, v in wb.items()}
