"""The bi-encoder's training half through the port against ``repro``: the LR
schedules, AdamW (its clip and its decay mask), ``contrastive_loss`` and its
gradients, the sharded loss, the train step, ``tests/test_system.py``'s
30-step trajectory and the encode -> prune -> search of its weights, the
checkpoint format in both directions, ``launch.train`` and ``launch.encode
--steps``. Each case feeds the same numpy inputs (made from a seed) to both
packages.

Tolerances, each measured here first: the schedules at rtol 1e-6 (XLA's and
PyTorch's f32 ``cos`` may differ by an ULP); AdamW at rtol = atol = 1e-6;
f32 losses at rtol 1e-5 and gradients per leaf within 1e-4 of the leaf's
largest entry (both sides sum in their own order: the largest gap seen is
3.5e-6); bf16 losses at rtol 1e-2 and gradients by the cosine of the
flattened gradient, >= 0.999 (seen: 0.99986). After one Adam step an entry
whose gradient is near zero may move by up to 2·lr the other way, so bf16
parameters after a step are held to 2.2·lr.
"""
import dataclasses
import json
import os
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import (CheckpointManager as JaxManager, load_pytree as jax_load,
                              save_pytree as jax_save)
from repro.configs import biencoder_msmarco as jmsmarco
from repro.configs.steps import _be_loss, _make_train_step
from repro.core import DenseIndex as JaxIndex, StaticPruner as JaxPruner
from repro.core.metrics import evaluate_run as jax_evaluate_run, mean_metrics as jax_mean
from repro.data import tokens as jtokens
from repro.models import biencoder as JB
from repro.optim import adamw as JA, schedule as JS
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, fsio, load_pytree, manager, save_pytree
from repro_torch.configs import biencoder_msmarco
from repro_torch.configs.steps import make_train_step, value_and_grad
from repro_torch.core.index import DenseIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.launch import encode as encode_cli, train as train_cli
from repro_torch.models import biencoder as B
from repro_torch.optim import adamw as TA, schedule as TS
from repro_torch.par.mesh import make_mesh

from test_torch_biencoder import (SYSTEM_KW, TOL, _assert_ids_up_to_near_ties, _mrr,
                                  _system_tokens)

KEY = jax.random.PRNGKey(0)
BCFG_KW = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab=128, embed_dim=32,
               max_len=32, compute_dtype="float32", remat=False)
GRAD_TOL = 1e-4     # of the leaf's largest entry
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    """A nested dict's leaves by path, as f32 numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


def _carried(kw, seed=0):
    """(reference config, port config, reference params, port model) with
    the reference's init carried into the port, gradients on."""
    jc, tc = JB.BiEncoderConfig(**kw), B.BiEncoderConfig(**kw)
    p = JB.init_biencoder(jax.random.PRNGKey(seed), jc)
    model = convert.biencoder_from_numpy(jax.tree.map(np.asarray, p), tc, device="cpu")
    return jc, tc, p, model.requires_grad_(True)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_tree(named):
    """Named port tensors as the reference's tree of f32 numpy, flattened."""
    return _flat(convert._numpy_tree(convert.stack_layers(named)))


def _assert_grads(jg, tg):
    want, got = _flat(jax.device_get(jg)), _port_tree(tg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


def _cos_all(jg, tg):
    want, got = _flat(jax.device_get(jg)), _port_tree(tg)
    a = np.concatenate([want[k].ravel() for k in sorted(want)])
    b = np.concatenate([got[k].ravel() for k in sorted(want)])
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base,warm,total,min_ratio", [
    (3e-4, 20, 200, 0.1), (1e-3, 0, 50, 0.1), (1.0, 5, 5, 0.0), (3e-4, 0, 4, 0.1)])
def test_warmup_cosine_matches_reference(base, warm, total, min_ratio):
    jfn, tfn = JS.warmup_cosine(base, warm, total, min_ratio), TS.warmup_cosine(
        base, warm, total, min_ratio)
    for step in range(total + 6):
        got = tfn(step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jfn(step)), rtol=1e-6, atol=0,
                                   err_msg=str(step))
    np.testing.assert_allclose(float(tfn(torch.tensor(total // 2))),
                               float(jfn(total // 2)), rtol=1e-6)


def test_constant_lr_matches_reference():
    got = TS.constant_lr(3e-4)(17)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(JS.constant_lr(3e-4)(17))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _randn_like(t, seed):
    return np.random.default_rng(seed).standard_normal(tuple(t.shape)).astype(np.float32)


def _grads(named, seed, scale):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
            for n, p in named.items()}


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clip_active", "clip_inactive"])
def test_adamw_update_matches_reference(scale):
    """Three updates on the same grads, state and params; the reference's
    state after one step is carried in (``adamw_state_from_numpy``) and the
    port's comes back out (``adamw_state_to_numpy``)."""
    jc, tc, p, model = _carried(BCFG_KW, seed=1)
    named = dict(model.named_parameters())
    cfg = dict(weight_decay=0.1, grad_clip=1.0)
    jstate = JA.adamw_init(p)
    g0 = convert.stack_layers({n: torch.from_numpy(g) for n, g in
                               _grads(named, 99, scale).items()})
    p, jstate = JA.adamw_update(jax.tree.map(lambda t: jnp.asarray(t.numpy()), g0), jstate, p,
                                jnp.float32(1e-3), JA.AdamWConfig(**cfg))
    model = convert.biencoder_from_numpy(jax.tree.map(np.asarray, p), tc, device="cpu")
    named = dict(model.named_parameters())
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    clipped = []
    for t in range(3):
        g = _grads(named, t, scale)
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        jg = jax.tree.map(lambda a: jnp.asarray(a.numpy()), convert.stack_layers(tg))
        gn = float(JA.global_norm(jg))
        np.testing.assert_allclose(float(TA.global_norm(tg)), gn, rtol=1e-6)
        clipped.append(gn > 1.0)
        p, jstate = JA.adamw_update(jg, jstate, p, jnp.float32(1e-3), JA.AdamWConfig(**cfg))
        TA.adamw_update(tg, state, named, torch.tensor(1e-3), TA.AdamWConfig(**cfg))
    assert all(clipped) == (scale == 1.0) and any(clipped) == (scale == 1.0)
    got = convert.adamw_state_to_numpy(state)
    assert got["step"].dtype == np.int32 and int(got["step"]) == int(jstate["step"]) == 4
    for key in ("mu", "nu"):
        want = _flat(jax.device_get(jstate[key]))
        for k, v in _flat(got[key]).items():
            np.testing.assert_allclose(v, want[k], **ADAM_TOL, err_msg=f"{key}/{k}")
    want = _flat(jax.device_get(p))
    for k, v in _flat(convert.biencoder_to_numpy(model)).items():
        np.testing.assert_allclose(v, want[k], **ADAM_TOL, err_msg=k)


def test_adamw_decay_mask_follows_the_reference_leaf():
    """Zero gradients leave only the decay: every leaf of the reference's
    tree with ndim >= 2 decays, which is every per-layer leaf (stacked on
    the layer axis), the layer norms' (d,) tensors included, and the
    embeddings and projection; ``final_norm`` (d,) does not."""
    jc, tc, _, model = _carried(BCFG_KW, seed=2)
    named = dict(model.named_parameters())
    with torch.no_grad():                       # no zero entries: a decayed leaf changes
        for i, t in enumerate(named.values()):
            t.copy_(torch.from_numpy(_randn_like(t, i)))
    p = jax.tree.map(jnp.asarray, convert.biencoder_to_numpy(model))
    before = {n: t.detach().clone() for n, t in named.items()}
    mask = convert.decay_mask(named)
    state = TA.adamw_init(named, mask)
    zeros = {n: torch.zeros_like(t) for n, t in named.items()}
    TA.adamw_update(zeros, state, named, 1e-2)
    jp, _ = JA.adamw_update(jax.tree.map(jnp.zeros_like, p), JA.adamw_init(p), p,
                            jnp.float32(1e-2))
    decayed = {n for n in named if not torch.equal(named[n], before[n])}
    norms = {n for n in named if n.startswith("layers.") and "norm." in n}
    assert len(norms) == 4 * BCFG_KW["n_layers"] and norms <= decayed
    assert decayed == {n for n in named if not n.startswith("final_norm.")}
    assert {n for n, d in mask.items() if d} == decayed
    assert TA.adamw_init(named)["decay"] == {n: t.ndim >= 2 for n, t in named.items()}
    for n in decayed:
        torch.testing.assert_close(named[n], before[n] * (1 - 1e-2 * 0.1), rtol=1e-6, atol=0)
    want = _flat(jax.device_get(jp))
    for k, v in _flat(convert.biencoder_to_numpy(model)).items():
        np.testing.assert_allclose(v, want[k], **ADAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_contrastive_loss_and_grads_f32(pooling, remat):
    kw = dict(SYSTEM_KW, pooling=pooling, remat=remat)
    jc, tc, p, model = _carried(kw)
    b = jtokens.pair_batch(0, 0, batch=16, seq_len=12, vocab=kw["vocab"])
    b["d_mask"][:, 9:] = 0                       # a mask with zeros weights the mean pooling
    jl, jg = jax.value_and_grad(JB.contrastive_loss)(p, _jbatch(b), jc)
    tl, tg = value_and_grad(B.contrastive_loss, model, b)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads(jg, tg)
    with torch.no_grad():
        np.testing.assert_allclose(float(B.contrastive_loss(model, b)), float(jl), rtol=1e-5)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_contrastive_loss_and_grads_bf16(pooling):
    kw = dict(SYSTEM_KW, pooling=pooling, remat=True, compute_dtype="bfloat16")
    jc, tc, p, model = _carried(kw)
    b = jtokens.pair_batch(0, 0, batch=16, seq_len=12, vocab=kw["vocab"])
    jl, jg = jax.value_and_grad(JB.contrastive_loss)(p, _jbatch(b), jc)
    tl, tg = value_and_grad(B.contrastive_loss, model, b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    assert _cos_all(jg, tg) >= 0.999


def test_remat_recomputes_each_layer_only_with_grads(monkeypatch):
    """Under remat each layer of both encodes goes through
    ``torch.utils.checkpoint``; without gradients the forward is plain, and
    the gradients are those of the plain forward."""
    calls = []
    real = B.checkpoint
    monkeypatch.setattr(B, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(BCFG_KW, remat=True)
    _, tc, _, model = _carried(kw)
    b = jtokens.pair_batch(3, 0, batch=8, seq_len=10, vocab=kw["vocab"])
    with torch.no_grad():
        B.contrastive_loss(model, b)
    with torch.inference_mode():
        B.encode(model, b["q_tokens"], b["q_mask"])
    assert calls == []
    loss, grads = value_and_grad(B.contrastive_loss, model, b)
    assert len(calls) == 2 * kw["n_layers"]
    plain = model.with_config(dataclasses.replace(tc, remat=False))
    loss0, grads0 = value_and_grad(B.contrastive_loss, plain, b)
    assert torch.equal(loss, loss0)
    for n in grads:
        torch.testing.assert_close(grads[n], grads0[n], rtol=1e-6, atol=1e-7)


def test_parameters_are_made_without_grads_and_switch_on():
    model = B.init_biencoder(B.BiEncoderConfig(**BCFG_KW), generator=torch.Generator(),
                             device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.requires_grad for p in model.with_config(model.cfg).parameters())


# ---------------------------------------------------------------------------
# the sharded loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names,axis", [
    ((1,), ("data",), "data"), ((2,), ("data",), "data"), ((4,), ("data",), "data"),
    ((2, 2), ("data", "model"), "data"), ((2, 2), ("data", "model"), ("data", "model"))],
    ids=["1", "2", "4", "2x2_data", "2x2_both"])
def test_shard_contrastive_loss_matches_reference(shape, names, axis):
    """The reference's bar (tests/test_models_other.py:236): rtol 1e-4, atol
    1e-5, against its shard_map over the same mesh and against the
    unsharded loss; an extra per-row entry rides along unused. The sharded
    loss is the unsharded function, so its gradients are too."""
    jc, tc, p, model = _carried(BCFG_KW)
    b = jtokens.pair_batch(0, 0, batch=8, seq_len=12, vocab=128)
    b["weight"] = np.ones((8,), np.float32)
    jmesh = jax.make_mesh(shape, names)
    want = JB.shard_contrastive_loss(p, _jbatch(b), jc, jmesh, axis=axis)
    mesh = make_mesh(shape, names, "cpu")
    with torch.no_grad():
        got = B.shard_contrastive_loss(model, b, mesh, axis=axis)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-5)
    plain = {k: v for k, v in b.items() if k != "weight"}
    np.testing.assert_allclose(float(got), float(JB.contrastive_loss(p, _jbatch(plain), jc)),
                               rtol=1e-4, atol=1e-5)
    _, g = value_and_grad(lambda m, x: B.shard_contrastive_loss(m, x, mesh, axis), model, b)
    _, g0 = value_and_grad(B.contrastive_loss, model, plain)
    for n in g:
        torch.testing.assert_close(g[n], g0[n], rtol=1e-4, atol=1e-6)


def test_shard_contrastive_loss_rejects():
    _, _, _, model = _carried(BCFG_KW)
    b = jtokens.pair_batch(0, 0, batch=6, seq_len=8, vocab=128)
    with pytest.raises(ValueError, match="does not split"):
        B.shard_contrastive_loss(model, b, make_mesh((4,), ("data",), "cpu"))
    with pytest.raises(ValueError, match="model's device"):
        B.shard_contrastive_loss(model, b, make_mesh((2,), ("data",), ["cpu", "meta"]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_make_train_step_matches_reference(compute_dtype):
    """One step of ``make_train_step(contrastive_loss)`` against the
    reference launcher's ``_make_train_step(partial(_be_loss, cfg=cfg),
    "adamw")`` (jitted, lr 1e-4) at the smoke config with remat on."""
    kw = dataclasses.asdict(biencoder_msmarco.smoke_cfg())
    kw.update(remat=True, compute_dtype=compute_dtype)
    jc, tc, p, model = _carried(kw)
    jstep, jinit = _make_train_step(partial(_be_loss, cfg=jc), "adamw")
    step, opt_init = make_train_step(B.contrastive_loss)
    b = jtokens.pair_batch(0, 0, batch=8, seq_len=16, vocab=kw["vocab"])
    jp, jopt, jm = jax.jit(jstep)(p, jinit(p), _jbatch(b))
    opt = opt_init(model)
    out = step(model, opt, b)
    assert set(out) == {"loss"} and int(opt["step"]) == 1
    want, got = _flat(jax.device_get(jp)), _flat(convert.biencoder_to_numpy(model))
    if compute_dtype == "float32":
        np.testing.assert_allclose(float(out["loss"]), float(jm["loss"]), rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        jmu = _flat(jax.device_get(jopt["mu"]))
        for k, v in _flat(convert.adamw_state_to_numpy(opt)["mu"]).items():
            np.testing.assert_allclose(v, jmu[k], rtol=0, atol=GRAD_TOL * np.abs(jmu[k]).max(),
                                       err_msg=k)
    else:
        np.testing.assert_allclose(float(out["loss"]), float(jm["loss"]), rtol=1e-2)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2.2e-4, err_msg=k)
    with pytest.raises(ValueError, match="rowwise"):
        make_train_step(B.contrastive_loss, "rowwise")


# ---------------------------------------------------------------------------
# the slice as a whole: tests/test_system.py's 30 steps in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trajectories():
    """tests/test_system.py:24-42 (AdamW at 3e-4 on pair_batch(0, t,
    batch=32, seq_len=16, vocab=256)) in each package from the same carried
    init: (reference losses, its params, port losses, port model)."""
    jc, tc, p, model = _carried(SYSTEM_KW)
    opt = JA.adamw_init(p)

    def _step(p, o, b):
        loss, g = jax.value_and_grad(JB.contrastive_loss)(p, b, jc)
        p, o = JA.adamw_update(g, o, p, jnp.float32(3e-4))
        return p, o, loss

    jstep = jax.jit(_step)
    named = dict(model.named_parameters())
    state = TA.adamw_init(named, convert.decay_mask(named))
    jl, tl = [], []
    for t in range(30):
        b = jtokens.pair_batch(0, t, batch=32, seq_len=16, vocab=256)
        p, opt, loss = jstep(p, opt, _jbatch(b))
        jl.append(float(loss))
        loss, grads = value_and_grad(B.contrastive_loss, model, b)
        TA.adamw_update(grads, state, dict(model.named_parameters()), 3e-4)
        tl.append(float(loss))
    return np.array(jl), p, np.array(tl), model.requires_grad_(False)


def test_thirty_steps_match_reference(trajectories):
    """Losses per step at rtol 1e-5 (seen: 4.9e-7); final parameters within
    1e-4 (a third of one step's lr: an entry whose gradient sits near zero
    may take one step the other way; seen 1.0e-5) and 99.9 % of each leaf
    within 1e-6."""
    jl, p, tl, model = trajectories
    assert tl[-1] < tl[0], "contrastive training must descend"
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    want = _flat(jax.device_get(p))
    for k, v in _flat(convert.biencoder_to_numpy(model)).items():
        d = np.abs(v - want[k])
        assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 1e-3, (k, d.max())


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["f32", "int8"])
def test_port_trained_encoder_encode_prune_search_matches_reference(trajectories,
                                                                     quantize_int8):
    """The port-trained weights carried into the reference: encode -> fit ->
    prune -> search in each package, as
    ``test_trained_encoder_encode_prune_search_matches_reference`` holds
    them; the port-trained encoder retrieves (MRR@10 > 0.2, test_system.py's
    bar)."""
    _, _, _, model = trajectories
    jc = JB.BiEncoderConfig(**SYSTEM_KW)
    p = jax.tree.map(jnp.asarray, convert.biencoder_to_numpy(model))
    d_tok, q_tok = _system_tokens()
    Dj = np.asarray(JB.encode(p, jnp.asarray(d_tok), jnp.ones(d_tok.shape, jnp.int32), jc))
    Qj = np.asarray(JB.encode(p, jnp.asarray(q_tok), jnp.ones(q_tok.shape, jnp.int32), jc))
    Dt = encode_cli.encode_rows(model, d_tok, 256)
    Qt = encode_cli.encode_rows(model, q_tok, 256)
    np.testing.assert_allclose(Dt.numpy(), Dj, **TOL)
    np.testing.assert_allclose(Qt.numpy(), Qj, **TOL)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(Dj))
    tp = StaticPruner(cutoff=0.5).fit(Dt)
    assert tp.kept_dims == jp.kept_dims
    lam = np.asarray(jp.state.eigenvalues)
    np.testing.assert_allclose(tp.state.eigenvalues.numpy(), lam, rtol=0, atol=1e-5 * lam[0])
    jindex = JaxIndex.build(jp.prune_index(jnp.asarray(Dj)), quantize_int8=quantize_int8)
    tindex = DenseIndex.build(tp.prune_index(Dt), quantize_int8=quantize_int8)
    js, ji = (np.asarray(a) for a in jindex.search(jp.transform_queries(jnp.asarray(Qj)), k=10))
    ts, ti = (a.numpy() for a in tindex.search(tp.transform_queries(Qt), k=10))
    _assert_ids_up_to_near_ties(js, ji, ts, ti)
    assert abs(encode_cli.mrr_at_10(torch.from_numpy(ti))
               - _mrr(ji, jax_mean, jax_evaluate_run)) <= 1e-6
    _, fi = DenseIndex.build(Dt).search(Qt, k=10)
    assert encode_cli.mrr_at_10(fi) > 0.2


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_pair(seed=0):
    """A trained-looking (params, opt_state) pair: the port's tensor tree and
    the same values as the reference's JAX tree."""
    _, _, _, model = _carried(BCFG_KW, seed=seed)
    step, opt_init = make_train_step(B.contrastive_loss)
    opt = opt_init(model)
    step(model, opt, jtokens.pair_batch(seed, 0, batch=4, seq_len=8, vocab=128))
    port = convert.checkpoint_tree(model, opt)
    ref = (jax.tree.map(jnp.asarray, convert.biencoder_to_numpy(model)),
           jax.tree.map(jnp.asarray, convert.adamw_state_to_numpy(opt)))
    return port, ref, model, opt


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        x, y = (np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
                for v in (x, y))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


def test_checkpoint_bytes_equal_the_reference(tmp_path):
    """The same tree saved by each package: the same files, byte for byte
    (manifest included), with the reference's leaf paths."""
    port, ref, _, _ = _ckpt_pair()
    save_pytree(str(tmp_path / "port"), port, extra={"step": 1})
    jax_save(str(tmp_path / "ref"), ref, extra={"step": 1})
    files = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
    m = json.loads((tmp_path / "port" / "manifest.json").read_text())
    paths = [e["path"] for e in m["leaves"]]
    assert paths[0] == "0/embed" and "0/layers/attn/wq/w" in paths and "1/mu/embed" in paths
    assert paths[-1] == "1/step" and m["extra"] == {"step": 1}
    wq = next(e for e in m["leaves"] if e["path"] == "0/layers/attn/wq/w")
    assert wq["shape"] == [2, 32, 32] and wq["dtype"] == "float32" and wq["spec"] == []


def test_checkpoints_cross_both_ways(tmp_path):
    port, ref, model, opt = _ckpt_pair(seed=1)
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(7, port, async_=False)
    got, step = JaxManager(str(tmp_path / "a")).restore(ref)
    assert step == 7
    _assert_trees_equal(got, ref)
    _assert_trees_equal(jax_load(str(tmp_path / "a" / "step_0000000007"), ref), ref)
    jm = JaxManager(str(tmp_path / "b"))
    jm.save(9, ref, async_=False)
    back, step = CheckpointManager(str(tmp_path / "b")).restore(port)
    assert step == 9 and back[1]["step"].dtype == torch.int32
    _assert_trees_equal(back, port)
    # and into a live model and optimizer state
    _, _, _, fresh = _carried(BCFG_KW, seed=5)
    state = TA.adamw_init(dict(fresh.named_parameters()))
    convert.restore_into(fresh, state, back)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), model.parameters()))
    assert all(torch.equal(state["nu"][n], opt["nu"][n]) for n in opt["nu"])
    assert int(state["step"]) == int(opt["step"])


def test_checkpoint_round_trip_and_device(tmp_path):
    port, _, _, _ = _ckpt_pair()
    save_pytree(str(tmp_path / "ck"), port)
    back = load_pytree(str(tmp_path / "ck"), port)
    _assert_trees_equal(back, port)
    numpy_target = jax.tree.map(lambda t: t.detach().numpy(), port)
    back = load_pytree(str(tmp_path / "ck"), numpy_target)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in jax.tree.leaves(back))
    bad = ({**port[0], "embed": torch.zeros(3, 3)}, port[1])
    with pytest.raises(ValueError, match="0/embed"):
        load_pytree(str(tmp_path / "ck"), bad)


def test_checkpoint_save_fsyncs_every_blob_and_parent_dir(tmp_path, monkeypatch):
    synced_files, synced_dirs = [], []
    real_file, real_dir = fsio.fsync_file, fsio.fsync_dir
    monkeypatch.setattr(manager, "fsync_file",
                        lambda p: (synced_files.append(p), real_file(p)))
    monkeypatch.setattr(fsio, "fsync_dir", lambda p: (synced_dirs.append(p), real_dir(p)))
    port, _, _, _ = _ckpt_pair()
    save_pytree(str(tmp_path / "ck"), port)
    n_leaves = len(jax.tree.leaves(port))
    assert len([f for f in synced_files if f.endswith(".npy")]) == n_leaves
    assert str(tmp_path) in [os.path.normpath(d) for d in synced_dirs]
    assert not os.path.exists(tmp_path / "ck.tmp")
    assert os.path.exists(tmp_path / "ck" / "manifest.json")


def test_checkpoint_manager_retention_async_and_missing(tmp_path):
    port, _, _, _ = _ckpt_pair()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(port)
    mgr = CheckpointManager(str(tmp_path / "m"), keep_n=2)
    for step in (10, 20, 30):
        mgr.save(step, port, async_=False)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    _, step = mgr.restore(port)
    assert step == 30
    os.makedirs(tmp_path / "m" / "step_0000000040.tmp")     # a torn save is no checkpoint
    os.makedirs(tmp_path / "m" / "step_0000000050")
    assert mgr.all_steps() == [20, 30]
    # async: the host copy is taken in save(); updates after it do not reach the file
    a = CheckpointManager(str(tmp_path / "a"), keep_n=3)
    tree = {"w": torch.ones(64, 64), "step": torch.tensor(3, dtype=torch.int32)}
    a.save(5, tree)
    tree["w"].mul_(0)
    a.wait()
    assert a.latest_step() == 5
    back, _ = a.restore(tree)
    assert torch.equal(back["w"], torch.ones(64, 64))


def test_checkpoint_async_error_surfaces_in_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    started = threading.Event()

    def boom(*a, **k):
        started.set()
        raise OSError("disk full")

    monkeypatch.setattr(manager, "save_pytree", boom)
    mgr.save(1, {"w": torch.zeros(2)})
    assert started.wait(10)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                 # reported once
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------


def _train(tmp_path, steps, resume, ckpt="ck"):
    return train_cli.train("biencoder-msmarco", steps=steps, smoke=True,
                           ckpt_dir=str(tmp_path / ckpt), ckpt_every=3, resume=resume,
                           seed=0, device="cpu", log_every=0)


def test_train_resume_replays_bitwise(tmp_path, capsys):
    """6 steps with checkpoints every 3, then ``--resume auto`` for 3: the
    resumed losses are bitwise the last 3 of an uninterrupted 9-step run
    (the reference's own test only asks for a finite loss)."""
    out1 = _train(tmp_path, 6, "none")
    assert out1["steps_run"] == 6 and all(np.isfinite(out1["losses"]))
    out2 = _train(tmp_path, 3, "auto")
    assert "[train] resumed from step 6" in capsys.readouterr().out
    full = _train(tmp_path, 9, "none", ckpt="full")
    assert out2["losses"] == full["losses"][6:]
    assert all(torch.equal(a, b) for a, b in zip(out2["model"].parameters(),
                                                 full["model"].parameters()))
    assert int(out2["opt_state"]["step"]) == 9
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [3, 6, 9]
    # the port's checkpoint restores in the reference's manager
    jc = jmsmarco.smoke_cfg()
    p = JB.init_biencoder(KEY, jc)
    (jp, jo), step = JaxManager(str(tmp_path / "ck")).restore((p, JA.adamw_init(p)))
    assert step == 9 and int(jo["step"]) == 9
    want = convert.biencoder_to_numpy(out2["model"])
    for k, v in _flat(jax.device_get(jp)).items():
        np.testing.assert_array_equal(v, _flat(want)[k], err_msg=k)


def test_train_cli_and_refusals(tmp_path, capsys):
    out = train_cli.main(["--arch", "biencoder-msmarco", "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "4", "--seed", "1"])
    assert out["steps_run"] == 2 and out["model"].cfg == biencoder_msmarco.smoke_cfg()
    assert capsys.readouterr().out.strip().endswith(
        f"[train] done: 2 steps, final loss {out['final_loss']:.4f}")
    with pytest.raises(ValueError, match="graphcast.*not yet ported"):
        train_cli.train("graphcast", steps=1, smoke=True, ckpt_dir=None, ckpt_every=0,
                        resume="none", seed=0, device="cpu")
    with pytest.raises(ValueError, match="not a train cell"):
        train_cli.train("biencoder-msmarco", steps=1, smoke=False, ckpt_dir=None,
                        ckpt_every=0, resume="none", seed=0, shape="encode_corpus",
                        device="cpu")


def test_train_raises_on_a_non_finite_loss(monkeypatch):
    real = B.contrastive_loss
    monkeypatch.setattr(B, "contrastive_loss", lambda m, b: real(m, b) * float("nan"))
    with pytest.raises(FloatingPointError, match="step 0"):
        train_cli.train("biencoder-msmarco", steps=2, smoke=True, ckpt_dir=None,
                        ckpt_every=0, resume="none", seed=0, device="cpu")


# ---------------------------------------------------------------------------
# launch.encode --steps: the whole example
# ---------------------------------------------------------------------------


def test_encode_cli_trains_as_the_example(capsys):
    """``launch.encode --device cpu --steps 4`` against
    examples/train_biencoder.py run with ``repro``'s functions from the same
    init: the example's jitted step (value_and_grad of contrastive_loss,
    adamw_update at warmup_cosine(3e-4, 0, 4)(t)) on pair_batch(0, t).
    Losses at rtol 1e-5. Parameters: Adam moves an entry whose gradient is
    near zero by up to lr the other way, so each is held within 2·lr per
    step and at most 0.1 % of a leaf's entries beyond 1e-6 (seen: 1.9e-4
    and 0.015 %). Then the example's encode -> StaticPruner -> DenseIndex
    with ``repro`` on the port-trained weights: embeddings at TOL, ids up
    to near-ties, MRR@10 within 1e-6."""
    steps, batch, seq, n_docs, n_q = 4, 16, 12, 300, 24
    res = encode_cli.main(["--device", "cpu", "--steps", str(steps), "--batch", str(batch),
                           "--seq-len", str(seq), "--n-docs", str(n_docs), "--n-queries",
                           str(n_q), "--seed", "3", "--json"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "[encode] corpus of 300 docs" and len(res.losses) == steps
    assert json.loads(out[-1])["train_steps"] == steps
    assert not any(p.requires_grad for p in res.model.parameters())

    cfg = encode_cli.SMALL_CFG
    jc = JB.BiEncoderConfig(**dataclasses.asdict(cfg))
    init = B.init_biencoder(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    params = jax.tree.map(jnp.asarray, convert.biencoder_to_numpy(init))
    opt = JA.adamw_init(params)
    lr_fn = JS.warmup_cosine(3e-4, steps // 10, steps)

    @jax.jit
    def step(p, o, batch, t):
        loss, g = jax.value_and_grad(JB.contrastive_loss)(p, batch, jc)
        p, o = JA.adamw_update(g, o, p, lr_fn(t))
        return p, o, loss

    losses = []
    for i in range(steps):
        b = jtokens.pair_batch(0, i, batch=batch, seq_len=seq, vocab=jc.vocab)
        params, opt, loss = step(params, opt, _jbatch(b), i)
        losses.append(float(loss))
    np.testing.assert_allclose(res.losses, losses, rtol=1e-5)
    want = _flat(jax.device_get(params))
    for k, v in _flat(convert.biencoder_to_numpy(res.model)).items():
        d = np.abs(v - want[k])
        assert d.max() <= 2 * 3e-4 * steps and (d > 1e-6).mean() <= 1e-3, (k, d.max())

    p = jax.tree.map(jnp.asarray, convert.biencoder_to_numpy(res.model))
    d_tok, q_tok = encode_cli.pair_tokens(n_docs, n_q, seq, jc.vocab)
    Dj = JB.encode(p, jnp.asarray(d_tok), jnp.ones(d_tok.shape, jnp.int32), jc)
    Qj = JB.encode(p, jnp.asarray(q_tok), jnp.ones(q_tok.shape, jnp.int32), jc)
    np.testing.assert_allclose(res.D.numpy(), np.asarray(Dj), **TOL)
    np.testing.assert_allclose(res.Q.numpy(), np.asarray(Qj), **TOL)
    pruner = JaxPruner(cutoff=0.5).fit(Dj)
    index = JaxIndex.build(pruner.prune_index(Dj))
    for name, (idx, q) in {"full": (JaxIndex.build(Dj), Qj),
                           "pruned": (index, pruner.transform_queries(Qj))}.items():
        s, ids = (np.asarray(a) for a in idx.search(q, k=10))
        ts, ti = (a.numpy() for a in res.results[name])
        _assert_ids_up_to_near_ties(s, ids, ts, ti)
        assert abs(_mrr(ids, jax_mean, jax_evaluate_run) - res.mrr[name]) <= 1e-6


def test_encode_cli_checkpoints_and_resumes(tmp_path, capsys):
    """A checkpoint every 100 steps (2 kept), in the reference's format; a
    rerun on the same ``--ckpt-dir`` resumes from step 200 and replays the
    rest of the schedule bitwise."""
    argv = ["--device", "cpu", "--steps", "250", "--batch", "2", "--seq-len", "4",
            "--n-docs", "128", "--n-queries", "8", "--ckpt-dir", str(tmp_path)]
    first = encode_cli.main(argv)
    assert CheckpointManager(str(tmp_path)).all_steps() == [100, 200]
    assert "[train] step  250 loss " in capsys.readouterr().out
    again = encode_cli.main(argv)
    assert "[train] resumed from step 200" in capsys.readouterr().out
    assert again.losses == first.losses[200:]
    assert torch.equal(again.D, first.D)
    jc = JB.BiEncoderConfig(**dataclasses.asdict(encode_cli.SMALL_CFG))
    p = JB.init_biencoder(KEY, jc)
    (jp, jo), step = JaxManager(str(tmp_path)).restore((p, JA.adamw_init(p)))
    assert step == 200 and int(jo["step"]) == 200


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="'cuda'"):
        train_cli.main(["--arch", "biencoder-msmarco", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="'cuda'"):
        encode_cli.main(["--steps", "1", "--n-docs", "64", "--n-queries", "4"])
