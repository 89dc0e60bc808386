"""The decoder-LM family through the port against ``repro``: the five
configs and the registry, ``init_lm``'s tree, ``forward_train`` and its
gradients, ``prefill``, ``decode_step`` and ``decode_step_sliding``,
``apply_moe``, Adafactor, the micro-batched train step, the step bundles,
the converters and ``launch.train`` for LMs. Each case feeds the same numpy
inputs (made from a seed) to both packages, with the reference's weights
carried into the port by ``convert.lm_from_numpy``.

The reference's LM launcher cannot train on JAX 0.9.0 (its activation
anchor raises on the Explicit-axes host mesh), so the port is held against
the model functions called directly (``act_sharding=None``) and against
``_make_train_step(partial(_lm_loss, cfg=cfg), …)`` jitted without a mesh.

Tolerances: f32 losses, logits, caches and MoE outputs at rtol = atol =
1e-5 and the aux loss at 1e-5; gradients per leaf within 1e-4 of the
leaf's largest entry; optimizer steps at rtol = atol = 1e-6 on the
parameters and states; bf16 compute by cosine >= 0.999 (eager PyTorch
rounds some intermediates that XLA keeps in f32).
"""
import dataclasses
import functools
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import registry as jreg
from repro.configs.steps import _lm_loss as jax_lm_loss, _make_train_step
from repro.data import tokens as jtokens
from repro.models import moe as JM, transformer as JT
from repro.optim import adafactor as JAF, adamw as JA
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry, steps
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as M, transformer as T
from repro_torch.optim import adafactor as TAF
from repro_torch.par import sharding as SH
from repro_torch.par.mesh import make_mesh
from repro_torch.util import flatten_with_paths

LM_ARCHS = ("smollm-135m", "qwen2-1.5b", "phi3-medium-14b", "mixtral-8x7b", "arctic-480b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4     # of the leaf's largest entry
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
COS = 0.999


def _cfgs(arch, **kw):
    """(reference smoke config, port smoke config), both with ``kw``."""
    jc, tc = jreg.get_smoke_cfg(arch), registry.get_smoke_cfg(arch)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed=0):
    jc, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, JT.init_lm(jax.random.PRNGKey(seed), jc))


def _carried(arch, seed=0, **kw):
    """(reference config, port config, reference params as jnp, port LM)."""
    jc, tc = _cfgs(arch, **kw)
    p = _ref_params(arch, seed)
    return jc, tc, jax.tree.map(jnp.asarray, p), convert.lm_from_numpy(p, tc, device="cpu")


def _tokens(cfg, B, S, step=0):
    return jtokens.token_batch(0, step, batch=B, seq_len=S, vocab=cfg.vocab)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


def _port_tree(named):
    return _flat(convert._numpy_tree(convert.stack_layers(named)))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# configs, registry, init, converters
# ---------------------------------------------------------------------------


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "act_sharding"}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_the_reference(arch):
    js, ts = jreg.get_arch(arch), registry.get_arch(arch)
    assert _fields(ts.cfg) == _fields(js.cfg)
    assert (ts.arch_id, ts.family, ts.source, ts.optimizer, ts.notes) == (
        js.arch_id, js.family, js.source, js.optimizer, js.notes)
    assert [dataclasses.asdict(c) for c in ts.shapes] == [dataclasses.asdict(c)
                                                         for c in js.shapes]
    assert _fields(registry.get_smoke_cfg(arch)) == _fields(jreg.get_smoke_cfg(arch))
    for cfg in (ts.cfg, registry.get_smoke_cfg(arch)):
        jcfg = JT.TransformerConfig(**_fields(cfg))
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.hd == jcfg.hd


def test_registry_matches_the_reference():
    assert registry.ARCHS == jreg.ARCHS
    assert registry.list_archs() == jreg.list_archs()
    assert registry.list_archs(include_extra=True) == jreg.list_archs(include_extra=True)
    got = [(s.arch_id, c.name, c.skip_reason) for s, c in registry.cells()]
    want = [(s.arch_id, c.name, c.skip_reason) for s, c in jreg.cells()]
    assert got == want and len(got) == 40
    assert [c.name for _, c in registry.cells(include_skipped=False)] == [
        c.name for s, c in jreg.cells(include_skipped=False)]
    assert registry.get_arch("biencoder-msmarco").family == "biencoder"
    for arch in ("graphcast",):
        assert registry.get_arch(arch).family == jreg.get_arch(arch).family == "gnn"
        assert registry.get_smoke_cfg(arch).name == jreg.get_smoke_cfg(arch).name
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")
    with pytest.raises(ValueError, match="skipped"):
        registry.make_step_bundle("qwen2-1.5b", "long_500k", make_mesh((1, 1), ("data", "model"),
                                                                       "meta"))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_lm_tree_matches_the_reference(arch):
    """The port's meta init at full width and its seeded init at smoke width
    have the reference's paths, shapes and dtypes; the init's statistics
    are the reference's distributions."""
    for cfg, jcfg in ((registry.get_arch(arch).cfg, jreg.get_arch(arch).cfg),
                      (registry.get_smoke_cfg(arch), jreg.get_smoke_cfg(arch))):
        want = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
        want = {"/".join(str(k.key) for k in path): (v.shape, str(v.dtype))
                for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        meta = T.init_lm(cfg, generator=None, device="meta")
        got = {"/".join(p): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for p, v in convert._leaves(convert.reference_shapes(
                   dict(meta.named_parameters())))}
        assert got == want
    model = T.init_lm(registry.get_smoke_cfg(arch), generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    named = dict(model.named_parameters())
    assert abs(float(named["embed"].std()) - 0.02) < 0.002
    w = named["layers.0.attn.wq.w"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    assert torch.equal(named["final_norm.scale"], torch.ones_like(named["final_norm.scale"]))
    with pytest.raises(ValueError, match="meta"):
        T.init_lm(registry.get_smoke_cfg(arch), generator=None, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_converters_round_trip(arch):
    p = _ref_params(arch)
    model = convert.lm_from_numpy(p, registry.get_smoke_cfg(arch), device="cpu")
    back = convert.lm_to_numpy(model)
    assert _flat(back).keys() == _flat(p).keys()
    for k, v in _flat(p).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)
    # the layers are views of the carried stacked leaves, one module each
    assert len(model.layers) == registry.get_smoke_cfg(arch).n_layers
    if registry.get_smoke_cfg(arch).n_experts:
        assert model.layers[1].moe["w1"].shape == p["layers"]["moe"]["w1"].shape[1:]
        assert "w3" in model.layers[0].moe and "b" not in model.layers[0].moe["router"]


# ---------------------------------------------------------------------------
# forward_train, its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_train_loss_and_grads_f32(arch):
    jc, tc, jp, model = _carried(arch)
    b = _tokens(jc, 4, 24)
    b["labels"][1, 3:7] = -1                        # ignored positions
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), jc))
    )(jp)
    model.requires_grad_(True)
    tl, tg = steps.value_and_grad(steps._lm_loss, model, b)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want, got = _flat(jax.device_get(jg)), _port_tree(tg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_forward_train_chunks_remat_and_blocked_attention(arch):
    """Four loss chunks, per-layer recompute and the blocked attention path
    (S above the threshold): the reference's loss and gradients."""
    kw = dict(remat=True, blocked_attn_threshold=16, attn_q_chunk=16, attn_k_chunk=8)
    jc, tc, jp, model = _carried(arch, **kw)
    b = _tokens(jc, 2, 64, step=3)
    f = partial(JT.forward_train, loss_chunk=16)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: f(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), jc)))(jp)
    model.requires_grad_(True)
    tl, tg = steps.value_and_grad(
        lambda m, bt: T.forward_train(m, bt["tokens"], bt["labels"], loss_chunk=16), model, b)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want, got = _flat(jax.device_get(jg)), _port_tree(tg)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)
    with torch.no_grad():
        np.testing.assert_allclose(float(T.forward_train(model, b["tokens"], b["labels"],
                                                         loss_chunk=16)), float(jl), **TOL)
    with pytest.raises(ValueError, match="loss chunks"):
        T.forward_train(model, b["tokens"][:, :62], b["labels"][:, :62], loss_chunk=16)


def test_remat_recomputes_each_layer_only_with_grads(monkeypatch):
    _, tc, _, model = _carried("qwen2-1.5b", remat=True)
    calls = []
    real = T._train_layer
    monkeypatch.setattr(T, "_train_layer", lambda *a: (calls.append(1), real(*a))[1])
    b = _tokens(tc, 2, 16)
    with torch.no_grad():
        T.forward_train(model, b["tokens"], b["labels"])
    assert len(calls) == tc.n_layers
    calls.clear()
    model.requires_grad_(True)
    steps.value_and_grad(steps._lm_loss, model, b)
    assert len(calls) == 2 * tc.n_layers


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b", "arctic-480b"])
def test_forward_train_bf16_by_cosine(arch):
    jc, tc, jp, model = _carried(arch, compute_dtype="bfloat16")
    b = _tokens(jc, 4, 24, step=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), jc))
    )(jp)
    model.requires_grad_(True)
    tl, tg = steps.value_and_grad(steps._lm_loss, model, b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    want, got = _flat(jax.device_get(jg)), _port_tree(tg)
    a = np.concatenate([want[k].ravel() for k in sorted(want)])
    g = np.concatenate([got[k].ravel() for k in sorted(want)])
    assert _cos(a, g) >= COS


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_steps_match_the_reference(arch):
    """A prompt of 12 into a cache of 16 slots, then three decode steps at
    positions 12, 13, 14: logits and caches at 1e-5, the port's cache
    written in place."""
    jc, tc, jp, model = _carried(arch)
    toks = _tokens(jc, 3, 16, step=5)["tokens"]
    jl, jcache = JT.prefill(jp, jnp.asarray(toks[:, :12]), jc, cache_len=16)
    tl, tcache = T.prefill(model, toks[:, :12], cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache[0].shape == (tc.n_layers, 3, 16, tc.n_kv_heads, tc.hd)
    assert tcache[0].dtype == torch.float32
    for i in range(2):
        np.testing.assert_allclose(tcache[i].numpy(), np.asarray(jcache[i]), **TOL)
    for pos in (12, 13, 14):
        jl, jcache = JT.decode_step(jp, jcache, jnp.asarray(toks[:, pos]), jnp.int32(pos), jc)
        tl, out = T.decode_step(model, tcache, toks[:, pos], pos)
        assert out[0] is tcache[0]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for i in range(2):
            np.testing.assert_allclose(tcache[i].numpy(), np.asarray(jcache[i]), **TOL)
    # no cache_len: the cache is the prompt's length
    _, c = T.prefill(model, toks[:, :5], cache_len=3)
    assert c[0].shape[2] == 5


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_sliding_matches_the_reference(arch):
    """The rolling buffer before it fills (pos < W), at its wrap and well
    past it (pos ≡ 3 mod W beyond 10·W), from the same random buffer."""
    kw = {} if arch == "mixtral-8x7b" else dict(sliding_window=8)
    jc, tc, jp, model = _carried(arch, **kw)
    W = tc.sliding_window
    rng = np.random.default_rng(7)
    shape = (tc.n_layers, 2, W, tc.n_kv_heads, tc.hd)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    toks = rng.integers(0, tc.vocab, size=(2,)).astype(np.int32)
    for pos in (3, W - 1, W, 10 * W + 3):
        jl, jcache = JT.decode_step_sliding(jp, (jnp.asarray(ck), jnp.asarray(cv)),
                                            jnp.asarray(toks), jnp.int32(pos), jc)
        tcache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
        tl, _ = T.decode_step_sliding(model, tcache, toks, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=str(pos))
        for i in range(2):
            np.testing.assert_allclose(tcache[i].numpy(), np.asarray(jcache[i]), **TOL)


@pytest.mark.parametrize("arch,window", [("qwen2-1.5b", None), ("phi3-medium-14b", None),
                                         ("qwen2-1.5b", 8)])
def test_decode_matches_full_forward(arch, window):
    """The reference's own check, in the port: decode at position p gives the
    full forward's logits at p (with a sliding window: also through the
    rolling buffer). Dense configs only: an MoE layer groups a decode step's
    B tokens apart from the prompt's, so its capacity drops differ."""
    _, tc, _, model = _carried(arch, sliding_window=window)
    toks = torch.from_numpy(_tokens(tc, 2, 10, step=2)["tokens"])
    with torch.no_grad():
        h, _ = T.forward_hidden(model, toks)
        full = T._unembed(model, h)
    _, cache = T.prefill(model, toks[:, :9], cache_len=10)
    lg, _ = T.decode_step(model, cache, toks[:, 9], 9)
    np.testing.assert_allclose(lg.numpy(), full[:, 9].numpy(), rtol=1e-4, atol=1e-4)
    if tc.sliding_window:
        W = tc.sliding_window
        _, cache = T.prefill(model, toks[:, :9], cache_len=W)
        lg, _ = T.decode_step_sliding(model, cache, toks[:, 9], 9)
        np.testing.assert_allclose(lg.numpy(), full[:, 9].numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3-medium-14b"])
def test_prefill_bf16_by_cosine(arch):
    """Dense configs: in bf16 a rounding can flip an MoE token's expert or
    its capacity drop, a discrete change (the MoE layer is held in bf16 by
    ``test_apply_moe_matches_the_reference`` and the trained loss by
    ``test_forward_train_bf16_by_cosine``)."""
    jc, tc, jp, model = _carried(arch, compute_dtype="bfloat16")
    toks = _tokens(jc, 2, 16, step=4)["tokens"]
    jl, jcache = JT.prefill(jp, jnp.asarray(toks), jc)
    tl, tcache = T.prefill(model, toks)
    assert tcache[0].dtype == torch.bfloat16
    for a, b in zip(tl.numpy(), np.asarray(jl)):
        assert _cos(a, b) >= COS
    assert _cos(tcache[0].float().numpy(), np.asarray(jcache[0], np.float32)) >= COS


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

# (B, S, d, f, E, k, group, cf): tokens not a multiple of the group; drops
# at a tight capacity; one group; top-1
MOE_CASES = [(2, 37, 32, 48, 4, 2, 16, 1.25), (3, 20, 32, 48, 8, 2, 32, 0.5),
             (1, 8, 16, 24, 4, 2, 64, 1.25), (2, 33, 32, 40, 6, 1, 16, 1.0)]


@pytest.mark.parametrize("case", MOE_CASES, ids=[str(c[:2]) + f"g{c[6]}cf{c[7]}"
                                                  for c in MOE_CASES])
def test_apply_moe_matches_the_reference(case):
    B, S, d, f, E, k, g, cf = case
    jp = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(1), d, f, E))
    x = np.random.default_rng(3).standard_normal((B, S, d)).astype(np.float32)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf, group_size=g)
    jy, jaux = JM.apply_moe(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            compute_dtype=jnp.float32, **kw)
    tp = {"router": {"w": torch.from_numpy(jp["router"]["w"])},
          **{n: torch.from_numpy(jp[n]) for n in ("w1", "w2", "w3")}}
    from repro_torch.models.layers import as_module
    ty, taux = M.apply_moe(as_module(tp), torch.from_numpy(x), compute_dtype=torch.float32,
                           **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-5)
    # bf16 compute: by cosine
    jy16, _ = JM.apply_moe(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), **kw)
    ty16, _ = M.apply_moe(as_module(tp), torch.from_numpy(x), **kw)
    assert _cos(ty16.float().numpy(), np.asarray(jy16, np.float32)) >= COS


def test_route_breaks_ties_to_the_lowest_expert():
    """All-equal logits (the padded tokens' -1e9): experts 0..k-1, as
    ``jax.lax.top_k`` picks them, and the aux loss that follows."""
    logits = np.full((2, 5, 6), -1e9, np.float32)
    logits[0, 0] = [0.0, 2.0, 2.0, 1.0, 2.0, -1.0]
    jg, jm, jaux = JM._route(jnp.asarray(logits), 2, 6)
    tg, tm, taux = M._route(torch.from_numpy(logits), 2, 6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert tm[1, 0].tolist() == [1, 1, 0, 0, 0, 0] and tm[0, 0].tolist() == [0, 1, 1, 0, 0, 0]


# ---------------------------------------------------------------------------
# Adafactor and the train step
# ---------------------------------------------------------------------------


def test_adafactor_update_matches_the_reference():
    """Five steps on a tree with factored (stacked (L, r, c), 4-d expert,
    (L, d) norm) and unfactored leaves."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 8, 6), "experts": (2, 4, 8, 6), "norm": (3, 8), "bias": (6,),
              "col": (5, 1)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp, jst = jax.tree.map(jnp.asarray, p), JAF.adafactor_init(jax.tree.map(jnp.asarray, p))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tst = TAF.adafactor_init(tp)
    cfg = JAF.AdafactorConfig(weight_decay=0.01)
    tcfg = TAF.AdafactorConfig(weight_decay=0.01)
    for step in range(5):
        g = {k: (rng.standard_normal(s) * 10 ** (step - 2)).astype(np.float32)
             for k, s in shapes.items()}
        jp, jst = JAF.adafactor_update(jax.tree.map(jnp.asarray, g), jst, jp, 1e-2, cfg)
        TAF.adafactor_update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp, 1e-2, tcfg)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **STEP_TOL, err_msg=k)
        for k, v in _flat(jax.device_get(jst["v"])).items():
            np.testing.assert_allclose(_flat(convert._numpy_tree(tst["v"]))[k], v, rtol=1e-6,
                                       atol=0, err_msg=k)
    assert int(tst["step"]) == 5 and tst["step"].dtype == torch.int32
    assert set(tst["v"]["col"]) == {"v"} and set(tst["v"]["norm"]) == {"vr", "vc"}


TRAIN_CASES = [("qwen2-1.5b", "adamw", 1, "float32"), ("qwen2-1.5b", "adamw", 2, "float32"),
               ("qwen2-1.5b", "adamw", 4, "float32"), ("qwen2-1.5b", "adamw", 2, "bfloat16"),
               ("qwen2-1.5b", "adamw", 4, "bfloat16"), ("mixtral-8x7b", "adamw", 2, "float32"),
               ("arctic-480b", "adafactor", 1, "float32"),
               ("arctic-480b", "adafactor", 2, "bfloat16"),
               ("arctic-480b", "adafactor", 4, "float32")]


@pytest.mark.parametrize("arch,optimizer,k,accum", TRAIN_CASES,
                         ids=["-".join(map(str, c)) for c in TRAIN_CASES])
def test_train_step_matches_the_reference(arch, optimizer, k, accum):
    """Two steps of ``make_train_step(_lm_loss, optimizer, microbatch=K,
    accum_dtype)`` against the reference's ``_make_train_step`` jitted with
    no mesh: losses at 1e-5. f32 accumulation: parameters and optimizer
    state at 1e-6. bf16 accumulation rounds each gradient to 8 bits, so an
    f32 difference of one ULP can move a bf16 gradient by 2^-8 relative,
    and an Adam or Adafactor step turns that into up to ~lr on an entry
    whose moments nearly cancel: parameters within 2.2 · lr (as bf16 steps
    are held in ``test_torch_train.py``) and the steps' updates at cosine
    >= 0.999."""
    jc, tc, jp, model = _carried(arch)
    lr = 1e-4
    jstep, jinit = _make_train_step(partial(jax_lm_loss, cfg=jc), optimizer, lr=lr,
                                    microbatch=k, accum_dtype=jnp.dtype(accum))
    jstep = jax.jit(jstep)
    jo = jinit(jp)
    model.requires_grad_(True)
    step, opt_init = steps.make_train_step(steps._lm_loss, optimizer, lr=lr, microbatch=k,
                                           accum_dtype=accum)
    opt = opt_init(model)
    before = _flat(jax.device_get(jp))
    for t in range(2):
        b = _tokens(jc, 8, 16, step=t)
        jp, jo, jm = jstep(jp, jo, {n: jnp.asarray(v) for n, v in b.items()})
        out = step(model, opt, b, t)
        np.testing.assert_allclose(float(out["loss"]), float(jm["loss"]), **TOL)
        want, got = _flat(jax.device_get(jp)), _port_tree(dict(model.named_parameters()))
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            if accum == "float32":
                np.testing.assert_allclose(got[n], w, **STEP_TOL, err_msg=n)
            else:
                np.testing.assert_allclose(got[n], w, rtol=0, atol=2.2 * lr, err_msg=n)
    if accum != "float32":
        names = sorted(want)
        dw = np.concatenate([(want[n] - before[n]).ravel() for n in names])
        dg = np.concatenate([(got[n] - before[n]).ravel() for n in names])
        assert _cos(dw, dg) >= COS
    ptree = convert.checkpoint_tree(model, opt)[1]
    want_o = _flat({k: v for k, v in jax.device_get(jo).items() if k != "step"})
    got_o = _flat({k: v for k, v in convert._numpy_tree(ptree).items() if k != "step"})
    assert sorted(got_o) == sorted(want_o)
    for n, w in want_o.items():
        if accum == "float32":
            np.testing.assert_allclose(got_o[n], w, rtol=1e-5, atol=1e-6, err_msg=n)
        else:
            assert _cos(got_o[n], w) >= COS, n
    assert int(opt["step"]) == 2


def test_make_train_step_rejects():
    _, tc, _, model = _carried("qwen2-1.5b")
    model.requires_grad_(True)
    step, opt_init = steps.make_train_step(steps._lm_loss, microbatch=3)
    with pytest.raises(ValueError, match="micro-batches"):
        step(model, opt_init(model), _tokens(tc, 8, 16))
    with pytest.raises(ValueError, match="rowwise"):
        steps.make_train_step(steps._lm_loss, "rowwise")


# ---------------------------------------------------------------------------
# step bundles
# ---------------------------------------------------------------------------

BUNDLE_CELLS = [(a, c) for a in LM_ARCHS for c in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("mixtral-8x7b", "long_500k")]


@pytest.mark.parametrize("arch,cell", BUNDLE_CELLS, ids=[f"{a}:{c}" for a, c in BUNDLE_CELLS])
def test_lm_bundle_matches_the_reference(arch, cell):
    """``make_step_bundle`` on a (2, 2) mesh: the reference's meta (model
    FLOPs, analytic bytes, tokens, micro-batches), argument shapes and spec
    trees."""
    jm = jax.make_mesh((2, 2), ("data", "model"))
    tm = make_mesh((2, 2), ("data", "model"), "meta")
    jb, tb = jreg.make_step_bundle(arch, cell, jm), registry.make_step_bundle(arch, cell, tm)
    assert tb.name == jb.name and tb.donate == jb.donate and tb.meta == jb.meta
    assert tb.mesh is tm

    def shapes_j(tree):
        return [(tuple(v.shape), str(v.dtype)) for v in jax.tree.leaves(tree)]

    def shapes_t(tree):
        return [(tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for _, v in convert._leaves({"a": _list_to_dict(tree)})]

    assert shapes_t(tb.args) == shapes_j(jb.args)

    def specs_j(tree):
        leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))
        return [json.dumps(SH.PartitionSpec(*s).to_json()) for s in leaves]

    def specs_t(tree):
        return [json.dumps(s.to_json()) for _, s in convert._leaves({"a": _list_to_dict(tree)})]

    assert specs_t(tb.in_specs) == specs_j(jb.in_specs)
    assert specs_t(tb.out_specs) == specs_j(jb.out_specs)


def _list_to_dict(tree):
    """Tuples and lists as dicts of their positions (sorted as JAX flattens
    them: fewer than ten entries), so ``convert._leaves`` walks them."""
    if isinstance(tree, (tuple, list)):
        return {str(i): _list_to_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _list_to_dict(tree[k]) for k in sorted(tree)}
    return tree


# ---------------------------------------------------------------------------
# launch.train for LMs
# ---------------------------------------------------------------------------


def _train(tmp_path, arch, steps_, resume, ckpt="ck"):
    return train_cli.train(arch, steps=steps_, smoke=True, ckpt_dir=str(tmp_path / ckpt),
                           ckpt_every=3, resume=resume, seed=0, device="cpu", log_every=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b", "arctic-480b"])
def test_launch_train_lm_resumes_bitwise(tmp_path, arch, capsys):
    """6 steps with checkpoints every 3, then ``--resume auto`` for 3: the
    resumed losses and parameters are bitwise an uninterrupted 9-step run's;
    the manifest's specs are the bundle's on the run's mesh; the checkpoint
    restores in the reference's manager."""
    out1 = _train(tmp_path, arch, 6, "none")
    assert out1["steps_run"] == 6 and all(np.isfinite(out1["losses"]))
    out2 = _train(tmp_path, arch, 3, "auto")
    assert "[train] resumed from step 6" in capsys.readouterr().out
    full = _train(tmp_path, arch, 9, "none", ckpt="full")
    assert out2["losses"] == full["losses"][6:]
    assert all(torch.equal(a, b) for a, b in zip(out2["model"].parameters(),
                                                 full["model"].parameters()))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [3, 6, 9]
    bundle = out2["bundle"]
    assert bundle.mesh.shape == (1, 1) and bundle.mesh.device.type == "cpu"
    opt_name = registry.get_arch(arch).optimizer
    assert ("v" in out2["opt_state"]) == (opt_name == "adafactor")
    m = json.loads((tmp_path / "ck" / "step_0000000009" / "manifest.json").read_text())
    want = dict(_spec_paths(bundle.in_specs[:2]))
    assert {e["path"]: e["spec"] for e in m["leaves"]} == want
    # the reference's manager restores it into its own init's structure
    jc = jreg.get_smoke_cfg(arch)
    jp = JT.init_lm(jax.random.PRNGKey(0), jc)
    jo = (JAF.adafactor_init if opt_name == "adafactor" else JA.adamw_init)(jp)
    (rp, ro), step = JaxManager(str(tmp_path / "ck")).restore((jp, jo))
    assert step == 9 and int(ro["step"]) == 9
    got = _flat(convert.lm_to_numpy(out2["model"]))
    for k, v in _flat(jax.device_get(rp)).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def _spec_paths(spec_tree):
    return [(p, s.to_json()) for p, s in flatten_with_paths(spec_tree)]


def test_launch_train_lm_cli(capsys):
    out = train_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "4", "--seed", "1"])
    assert out["steps_run"] == 2 and out["model"].cfg == registry.get_smoke_cfg("qwen2-1.5b")
    assert out["bundle"].meta["dims"] == {"seq_len": 32, "global_batch": 4}
    assert capsys.readouterr().out.strip().endswith(
        f"[train] done: 2 steps, final loss {out['final_loss']:.4f}")
    # the full config's bundle resolves its specs on the production mesh
    b = registry.make_step_bundle("smollm-135m", "train_4k",
                                  __import__("repro_torch.launch.mesh", fromlist=["m"])
                                  .make_production_mesh())
    assert b.meta["microbatch"] == 4 and b.mesh.shape == (16, 16)
    with pytest.raises(ValueError, match="not a train cell"):
        train_cli.train("qwen2-1.5b", steps=1, smoke=False, ckpt_dir=None, ckpt_every=0,
                        resume="none", seed=0, shape="decode_32k", device="cpu")


def test_launch_train_lm_matches_the_reference_step():
    """Two smoke steps of ``launch.train`` (smollm, seeded port init): the
    reference's jitted step from the same weights and batches gives the
    same losses, and the port's own ``make_train_step`` the same bits (its
    parameters against the reference's: ``test_train_step_matches_the_reference``)."""
    out = train_cli.train("smollm-135m", steps=2, smoke=True, ckpt_dir=None, ckpt_every=0,
                          resume="none", seed=0, device="cpu", log_every=0)
    jc, tc = jreg.get_smoke_cfg("smollm-135m"), registry.get_smoke_cfg("smollm-135m")
    init = T.init_lm(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.lm_to_numpy(init))
    jstep, jinit = _make_train_step(partial(jax_lm_loss, cfg=jc), "adamw")
    jstep = jax.jit(jstep)
    jo = jinit(jp)
    init.requires_grad_(True)
    step, opt_init = steps.make_train_step(steps._lm_loss)
    opt = opt_init(init)
    losses = []
    for t in range(2):
        b = jtokens.token_batch(0, t, batch=8, seq_len=32, vocab=jc.vocab)
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        step(init, opt, b, t)
    np.testing.assert_allclose(out["losses"], losses, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(out["model"].parameters(), init.parameters()))
