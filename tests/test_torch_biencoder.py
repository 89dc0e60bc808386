"""The bi-encoder's forward through the port against ``repro``: configs,
token pipelines, every layer function, ``encode`` with the reference's
weights carried across, the init, the encode -> fit -> prune -> search path
with ``tests/test_system.py``'s trained encoder, and the encode CLI. Each
case feeds the same numpy inputs (made from a seed) to both packages.

Tolerances: f32 at rtol = atol = 1e-5 (the port's parity bar; both sides
sum in their own order). bf16 results of the layer functions are bitwise
the reference's: the largest gap observed on these inputs is 0 bf16 ULPs,
with 1 and with 3 CPU threads, so the bar is 0. Eager JAX rounds each
operation to bf16 as eager PyTorch does, and GELU and SiLU copy XLA's
formulas (``F.gelu`` differs on ~40 % of entries, ``torch.sigmoid`` on
~30 %). ``encode`` in bf16 is not bitwise: the reference compiles its
layer scan, where XLA may keep an intermediate in f32 that eager PyTorch
rounds, so it is held by cosine per row.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase, biencoder_msmarco as jmsmarco
from repro.core import DenseIndex as JaxIndex, StaticPruner as JaxPruner
from repro.core.metrics import evaluate_run as jax_evaluate_run, mean_metrics as jax_mean
from repro.data import tokens as jtokens
from repro.models import biencoder as JB, layers as JL, transformer as JT
from repro.optim import adamw_init, adamw_update
from repro_torch import convert
from repro_torch.configs import base, biencoder_msmarco
from repro_torch.core.index import DenseIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.data import tokens
from repro_torch.launch import encode as encode_cli
from repro_torch.models import biencoder as B, layers as L, transformer as T

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
KEY = jax.random.PRNGKey(0)

# tests/test_models_other.py:191 and tests/test_system.py:19
BCFG_KW = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, vocab=128, embed_dim=32,
               max_len=32, compute_dtype="float32", remat=False)
SYSTEM_KW = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256, embed_dim=64,
                 max_len=32, compute_dtype="float32", remat=False, temperature=0.1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def assert_matches(ref, got, dt: str):
    """f32: allclose at TOL; bf16: bitwise, in the same dtype."""
    if dt == "f32":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    else:
        assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(ref))


def _t(a, dtype=None) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _tree(p):
    """A reference parameter (sub)tree as nested dicts of CPU tensors."""
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    return _t(p)


def _randn(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, shape, dt):
    """The same input on both sides: (jax array, torch tensor) in dtype dt."""
    x = _randn(seed, *shape)
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _jax_tree(model: B.BiEncoder) -> dict:
    """The port model's parameters as the reference's tree (layers stacked
    on a leading axis), as JAX arrays in the model's parameter dtype."""
    jdt = jnp.bfloat16 if model.cfg.param_dtype == "bfloat16" else jnp.float32
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), convert.biencoder_to_numpy(model))


def _cos_rows(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

CONFIGS = {
    "msmarco": lambda pkg: pkg.CFG,
    "smoke": lambda pkg: pkg.smoke_cfg(),
    "models_other_bcfg": lambda pkg: pkg.BiEncoderConfig(**BCFG_KW),
    "system_cfg": lambda pkg: pkg.BiEncoderConfig(**SYSTEM_KW),
    "example_small": lambda pkg: pkg.BiEncoderConfig(
        **dataclasses.asdict(encode_cli.SMALL_CFG)),
    "defaults": lambda pkg: pkg.BiEncoderConfig(),
}


class _Jax:
    CFG, smoke_cfg, BiEncoderConfig = jmsmarco.CFG, jmsmarco.smoke_cfg, JB.BiEncoderConfig


class _Port:
    CFG, smoke_cfg = biencoder_msmarco.CFG, biencoder_msmarco.smoke_cfg
    BiEncoderConfig = B.BiEncoderConfig


@pytest.mark.parametrize("name", list(CONFIGS))
def test_biencoder_config_matches_reference(name):
    jc, tc = CONFIGS[name](_Jax), CONFIGS[name](_Port)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    jl, tl = jc.lm_cfg(), tc.lm_cfg()
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    assert tl.hd == jl.hd
    assert (tl.param_count(), tl.active_param_count()) == (jl.param_count(),
                                                           jl.active_param_count())
    assert str(tl.pdt).removeprefix("torch.") == str(jl.pdt)
    assert str(tl.cdt).removeprefix("torch.") == str(jl.cdt)


def test_msmarco_param_count_is_the_computed_one():
    """The docstring's "~110M" is BERT-base; the gated MLP's third matrix
    makes the config 137.5M."""
    assert biencoder_msmarco.CFG.param_count() == 137_491_968


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_experts=8, top_k=2, d_ff=64),
    dict(n_experts=4, dense_residual=True, residual_d_ff=96, tie_embeddings=True),
    dict(head_dim=48, n_kv_heads=1, param_dtype="bfloat16"),
], ids=["dense", "moe", "moe_residual_tied", "gqa_bf16"])
def test_transformer_config_matches_reference(kw):
    jc, tc = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.hd, tc.param_count(), tc.active_param_count()) == (
        jc.hd, jc.param_count(), jc.active_param_count())
    assert str(tc.pdt).removeprefix("torch.") == str(jc.pdt)


def test_shapes_and_spec_match_reference():
    def cells(shapes):
        return [dataclasses.asdict(s) for s in shapes]

    assert cells(biencoder_msmarco.SHAPES) == cells(jmsmarco.SHAPES)
    js, ts = jmsmarco.spec(), biencoder_msmarco.spec()
    for f in ("arch_id", "family", "source", "optimizer", "notes"):
        assert getattr(ts, f) == getattr(js, f)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert cells(ts.shapes) == cells(js.shapes)
    assert dataclasses.asdict(ts.cell("encode_corpus")) == dataclasses.asdict(
        js.cell("encode_corpus"))
    with pytest.raises(KeyError):
        ts.cell("nope")
    for sub in (False, True):
        assert cells(base.lm_shapes(sub)) == cells(jbase.lm_shapes(sub))
    assert cells(base.LM_SHAPES) == cells(jbase.LM_SHAPES)
    for v, mult in [(0, 8), (1, 8), (8, 8), (1000, 128), (30522, 256)]:
        assert base.round_up(v, mult) == jbase.round_up(v, mult)


def test_moe_layer_raises_until_ported():
    """Ported: an MoE layer has the reference's ``moe`` node (router and
    (E, d, f) experts), and Arctic's dense residual beside it."""
    cfg = T.TransformerConfig(n_experts=4, d_model=32, d_ff=48)
    lp = T._init_layer(torch.Generator().manual_seed(0), cfg)
    assert "mlp" not in lp and lp["moe"]["router"]["w"].shape == (32, 4)
    assert lp["moe"]["w1"].shape == (4, 32, 48) and lp["moe"]["w2"].shape == (4, 48, 32)
    lp = T._init_layer(torch.Generator().manual_seed(0), dataclasses.replace(
        cfg, dense_residual=True, residual_d_ff=24))
    assert lp["mlp"]["w1"]["w"].shape == (32, 24) and "w3" in lp["moe"]


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,batch,seq_len,vocab", [
    (0, 0, 32, 16, 256), (7, 64, 64, 24, 2048), (99, 3, 5, 7, 30522),
    (1, 1000, 8, 256, 30522), (3, 2, 4, 9, 17),
])
def test_token_batches_bitwise(seed, step, batch, seq_len, vocab):
    kw = dict(batch=batch, seq_len=seq_len, vocab=vocab)
    for fn in ("token_batch", "pair_batch"):
        want = getattr(jtokens, fn)(seed, step, **kw)
        got = getattr(tokens, fn)(seed, step, **kw)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_the_reference_sequence():
    def make(mod):
        return lambda t: mod.pair_batch(3, t, batch=4, seq_len=6, vocab=64)

    seqs = []
    for mod in (jtokens, tokens):
        pf = mod.Prefetcher(make(mod), start_step=5, depth=2)
        try:
            seqs.append([next(pf) for _ in range(6)])
        finally:
            pf.close()
        assert not pf._thread.is_alive()
    for (js, jb), (ts, tb) in zip(*seqs):
        assert js == ts
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert [s for s, _ in seqs[1]] == list(range(5, 11))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
def test_apply_dense(dt, bias):
    p = JL.init_dense(KEY, 48, 80, bias=bias)
    if bias:
        p["b"] = jnp.asarray(_randn(5, 80))
    xj, xt = _inputs(1, (3, 7, 48), dt)
    jdt, tdt = DTYPES[dt]
    want = JL.apply_dense(p, xj, jdt)
    got = L.apply_dense(_tree(p), xt, tdt)
    assert_matches(want, got, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(dt, norm):
    d = 96
    p = {"scale": jnp.asarray(_randn(2, d) * 0.5 + 1.0)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(_randn(3, d) * 0.1)
    xj, xt = _inputs(4, (5, 11, d), dt)
    want = getattr(JL, f"apply_{norm}")(p, xj)
    got = getattr(L, f"apply_{norm}")(_tree(p), xt)
    assert_matches(want, got, dt)
    init_j = getattr(JL, f"init_{norm}")(d)
    init_t = getattr(L, f"init_{norm}")(d)
    assert init_j.keys() == init_t.keys()
    for k in init_j:
        np.testing.assert_array_equal(_np(init_t[k]), _np(init_j[k]))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rope(dt):
    pos = np.arange(3, 40, dtype=np.int32)
    cj, sj = JL.rope_tables(jnp.asarray(pos), 32, 10000.0)
    ct, st = L.rope_tables(torch.from_numpy(pos), 32, 10000.0)
    np.testing.assert_allclose(_np(ct), _np(cj), **TOL)
    np.testing.assert_allclose(_np(st), _np(sj), **TOL)
    xj, xt = _inputs(6, (2, pos.size, 4, 32), dt)
    want = JL.apply_rope(xj, cj[None], sj[None])
    got = L.apply_rope(xt, ct[None], st[None])
    assert_matches(want, got, dt)


ATTN_CASES = {
    # mode, window, Sq, Sk, H, Hkv, k_pos padded at the end
    "bidirectional": ("bidirectional", None, 12, 12, 4, 4, 0),
    "bidirectional_padded_keys": ("bidirectional", None, 12, 12, 4, 2, 3),
    "causal_gqa": ("causal", None, 12, 12, 4, 2, 0),
    "sliding": ("sliding", 5, 12, 12, 4, 1, 0),
    "causal_decode": ("causal", None, 1, 12, 4, 2, 2),
}


def _attn_inputs(case, dt, seed=0):
    mode, window, Sq, Sk, H, Hkv, pad = ATTN_CASES[case]
    Dh = 16
    qj, qt = _inputs(seed, (2, Sq, H, Dh), dt)
    kj, kt = _inputs(seed + 1, (2, Sk, Hkv, Dh), dt)
    vj, vt = _inputs(seed + 2, (2, Sk, Hkv, Dh), dt)
    k_pos = np.arange(Sk, dtype=np.int32)
    if pad:
        k_pos[Sk - pad:] = JL._KPAD
    q_pos = k_pos[:Sq] if Sq == Sk else np.array([Sk - pad - 1], np.int32)
    return (mode, window, (qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(k_pos)),
            (qt, kt, vt, torch.from_numpy(q_pos), torch.from_numpy(k_pos)))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_dense_attention(case, dt):
    mode, window, ja, ta = _attn_inputs(case, dt)
    want = JL.dense_attention(*ja, mode, window)
    got = L.dense_attention(*ta, mode, window)
    assert_matches(want, got, dt)
    if not ATTN_CASES[case][-1]:
        # a caller that vouches for unpadded keys gets the same result
        assert_matches(want, L.dense_attention(*ta, mode, window, keys_padded=False), dt)


def test_mask_bias_matches_reference():
    q_pos = np.array([0, 3, 5, 9, -1], np.int32)
    k_pos = np.array([0, 1, 4, 5, 8, JL._KPAD], np.int32)
    for mode, window in [("bidirectional", None), ("causal", None), ("sliding", 3),
                         ("sliding", None)]:
        want = JL._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), mode, window)
        got = L._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos), mode, window)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["bidirectional", "causal_gqa", "sliding", "causal_decode"])
@pytest.mark.parametrize("chunks", [(5, 4), (16, 7)], ids=["padded_tiles", "one_q_tile"])
def test_blocked_attention(case, dt, chunks):
    """Small chunks, so Q and K are padded to tile multiples."""
    mode, window, ja, ta = _attn_inputs(case, dt, seed=3)
    qc, kc = chunks
    want = JL.blocked_attention(*ja, mode, window, q_chunk=qc, k_chunk=kc)
    got = L.blocked_attention(*ta, mode, window, q_chunk=qc, k_chunk=kc)
    assert_matches(want, got, dt)
    # and it computes the dense attention's function
    dense = L.dense_attention(*ta, mode, window)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=1e-2 if dt == "bf16" else 1e-5,
                               atol=1e-2 if dt == "bf16" else 1e-5)


ATTN_BLOCK_CASES = {
    # mode, window, n_kv_heads, qkv_bias, blocked_threshold, kv_cache rows
    "bidirectional": ("bidirectional", None, 4, False, 8192, 0),
    "causal_gqa_bias": ("causal", None, 2, True, 8192, 0),
    "sliding": ("sliding", 4, 1, False, 8192, 0),
    "blocked": ("causal", None, 2, False, 8, 0),
    "kv_cache": ("causal", None, 2, False, 8192, 9),
    "kv_cache_blocked": ("sliding", 6, 2, False, 8, 9),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(ATTN_BLOCK_CASES))
def test_apply_attention(case, dt):
    mode, window, hkv, bias, thresh, cache = ATTN_BLOCK_CASES[case]
    d, H, Dh = 64, 4, 16
    p = JL.init_attention(KEY, d, H, hkv, Dh, qkv_bias=bias)
    if bias:
        for w in ("wq", "wk", "wv"):
            p[w]["b"] = jnp.asarray(_randn(ord(w[1]), p[w]["w"].shape[1]) * 0.1)
    jdt, tdt = DTYPES[dt]
    S = 1 if cache else 10
    xj, xt = _inputs(8, (2, S, d), dt)
    pos = np.arange(cache, cache + S, dtype=np.int32)
    kw = dict(n_heads=H, n_kv_heads=hkv, head_dim=Dh, rope_theta=10000.0, mode=mode,
              window=window, blocked_threshold=thresh, q_chunk=4, k_chunk=4)
    jkw, tkw = dict(kw, compute_dtype=jdt), dict(kw, compute_dtype=tdt)
    if cache:
        ckj, ckt = _inputs(9, (2, cache, hkv, Dh), dt)
        cvj, cvt = _inputs(10, (2, cache, hkv, Dh), dt)
        cpos = np.arange(cache, dtype=np.int32)
        jkw.update(kv_cache=(ckj, cvj), cache_positions=jnp.asarray(cpos))
        tkw.update(kv_cache=(ckt, cvt), cache_positions=torch.from_numpy(cpos))
    want, (wk, wv) = JL.apply_attention(p, xj, jnp.asarray(pos), **jkw)
    got, (gk, gv) = L.apply_attention(_tree(p), xt, torch.from_numpy(pos), **tkw)
    assert_matches(want, got, dt)
    assert_matches(wk, gk, dt)
    assert_matches(wv, gv, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_gelu(dt):
    """The reference's constants in x's dtype, a rounding after each
    operation: bitwise in bf16 (``F.gelu`` differs on ~40 % of entries)."""
    x32 = _randn(11, 512, 3072, scale=2.0)
    jdt, tdt = DTYPES[dt]
    want = jax.nn.gelu(jnp.asarray(x32).astype(jdt))
    got = L.gelu(torch.from_numpy(x32).to(tdt))
    assert_matches(want, got, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_silu(dt):
    """XLA's logistic, 1 / (1 + exp(-x)), and a rounding after each
    operation: bitwise in bf16 (``torch.sigmoid`` rounds once and differs on
    ~30 % of entries)."""
    x32 = _randn(13, 512, 3072, scale=2.0)
    jdt, tdt = DTYPES[dt]
    want = jax.nn.silu(jnp.asarray(x32).astype(jdt))
    got = L.silu(torch.from_numpy(x32).to(tdt))
    assert_matches(want, got, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("act,gated", [("gelu", True), ("gelu", False), ("silu", True),
                                       ("silu", False)])
def test_apply_mlp(act, gated, dt):
    p = JL.init_mlp(KEY, 64, 160, gated=gated)
    xj, xt = _inputs(12, (3, 9, 64), dt)
    jdt, tdt = DTYPES[dt]
    want = JL.apply_mlp(p, xj, act=act, compute_dtype=jdt)
    got = L.apply_mlp(_tree(p), xt, act=act, compute_dtype=tdt)
    assert_matches(want, got, dt)


def test_apply_mlp_rejects_an_unknown_activation():
    p = L.init_mlp(torch.Generator().manual_seed(0), 8, 16)
    with pytest.raises(ValueError, match="activation"):
        L.apply_mlp(p, torch.zeros(2, 8), act="mish")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _carried(kw, seed=0):
    """A reference init and its carried-across port model."""
    jc, tc = JB.BiEncoderConfig(**kw), B.BiEncoderConfig(**kw)
    p = JB.init_biencoder(jax.random.PRNGKey(seed), jc)
    return jc, tc, p, convert.biencoder_from_numpy(jax.tree.map(np.asarray, p), tc,
                                                   device="cpu")


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("padded", [False, True], ids=["full_mask", "mask_with_zeros"])
def test_encode_matches_reference_f32(pooling, padded):
    jc, tc, p, model = _carried(dict(BCFG_KW, pooling=pooling))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    if padded:
        mask[:, 8:] = 0
        mask[1, 3:] = 0
    want = np.asarray(JB.encode(p, jnp.asarray(toks), jnp.asarray(mask), jc))
    got = B.encode(model, toks, mask)
    assert got.dtype == torch.float32 and got.shape == (4, jc.embed_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(model(toks, mask), got)


def test_encode_normalised_and_mask_sensitive():
    """tests/test_models_other.py:196 on the port: unit rows, and a mask
    with zeros moves mean-pooled embeddings (as the reference's)."""
    jc, tc, p, model = _carried(BCFG_KW)
    toks = np.random.default_rng(2).integers(0, 128, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    emb = B.encode(model, toks, mask).numpy()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-4)
    mask2 = mask.copy()
    mask2[:, 8:] = 0
    emb2 = B.encode(model, toks, mask2).numpy()
    assert float(np.abs(emb - emb2).max()) > 1e-4
    want2 = np.asarray(JB.encode(p, jnp.asarray(toks), jnp.asarray(mask2), jc))
    np.testing.assert_allclose(emb2, want2, **TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_encode_matches_reference_bf16(pooling, param_dtype):
    """A 2-layer bf16-compute config, with f32 parameters (the default) and
    with bf16 ones carried by their bits: cosine >= 0.999 on every row (the
    card's bar). Measured on these inputs, lowest cosine and largest
    |delta| (mean, CLS): f32 parameters 0.99998 / 2.7e-3, 0.99995 / 3.7e-3;
    bf16 parameters 0.99998 / 1.9e-3, 0.99992 / 4.3e-3. |delta| is held to
    1e-2."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256, embed_dim=64,
              max_len=32, compute_dtype="bfloat16", remat=False, pooling=pooling,
              param_dtype=param_dtype)
    jc, tc, p, model = _carried(kw, seed=3)
    toks = np.random.default_rng(4).integers(0, 256, (8, 24)).astype(np.int32)
    mask = np.ones((8, 24), np.int32)
    mask[:, 20:] = 0
    want = np.asarray(JB.encode(p, jnp.asarray(toks), jnp.asarray(mask), jc))
    got = B.encode(model, toks, mask).numpy()
    assert _cos_rows(want, got).min() >= 0.999
    assert np.abs(want - got).max() <= 1e-2
    assert model.embed.dtype == model.layers[0]["mlp"]["w1"]["w"].dtype == T.torch_dtype(
        param_dtype)


def test_encode_rejects_sequences_past_max_len():
    _, tc, _, model = _carried(BCFG_KW)
    B.encode(model, np.zeros((2, tc.max_len), np.int32), np.ones((2, tc.max_len)))
    with pytest.raises(ValueError, match="max_len"):
        B.encode(model, np.zeros((2, tc.max_len + 1), np.int32),
                 np.ones((2, tc.max_len + 1)))


def test_with_config_shares_parameters():
    _, tc, _, model = _carried(BCFG_KW)
    other = model.with_config(dataclasses.replace(tc, compute_dtype="bfloat16"))
    assert other.embed is model.embed and other.layers[0] is model.layers[0]
    assert other.cfg.compute_dtype == "bfloat16" and model.cfg.compute_dtype == "float32"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_init_matches_reference_tree_and_scales():
    kw = dict(n_layers=3, d_model=96, n_heads=4, d_ff=384, vocab=1000, embed_dim=80,
              max_len=64)
    jc, tc = JB.BiEncoderConfig(**kw), B.BiEncoderConfig(**kw)
    ref = jax.tree.map(np.asarray, JB.init_biencoder(KEY, jc))
    model = B.init_biencoder(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    got = model.state_dict()
    want = {}
    for k, v in _flat(ref).items():
        if k.startswith("layers."):
            for i in range(tc.n_layers):
                want[k.replace("layers.", f"layers.{i}.", 1)] = v[i]
        else:
            want[k] = v
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        if k.endswith(("norm.scale", "norm.bias")):
            np.testing.assert_array_equal(g, w)
        else:
            # both draw N(0, 1) times the same scale: stds agree to sampling
            # error (>= 7,680 draws each: within 5 %)
            assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())
            assert abs(g.mean()) < 4 * w.std() / np.sqrt(w.size)
    assert np.isclose(got["embed"].std().item(), 0.02, rtol=0.02)
    assert np.isclose(got["layers.0.mlp.w2.w"].std().item(), 1 / np.sqrt(384), rtol=0.05)
    assert sum(t.numel() for t in model.parameters()) == sum(
        v.size for v in jax.tree.leaves(ref))
    assert not any(t.requires_grad for t in model.parameters())


def test_init_is_deterministic_per_seed():
    cfg = B.BiEncoderConfig(**BCFG_KW)

    def sd(seed):
        m = B.init_biencoder(cfg, generator=torch.Generator().manual_seed(seed),
                             device="cpu")
        return m.state_dict()

    a, b, c = sd(5), sd(5), sd(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert not torch.equal(a["layers.1.attn.wq.w"], c["layers.1.attn.wq.w"])


def test_carried_weights_round_trip_to_the_reference_tree():
    _, tc, p, model = _carried(SYSTEM_KW, seed=4)
    back = _jax_tree(model)
    for (kp, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(p),
                                    jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(kp))


# ---------------------------------------------------------------------------
# the slice as a whole: tests/test_system.py's trained encoder, carried across
# ---------------------------------------------------------------------------

SYSTEM_CFG = JB.BiEncoderConfig(**SYSTEM_KW)


@pytest.fixture(scope="module")
def trained_encoder():
    """tests/test_system.py:24-42: 30 JAX steps of contrastive training."""
    params = JB.init_biencoder(jax.random.PRNGKey(0), SYSTEM_CFG)
    opt = adamw_init(params)

    def _step(p, o, b):
        loss, g = jax.value_and_grad(JB.contrastive_loss)(p, b, SYSTEM_CFG)
        p, o = adamw_update(g, o, p, jnp.float32(3e-4))
        return p, o, loss

    step = jax.jit(_step)
    losses = []
    for t in range(30):
        b = {k: jnp.asarray(v) for k, v in
             jtokens.pair_batch(0, t, batch=32, seq_len=16, vocab=256).items()}
        params, opt, loss = step(params, opt, b)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    return params


def _system_tokens(n_docs=600, seq_len=16):
    """tests/test_system.py::_encode_corpus's tokens: 600 docs, 40 queries."""
    docs, queries = [], []
    for i in range(0, n_docs, 64):
        b = tokens.pair_batch(99, i, batch=min(64, n_docs - i), seq_len=seq_len, vocab=256)
        docs.append(b["d_tokens"])
        queries.append(b["q_tokens"])
    return np.concatenate(docs)[:n_docs], np.concatenate(queries)[:40]


def _assert_ids_up_to_near_ties(s_ref, i_ref, s_got, i_got, eps=1e-5):
    k = s_ref.shape[1]
    for b, j in zip(*np.nonzero(i_ref != i_got)):
        assert any(abs(s_ref[b, j] - s_ref[b, jj]) <= eps
                   for jj in (j - 1, j + 1) if 0 <= jj < k) or (
            j == k - 1 and abs(s_got[b, j] - s_ref[b, j]) <= eps), \
            (b, j, s_ref[b, max(j - 1, 0):j + 2], s_got[b, max(j - 1, 0):j + 2])


def _mrr(ids, mean_fn, eval_fn):
    run = {i: list(map(int, ids[i])) for i in range(ids.shape[0])}
    qrels = {i: {i: 1} for i in range(ids.shape[0])}
    return mean_fn(eval_fn(run, qrels, metrics=("MRR@10",)))["MRR@10"]


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["f32", "int8"])
def test_trained_encoder_encode_prune_search_matches_reference(trained_encoder,
                                                                quantize_int8):
    """Encode -> fit -> prune -> search in each package from the same
    trained weights: embeddings at 1e-5, the fits' eigenvalues within 1e-5
    of the largest and their kept subspaces (projectors) within 1e-4,
    top-10 ids equal up to near-ties, MRR@10 within 1e-6."""
    p = trained_encoder
    model = convert.biencoder_from_numpy(jax.tree.map(np.asarray, p),
                                         B.BiEncoderConfig(**SYSTEM_KW), device="cpu")
    d_tok, q_tok = _system_tokens()
    Dj = np.asarray(JB.encode(p, jnp.asarray(d_tok), jnp.ones(d_tok.shape, jnp.int32),
                              SYSTEM_CFG))
    Qj = np.asarray(JB.encode(p, jnp.asarray(q_tok), jnp.ones(q_tok.shape, jnp.int32),
                              SYSTEM_CFG))
    Dt = encode_cli.encode_rows(model, d_tok, 256)
    Qt = encode_cli.encode_rows(model, q_tok, 256)
    np.testing.assert_allclose(Dt.numpy(), Dj, **TOL)
    np.testing.assert_allclose(Qt.numpy(), Qj, **TOL)

    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(Dj))
    tp = StaticPruner(cutoff=0.5).fit(Dt)
    m = tp.kept_dims
    assert m == jp.kept_dims == 32
    lam_j = np.asarray(jp.state.eigenvalues)
    np.testing.assert_allclose(tp.state.eigenvalues.numpy(), lam_j, rtol=0,
                               atol=1e-5 * lam_j[0])
    Wj = np.asarray(jp.state.components)[:, :m]
    Wt = tp.state.components[:, :m].numpy()
    np.testing.assert_allclose(Wt @ Wt.T, Wj @ Wj.T, rtol=0, atol=1e-4)

    jindex = JaxIndex.build(jp.prune_index(jnp.asarray(Dj)), quantize_int8=quantize_int8)
    tindex = DenseIndex.build(tp.prune_index(Dt), quantize_int8=quantize_int8)
    js, ji = (np.asarray(a) for a in jindex.search(jp.transform_queries(jnp.asarray(Qj)),
                                                   k=10))
    ts, ti = (a.numpy() for a in tindex.search(tp.transform_queries(Qt), k=10))
    _assert_ids_up_to_near_ties(js, ji, ts, ti)
    want = _mrr(ji, jax_mean, jax_evaluate_run)
    got = encode_cli.mrr_at_10(torch.from_numpy(ti))
    assert abs(got - want) <= 1e-6
    # the unpruned search: test_system.py asks the trained encoder for > 0.2
    fs, fi = (a.numpy() for a in DenseIndex.build(Dt).search(Qt, k=10))
    js, ji = (np.asarray(a) for a in JaxIndex.build(jnp.asarray(Dj)).search(
        jnp.asarray(Qj), k=10))
    _assert_ids_up_to_near_ties(js, ji, fs, fi)
    assert encode_cli.mrr_at_10(torch.from_numpy(fi)) > 0.2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_encode_cli_matches_reference_pipeline(capsys, monkeypatch, int8):
    """``python -m repro_torch.launch.encode --device cpu`` at a small size
    prints the example's lines, and its MRR@10 equal (within 1e-6) the
    reference's encode -> StaticPruner -> DenseIndex on the same weights.
    Under --quantize-int8 the index is one ``ops.pca_project_quant`` call
    under the two-pass build's scale (bitwise), its rows that build's up to
    one step on a rounding boundary."""
    fused, calls = encode_cli.ops.pca_project_quant, []
    monkeypatch.setattr(encode_cli.ops, "pca_project_quant",
                        lambda *a: calls.append(a) or fused(*a))
    argv = ["--device", "cpu", "--n-docs", "300", "--n-queries", "24", "--seq-len", "12",
            "--seed", "3", "--encode-batch", "128", "--json"] + (["--quantize-int8"] if int8
                                                                 else [])
    res = encode_cli.main(argv)
    assert len(calls) == int8
    if int8:
        two_pass = DenseIndex.build(res.pruned, quantize_int8=True)
        W, mean = res.pruner.projection()
        assert mean is None and torch.equal(res.index.scale, two_pass.scale)
        assert torch.equal(res.index.vectors, fused(res.D, W, two_pass.scale))
        assert int((res.index.vectors.int() - two_pass.vectors.int()).abs().max()) <= 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[biencoder] ") and out[0].endswith("M params")
    assert out[1] == "[encode] corpus of 300 docs"
    assert out[2].startswith("[prune] 128 -> 64 dims (")
    assert out[3] == (f"[serve] MRR@10 full={res.mrr['full']:.4f} "
                      f"pruned={res.mrr['pruned']:.4f}")
    line = json.loads(out[4])
    assert line["n_docs"] == 300 and line["index_dtype"] == (
        "torch.int8" if int8 else "torch.float32")
    assert all(line[k] >= 0 for k in ("encode_s", "fit_s", "prune_s", "build_s", "search_s"))
    assert res.index.dtype == (torch.int8 if int8 else torch.float32)
    assert res.model.cfg == encode_cli.SMALL_CFG

    jc = JB.BiEncoderConfig(**dataclasses.asdict(res.model.cfg))
    p = _jax_tree(res.model)
    d_tok, q_tok = encode_cli.pair_tokens(300, 24, 12, jc.vocab)
    Dj = JB.encode(p, jnp.asarray(d_tok), jnp.ones(d_tok.shape, jnp.int32), jc)
    Qj = JB.encode(p, jnp.asarray(q_tok), jnp.ones(q_tok.shape, jnp.int32), jc)
    np.testing.assert_allclose(res.D.numpy(), np.asarray(Dj), **TOL)
    np.testing.assert_allclose(res.Q.numpy(), np.asarray(Qj), **TOL)
    pruner = JaxPruner(cutoff=0.5).fit(Dj)
    index = JaxIndex.build(pruner.prune_index(Dj), quantize_int8=int8)
    for name, (idx, q) in {"full": (JaxIndex.build(Dj), Qj),
                           "pruned": (index, pruner.transform_queries(Qj))}.items():
        s, ids = (np.asarray(a) for a in idx.search(q, k=10))
        ts, ti = (a.numpy() for a in res.results[name])
        _assert_ids_up_to_near_ties(s, ids, ts, ti)
        assert abs(_mrr(ids, jax_mean, jax_evaluate_run) - res.mrr[name]) <= 1e-6


def test_pair_tokens_are_the_examples():
    """examples/train_biencoder.py:75-81: pair_batch(7, i, batch=64) for
    i = 0, 64, ...; docs cut to n_docs, queries to n_queries."""
    d_tok, q_tok = encode_cli.pair_tokens(150, 70, 10, 2048)
    b = [jtokens.pair_batch(7, i, batch=64, seq_len=10, vocab=2048) for i in (0, 64, 128)]
    np.testing.assert_array_equal(d_tok, np.concatenate([x["d_tokens"] for x in b])[:150])
    np.testing.assert_array_equal(q_tok, np.concatenate([x["q_tokens"] for x in b])[:70])
    with pytest.raises(ValueError, match="queries"):
        encode_cli.pair_tokens(10, 11, 4, 64)


def test_encode_cli_defaults_to_the_card():
    """Without --device the entry point and the init run on the card; with
    no card both raise and name the device instead of quietly using the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="'cuda'"):
        encode_cli.main(["--n-docs", "64", "--n-queries", "4"])
    with pytest.raises(RuntimeError, match="'cuda'"):
        B.init_biencoder(B.BiEncoderConfig(**BCFG_KW), generator=torch.Generator())
    with pytest.raises(RuntimeError, match="'cuda'"):
        convert.biencoder_from_numpy(
            jax.tree.map(np.asarray, JB.init_biencoder(KEY, JB.BiEncoderConfig(**BCFG_KW))),
            B.BiEncoderConfig(**BCFG_KW))
