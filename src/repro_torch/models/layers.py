"""Neural net building blocks (port of ``repro/models/layers.py``).

Conventions, as in the reference:
  * parameters are nested mappings of tensors: here ``nn.ParameterDict``
    leaves under ``nn.ModuleDict`` nodes, so a model holds them as modules
    and its ``state_dict`` keys follow the reference's tree. Init fns take
    an explicit ``torch.Generator`` and draw on its device (no generator:
    the meta device, shapes without memory). Parameters are
    made with ``requires_grad=False``; a trainer turns their gradients on
    (``module.requires_grad_(True)``)
  * weights are (d_in, d_out) and applied as ``x @ w``, so a reference
    tree carries across without a transpose
  * ``compute_dtype`` casts happen at apply time; parameters keep their
    storage dtype
  * attention supports GQA, RoPE, optional QKV bias, causal / bidirectional /
    sliding-window masking, and a KV cache for decode; long sequences take
    the blocked (online-softmax) path, so the (S, S) scores never exist
    beyond one tile

Each function takes the reference's steps in its dtypes: scores, softmax
and norms in f32, products and activations in the compute dtype. GELU is
the reference's tanh form with its constants rounded to the input's dtype
and a rounding after every operation, which ``F.gelu`` does not do: in
bf16 it is bitwise the reference's.
"""
from __future__ import annotations

import math
from typing import Literal

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _param(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter without gradients; a parameter passes through
    (and keeps its ``requires_grad``)."""
    return t if isinstance(t, nn.Parameter) else nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A node of the tree that holds tensors (parameters) and subtrees
    (modules) side by side, as the reference's MoE node holds ``router``
    beside ``w1``; read with ``[key]`` and ``in``."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, _param(v))
            else:
                self.add_module(k, as_module(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def as_module(tree) -> nn.Module:
    """A parameter (sub)tree as modules: tensor leaves -> ``ParameterDict``,
    mappings of subtrees -> ``ModuleDict``, both at once -> ``ParamTree``;
    modules pass through."""
    if isinstance(tree, nn.Module):
        return tree
    tensors = [isinstance(v, torch.Tensor) for v in tree.values()]
    if all(tensors):
        return nn.ParameterDict({k: _param(v) for k, v in tree.items()})
    if not any(tensors):
        return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})
    return ParamTree(tree)


def gen_device(generator: torch.Generator | None) -> torch.device:
    """Where ``generator`` draws; without one, the meta device."""
    return torch.device("meta") if generator is None else generator.device


# ---------------------------------------------------------------------------
# Linear / norms
# ---------------------------------------------------------------------------


def init_dense(generator: torch.Generator | None, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None) -> nn.ParameterDict:
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    dev = gen_device(generator)
    w = torch.randn(d_in, d_out, generator=generator, device=dev) * scale
    p = nn.ParameterDict({"w": _param(w.to(dtype))})
    if bias:
        p["b"] = _param(torch.zeros((d_out,), dtype=dtype, device=dev))
    return p


def apply_dense(p, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    w = p["w"].to(compute_dtype)
    y = x.to(compute_dtype) @ w
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _param(torch.ones((d,), dtype=dtype, device=device))})


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _param(torch.ones((d,), dtype=dtype, device=device)),
                             "bias": _param(torch.zeros((d,), dtype=dtype, device=device))})


def apply_layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions. positions: (...,) int32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs                # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, Dh); cos/sin: (..., S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

MaskMode = Literal["causal", "bidirectional", "sliding"]


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32) -> nn.ModuleDict:
    g = generator
    return nn.ModuleDict({
        "wq": init_dense(g, d_model, n_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wk": init_dense(g, d_model, n_kv_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wv": init_dense(g, d_model, n_kv_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wo": init_dense(g, n_heads * head_dim, d_model, bias=False, dtype=dtype),
    })


_KPAD = 2 ** 30  # sentinel position marking padded key slots


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, mode: MaskMode,
               window: int | None) -> torch.Tensor:
    """Additive mask bias (Q, K) in fp32: 0 allowed, -inf disallowed."""
    ok = (k_pos[None, :] < _KPAD).expand(q_pos.shape[0], k_pos.shape[0])
    if mode in ("causal", "sliding"):
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if mode == "sliding" and window is not None:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, zero - math.inf)


def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by repeating each KV head."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def dense_attention(q, k, v, q_pos, k_pos, mode: MaskMode, window=None, *,
                    keys_padded: bool = True):
    """Reference attention: explicit (Q, K) scores. q: (B,Sq,H,Dh).

    Bidirectional with no padded key slot the bias is all zeros; adding it
    would only turn a -0.0 score into +0.0, which the softmax does not see,
    so ``keys_padded=False`` (the caller vouches that no key position is
    the padded-slot sentinel, as in self-attention over token positions)
    skips that pass over the scores."""
    dh = q.shape[-1]
    n_heads = q.shape[2]
    k = _gqa_expand(k, n_heads)
    v = _gqa_expand(v, n_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(dh)
    if mode != "bidirectional" or keys_padded:
        s = s + _mask_bias(q_pos, k_pos, mode, window)[None, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def blocked_attention(q, k, v, q_pos, k_pos, mode: MaskMode, window=None,
                      q_chunk: int = 1024, k_chunk: int = 1024):
    """Online-softmax attention: scores exist only per (q_chunk, k_chunk) tile.

    The reference's scan over Q tiles and, inside it, over KV tiles, as two
    loops; its padding, finite running-max init and final division."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    k = _gqa_expand(k, H)
    v = _gqa_expand(v, H)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    # pad to tile multiples
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    qpos = F.pad(q_pos, (0, nq * q_chunk - Sq), value=-1)
    kpos = F.pad(k_pos, (0, nk * k_chunk - Sk), value=_KPAD)
    scale = 1.0 / np.sqrt(Dh)

    outs = []
    for i in range(0, nq * q_chunk, q_chunk):
        qt, qpt = qp[:, i:i + q_chunk].float(), qpos[i:i + q_chunk]
        # finite init so fully-masked tiles keep alpha = exp(m - m_new) finite
        m = torch.full((B, H, q_chunk), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, q_chunk, Dh), dtype=torch.float32, device=q.device)
        for j in range(0, nk * k_chunk, k_chunk):
            kt, vt, kpt = kp[:, j:j + k_chunk], vp[:, j:j + k_chunk], kpos[j:j + k_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kt.float()) * scale
            s = s + _mask_bias(qpt, kpt, mode, window)[None, None]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vt.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                  # (B,qc,H,Dh)
    o = torch.cat(outs, dim=1)
    return o[:, :Sq].to(v.dtype)


def apply_attention(p, x: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_theta: float, mode: MaskMode = "causal",
                    window: int | None = None,
                    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache_positions: torch.Tensor | None = None,
                    compute_dtype=torch.bfloat16,
                    blocked_threshold: int = 8192,
                    q_chunk: int = 1024, k_chunk: int = 1024):
    """Full attention block.

    Without cache: self-attention over x ((B, S, d)) with ``positions`` (S,).
    With cache: decode — x is (B, 1, d) new tokens; cache k/v are
    (B, S_cache, Hkv, Dh); ``cache_positions`` (S_cache,) give each slot's
    absolute position (supports rolling sliding-window buffers).
    Returns (out (B,S,d), (k_all, v_all)).
    """
    B, S, _ = x.shape
    q = apply_dense(p["wq"], x, compute_dtype).reshape(B, S, n_heads, head_dim)
    k = apply_dense(p["wk"], x, compute_dtype).reshape(B, S, n_kv_heads, head_dim)
    v = apply_dense(p["wv"], x, compute_dtype).reshape(B, S, n_kv_heads, head_dim)

    cos, sin = rope_tables(positions, head_dim, rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])

    if kv_cache is not None:
        ck, cv = kv_cache
        k_all = torch.cat([ck.to(k.dtype), k], dim=1)
        v_all = torch.cat([cv.to(v.dtype), v], dim=1)
        k_pos = torch.cat([cache_positions, positions])
    else:
        k_all, v_all, k_pos = k, v, positions

    Sk = k_all.shape[1]
    if max(S, Sk) > blocked_threshold:
        o = blocked_attention(q, k_all, v_all, positions, k_pos, mode, window,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    else:
        # without a cache the keys are the tokens themselves: none is padded
        o = dense_attention(q, k_all, v_all, positions, k_pos, mode, window,
                            keys_padded=kv_cache is not None)
    o = o.reshape(B, S, n_heads * head_dim)
    out = apply_dense(p["wo"], o, compute_dtype)
    return out, (k_all, v_all)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a Python float: a scalar operand then
    acts as the reference's constant cast to the input's dtype."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``): the tanh form, each constant
    in x's dtype and each operation rounded to it."""
    sqrt_2_over_pi = _in_dtype(np.sqrt(2 / np.pi), x.dtype)
    a = _in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(sqrt_2_over_pi * (x + a * x ** 3))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x), with XLA's logistic 1 / (1 + exp(-x))
    and a rounding after each operation (``torch.sigmoid`` and ``F.silu``
    round once: in bf16 they differ from the reference on ~30 % of
    entries)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


_ACTS = {"gelu": gelu, "silu": silu, "relu": torch.relu}


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32) -> nn.ModuleDict:
    g = generator
    p = nn.ModuleDict({"w1": init_dense(g, d_model, d_ff, dtype=dtype),
                       "w2": init_dense(g, d_ff, d_model, dtype=dtype)})
    if gated:
        p["w3"] = init_dense(g, d_model, d_ff, dtype=dtype)
    return p


def apply_mlp(p, x: torch.Tensor, *, act: str = "silu",
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; the port has {sorted(_ACTS)}")
    h = apply_dense(p["w1"], x, compute_dtype)
    a = _ACTS[act](h)
    if "w3" in p:
        a = a * apply_dense(p["w3"], x, compute_dtype)
    return apply_dense(p["w2"], a, compute_dtype)


def init_mlp_stack(generator: torch.Generator | None, dims: tuple[int, ...], *,
                   bias: bool = True, dtype=torch.float32) -> nn.ModuleList:
    """Plain MLP tower (recsys): dims = (in, h1, ..., out); one ``init_dense``
    a layer, a list as the reference's."""
    return nn.ModuleList([init_dense(generator, dims[i], dims[i + 1], bias=bias, dtype=dtype)
                          for i in range(len(dims) - 1)])


def apply_mlp_stack(layers, x: torch.Tensor, *, act: str = "relu",
                    final_act: bool = False, compute_dtype=torch.float32) -> torch.Tensor:
    """Each layer's dense, then ``act`` after every layer but the last (and
    after the last too under ``final_act``)."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}; the port has {sorted(_ACTS)}")
    actfn = _ACTS[act]
    n = len(layers)
    for i, p in enumerate(layers):
        x = apply_dense(p, x, compute_dtype)
        if i < n - 1 or final_act:
            x = actfn(x)
    return x
