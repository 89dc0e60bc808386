"""Decoder-only LM: dense or MoE, GQA, RoPE, optional sliding window (port of
``repro/models/transformer.py``).

``LM`` holds the parameters under the reference's tree with the layers
unstacked (``layers.3.attn.wq.w``; the reference stacks them on a leading
L axis and scans, ``convert.lm_from_numpy`` / ``lm_to_numpy`` carry a tree
across). Each function takes the reference's steps in its dtypes.

Step functions:
  * ``forward_train``  — causal LM loss over (B, S) tokens, the loss
                         streamed over sequence chunks
  * ``prefill``        — last-position logits + the stacked KV cache
  * ``decode_step``    — one token against a static cache (slot i holds
                         position i), written in place
  * ``decode_step_sliding`` — one token against a rolling window buffer

``remat`` recomputes each layer in the backward (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` of its scan body) when gradients are on;
each loss chunk is always recomputed, as the reference's chunk scan is.
``act_sharding`` is kept so the configs carry across field for field; the
port places no activation (one process, no collective).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L, moe as M
from repro_torch.util import as_tensor, default_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names ("float32", "bfloat16", "float16")."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    vocab: int = 1024
    head_dim: int | None = None          # default d_model // n_heads
    # MoE (n_experts=0 → dense)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 256
    dense_residual: bool = False         # Arctic: parallel dense FFN + MoE
    residual_d_ff: int | None = None     # d_ff of the parallel dense branch
    moe_dp_dim: str = "ff"               # which expert dim FSDP-shards: ff|d_model
    # attention
    sliding_window: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # self-attention switches to the online-softmax blocked path above this
    # seq len
    blocked_attn_threshold: int = 2048
    attn_q_chunk: int = 1024
    attn_k_chunk: int = 1024
    # misc
    tie_embeddings: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: str = "silu"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    aux_loss_weight: float = 0.01
    # training-step shape: gradient-accumulation microbatches + accum dtype
    microbatch: int = 1
    grad_accum_dtype: str = "float32"
    # parallelism policy: "2d" = FSDP×TP rules; "dp_only" = replicate params
    parallelism: str = "2d"
    # activation sharding anchor of the reference (a JAX NamedSharding);
    # kept so the configs carry across field for field
    act_sharding: object = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdt(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.n_experts:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            if self.dense_residual:
                ffn += 3 * d * (self.residual_d_ff or self.d_ff)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active


def _init_norm(cfg: TransformerConfig, device) -> nn.ParameterDict:
    init = L.init_rmsnorm if cfg.norm == "rmsnorm" else L.init_layernorm
    return init(cfg.d_model, cfg.pdt, device)


def _init_layer(generator: torch.Generator | None, cfg: TransformerConfig) -> nn.ModuleDict:
    """One layer's parameters, drawn from ``generator`` on its device (none:
    shapes on the meta device)."""
    g, gd = generator, L.gen_device(generator)
    p = nn.ModuleDict({
        "attn_norm": _init_norm(cfg, gd),
        "attn": L.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 qkv_bias=cfg.qkv_bias, dtype=cfg.pdt),
        "mlp_norm": _init_norm(cfg, gd),
    })
    if cfg.n_experts:
        p["moe"] = M.init_moe(g, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype=cfg.pdt)
        if cfg.dense_residual:
            p["mlp"] = L.init_mlp(g, cfg.d_model, cfg.residual_d_ff or cfg.d_ff, dtype=cfg.pdt)
    else:
        p["mlp"] = L.init_mlp(g, cfg.d_model, cfg.d_ff, dtype=cfg.pdt)
    return p


class LM(nn.Module):
    """A decoder LM's parameters under the reference's tree: ``embed`` (V, d),
    ``layers`` (one attn_norm / attn / mlp_norm / mlp and/or moe entry per
    layer, unstacked), ``final_norm``, and ``unembed`` (V, d) unless the
    embeddings are tied. ``params`` holds tensors, mappings of tensors or
    modules; modules and ``nn.Parameter``s are shared, not copied."""

    def __init__(self, cfg: TransformerConfig, params):
        super().__init__()
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers given for a "
                             f"{cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = L._param(params["embed"])
        self.layers = nn.ModuleList([L.as_module(lp) for lp in params["layers"]])
        self.final_norm = L.as_module(params["final_norm"])
        if not cfg.tie_embeddings:
            self.unembed = L._param(params["unembed"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def table(self) -> torch.Tensor:
        """The output projection's (V, d) table: the embedding when tied."""
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def with_config(self, cfg: TransformerConfig) -> "LM":
        """These parameters (shared) under another config of the same
        shapes, e.g. another compute dtype."""
        p = dict(embed=self.embed, layers=list(self.layers), final_norm=self.final_norm)
        if not self.cfg.tie_embeddings:
            p["unembed"] = self.unembed
        return LM(cfg, p)

    def forward(self, tokens, labels) -> torch.Tensor:
        return forward_train(self, tokens, labels)


def init_lm(cfg: TransformerConfig, *, generator: torch.Generator | None,
            device=None) -> LM:
    """The reference's init distributions: N(0, 1) · 0.02 for the embedding
    tables, N(0, 1) / sqrt(d_in) for every dense and expert weight, ones for
    the RMS norms (zeros for layer-norm biases and QKV biases). Draws come
    from ``generator`` on its device in a fixed order, layer by layer, each
    tensor drawn f32 and cast to ``param_dtype`` alone (a full-width model
    never holds an f32 copy of itself); the model then goes to ``device``
    (default: the card). Without a generator, shapes only: ``device`` must be
    ``"meta"``."""
    dev = default_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError(f"init_lm without a generator makes shapes on 'meta', not {dev}")
    g, gd = generator, L.gen_device(generator)

    def table():
        return (torch.randn(cfg.vocab, cfg.d_model, generator=g, device=gd) * 0.02).to(cfg.pdt)

    p = {"embed": table(),
         "layers": [_init_layer(g, cfg) for _ in range(cfg.n_layers)],
         "final_norm": _init_norm(cfg, gd)}
    if not cfg.tie_embeddings:
        p["unembed"] = table()
    return LM(cfg, p).to(dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _norm(cfg):
    return L.apply_rmsnorm if cfg.norm == "rmsnorm" else L.apply_layernorm


def _ffn(cfg: TransformerConfig, lp, xn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's feed-forward half on the normed input: the dense MLP, or
    the MoE (plus Arctic's parallel dense residual); and the MoE aux loss."""
    if cfg.n_experts:
        mo, aux = M.apply_moe(lp["moe"], xn, n_experts=cfg.n_experts, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              group_size=cfg.moe_group_size, act=cfg.act,
                              compute_dtype=cfg.cdt)
        if cfg.dense_residual:
            mo = mo + L.apply_mlp(lp["mlp"], xn, act=cfg.act, compute_dtype=cfg.cdt)
        return mo, aux
    mo = L.apply_mlp(lp["mlp"], xn, act=cfg.act, compute_dtype=cfg.cdt)
    return mo, torch.zeros((), dtype=torch.float32, device=xn.device)


def _layer_fwd(cfg: TransformerConfig, lp, x: torch.Tensor, positions: torch.Tensor):
    """One layer over the whole sequence: (x, aux, (k, v))."""
    normf = _norm(cfg)
    h, new_kv = L.apply_attention(
        lp["attn"], normf(lp["attn_norm"], x), positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, mode="sliding" if cfg.sliding_window else "causal",
        window=cfg.sliding_window, compute_dtype=cfg.cdt,
        blocked_threshold=cfg.blocked_attn_threshold,
        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    x = x + h
    mo, aux = _ffn(cfg, lp, normf(lp["mlp_norm"], x))
    return x + mo, aux, new_kv


def _train_layer(x, lp, positions, cfg):
    x, aux, _ = _layer_fwd(cfg, lp, x, positions)
    return x, aux


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.long()].to(model.cfg.cdt)


def _unembed(model: LM, x: torch.Tensor) -> torch.Tensor:
    cdt = model.cfg.cdt
    return torch.einsum("bsd,vd->bsv", x, model.table.to(cdt)).float()


def forward_hidden(model: LM, tokens) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) -> final hidden states (B, S, d) + total aux loss."""
    cfg = model.cfg
    tokens = as_tensor(tokens, model.device)
    S = tokens.shape[1]
    x = _embed(model, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in model.layers:
        if remat:
            x, a = checkpoint(_train_layer, x, lp, positions, cfg, use_reentrant=False)
        else:
            x, a = _train_layer(x, lp, positions, cfg)
        aux = aux + a
    return _norm(cfg)(model.final_norm, x), aux


def _chunk_loss(xc: torch.Tensor, lc: torch.Tensor, table: torch.Tensor):
    """(sum of the next-token NLL over labels >= 0, their count) of one chunk."""
    logits = torch.einsum("bsd,vd->bsv", xc, table).float()
    valid = lc >= 0
    lab = torch.clamp_min(lc, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    return torch.sum(nll * valid), valid.sum()


def forward_train(model: LM, tokens, labels, loss_chunk: int = 2048) -> torch.Tensor:
    """Causal LM loss (mean xent over non-negative labels) + MoE aux.

    The (B, S, V) logits are the step's memory peak at scale, so the loss
    streams over sequence chunks of ``loss_chunk`` positions, each
    recomputed in the backward: only one (B, loss_chunk, V) slice is live.
    """
    cfg = model.cfg
    labels = as_tensor(labels, model.device)
    x, aux = forward_hidden(model, tokens)
    S = x.shape[1]
    table = model.table.to(cfg.cdt)
    nchunk = max(1, S // min(loss_chunk, S))
    if S % nchunk:
        raise ValueError(f"sequence length {S} does not split into {nchunk} loss chunks")
    c = S // nchunk
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    grads = torch.is_grad_enabled()
    for i in range(nchunk):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if grads:
            s, n = checkpoint(_chunk_loss, xc, lc, table, use_reentrant=False)
        else:
            s, n = _chunk_loss(xc, lc, table)
        tot, cnt = tot + s, cnt + n
    loss = tot / torch.clamp_min(cnt, 1)
    return loss + cfg.aux_loss_weight * aux / max(cfg.n_layers, 1)


@torch.no_grad()
def prefill(model: LM, tokens, cache_len: int | None = None):
    """Process a prompt; returns (last-position logits (B, V) f32, (k, v)).

    Cache layout, the reference's: (L, B, S_cache, Hkv, Dh) per k / v in
    the compute dtype; ``cache_len`` > S preallocates decode capacity
    (static-cache serving: slot i == absolute position i), the slots past
    S zero. Each layer writes its keys and values into the cache as it
    goes, so no second copy of it is made."""
    cfg = model.cfg
    tokens = as_tensor(tokens, model.device)
    B, S = tokens.shape
    x = _embed(model, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    C = max(cache_len or S, S)
    shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.hd)
    ck = torch.zeros(shape, dtype=cfg.cdt, device=x.device)
    cv = torch.zeros(shape, dtype=cfg.cdt, device=x.device)
    for i, lp in enumerate(model.layers):
        x, _, (k, v) = _layer_fwd(cfg, lp, x, positions)
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    x = _norm(cfg)(model.final_norm, x)
    return _unembed(model, x[:, -1:, :])[:, 0], (ck, cv)


def _decode(model: LM, kv_cache, next_token, pos, slot, cache_positions: torch.Tensor,
            mode: str):
    """One token at absolute position ``pos`` whose keys and values go to
    cache slot ``slot`` (in place); attention sees each slot at its
    ``cache_positions`` entry (``L._KPAD``: masked). ``pos`` and ``slot``
    are 0-d tensors on the cache's device (``_pos_tensor``)."""
    cfg = model.cfg
    ck_all, cv_all = kv_cache
    next_token = as_tensor(next_token, model.device)
    B = next_token.shape[0]
    x = _embed(model, next_token[:, None])
    positions = pos.reshape(1).to(torch.int32)
    slot_idx = slot.reshape(1)
    cos, sin = L.rope_tables(positions, cfg.hd, cfg.rope_theta)
    normf = _norm(cfg)
    for i, lp in enumerate(model.layers):
        ck, cv = ck_all[i], cv_all[i]
        h = normf(lp["attn_norm"], x)
        att = lp["attn"]
        q = L.apply_dense(att["wq"], h, cfg.cdt).reshape(B, 1, cfg.n_heads, cfg.hd)
        k = L.apply_dense(att["wk"], h, cfg.cdt).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        v = L.apply_dense(att["wv"], h, cfg.cdt).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
        q = L.apply_rope(q, cos[None], sin[None])
        k = L.apply_rope(k, cos[None], sin[None])
        ck.index_copy_(1, slot_idx, k.to(ck.dtype))
        cv.index_copy_(1, slot_idx, v.to(cv.dtype))
        o = L.dense_attention(q, ck, cv, positions, cache_positions, mode, cfg.sliding_window)
        o = o.reshape(B, 1, cfg.n_heads * cfg.hd)
        x = x + L.apply_dense(att["wo"], o, cfg.cdt)
        mo, _ = _ffn(cfg, lp, normf(lp["mlp_norm"], x))
        x = x + mo
    x = _norm(cfg)(model.final_norm, x)
    return _unembed(model, x)[:, 0], kv_cache


def _pos_tensor(pos, cache: torch.Tensor) -> torch.Tensor:
    """``pos`` (an int or a tensor) as a 0-d int64 tensor on the cache's
    device: no shape depends on its value and nothing is read on the host,
    so the step also runs on meta tensors (the dry run counts it). An int
    is written by a fill, not copied from the host: a blocking copy would
    wait for the previous step's kernels."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=cache.device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=cache.device)


@torch.no_grad()
def decode_step(model: LM, kv_cache, next_token, pos):
    """One decode step against a static, preallocated KV cache.

    ``kv_cache``: (k, v) each (L, B, S_max, Hkv, Dh), slot i holding
    absolute position i. ``next_token``: (B,). ``pos``: the new token's
    absolute position; its keys and values are written in place at slot
    ``pos`` and attention sees slots <= pos. Returns (logits (B, V), the
    same cache tensors)."""
    pos = _pos_tensor(pos, kv_cache[0])
    S_max = kv_cache[0].shape[2]
    idx = torch.arange(S_max, dtype=torch.int32, device=kv_cache[0].device)
    # slots strictly after `pos` are masked via a sentinel position
    cache_positions = torch.where(idx <= pos, idx, torch.full_like(idx, L._KPAD))
    mode = "sliding" if model.cfg.sliding_window else "causal"
    return _decode(model, kv_cache, next_token, pos, pos, cache_positions, mode)


@torch.no_grad()
def decode_step_sliding(model: LM, kv_cache, next_token, pos):
    """Decode with a rolling sliding-window buffer of W slots.

    The cache stays (L, B, W, Hkv, Dh): the new token overwrites the oldest
    slot (pos % W), in place. Each slot's absolute position is derived from
    ``pos``; slots not yet written (a derived position < 0) are masked."""
    pos = _pos_tensor(pos, kv_cache[0])
    W = kv_cache[0].shape[2]
    slot = pos % W
    idx = torch.arange(W, dtype=torch.int32, device=kv_cache[0].device)
    cache_pos = torch.where(idx <= slot, pos - slot + idx, pos - W + (idx - slot))
    cache_pos = torch.where(cache_pos >= 0, cache_pos, torch.full_like(cache_pos, L._KPAD))
    return _decode(model, kv_cache, next_token, pos, slot, cache_pos, "sliding")
