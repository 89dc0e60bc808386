"""Bi-encoder for dense retrieval — the paper's embedding model family
(port of the forward of ``repro/models/biencoder.py``).

A bidirectional transformer encoder (BERT-style: ANCE/TAS-B/Contriever are
all 6–12-layer encoders) with mean or CLS pooling, producing d-dim
L2-normalised text embeddings. ``encode`` computes what the reference's
``encode`` computes, step by step and in the same dtypes: the embedding
sum in the parameter dtype, the layers in the compute dtype (scores,
softmax and norms in f32), pooling in f32, the projection in the compute
dtype. As in the reference, attention ignores ``mask``: padded tokens are
attended to, and the mask only weights the mean pooling.

On a CUDA model the forward is plain PyTorch: the reference computes it
outside any Pallas kernel, so its products go to ``torch.matmul`` /
``einsum`` (cuBLAS, bf16 products with f32 accumulation, fp32 scores
without TF32). The contrastive losses wait for the training slice.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
import torch.nn as nn

from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerConfig, _init_layer, _norm
from repro_torch.util import as_tensor, default_device


@dataclasses.dataclass(frozen=True)
class BiEncoderConfig:
    name: str = "biencoder"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    vocab: int = 30522
    embed_dim: int = 768          # output embedding dim (d in the paper)
    max_len: int = 512
    pooling: str = "mean"         # mean (contriever) | cls (tas-b)
    temperature: float = 0.05
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True            # a training option; an inference forward ignores it

    def lm_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            name=self.name, n_layers=self.n_layers, d_model=self.d_model,
            n_heads=self.n_heads, n_kv_heads=self.n_heads, d_ff=self.d_ff,
            vocab=self.vocab, norm="layernorm", act="gelu",
            param_dtype=self.param_dtype, compute_dtype=self.compute_dtype,
            remat=self.remat)

    def param_count(self) -> int:
        """The reference's count: it takes 2d per layer for the two norms
        (their scales) and leaves out the norms' biases and the final norm."""
        lm = self.lm_cfg()
        d = lm.d_model
        per_layer = 4 * d * d + 3 * d * lm.d_ff + 2 * d
        return (lm.n_layers * per_layer + lm.vocab * d
                + self.max_len * d + d * self.embed_dim)


def _module(tree) -> nn.Module:
    """A parameter (sub)tree as modules: tensor leaves -> ``ParameterDict``,
    mappings of subtrees -> ``ModuleDict``; modules pass through."""
    if isinstance(tree, nn.Module):
        return tree
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: L._param(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


class BiEncoder(nn.Module):
    """The encoder's parameters under the reference's tree: ``embed``
    (vocab, d), ``pos_embed`` (max_len, d), ``layers`` (one
    attn_norm / attn / mlp_norm / mlp entry per layer, unstacked),
    ``final_norm`` and ``proj``. ``params`` holds tensors, mappings of
    tensors or modules; modules and ``nn.Parameter``s are shared, not
    copied."""

    def __init__(self, cfg: BiEncoderConfig, params: Mapping):
        super().__init__()
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers given for a "
                             f"{cfg.n_layers}-layer config")
        self.cfg = cfg
        self.embed = L._param(params["embed"])
        self.pos_embed = L._param(params["pos_embed"])
        self.layers = nn.ModuleList([_module(lp) for lp in params["layers"]])
        self.final_norm = _module(params["final_norm"])
        self.proj = _module(params["proj"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def with_config(self, cfg: BiEncoderConfig) -> "BiEncoder":
        """These parameters (shared) under another config of the same
        shapes, e.g. another compute dtype."""
        return BiEncoder(cfg, dict(embed=self.embed, pos_embed=self.pos_embed,
                                   layers=list(self.layers), final_norm=self.final_norm,
                                   proj=self.proj))

    def forward(self, tokens, mask) -> torch.Tensor:
        return encode(self, tokens, mask)


def init_biencoder(cfg: BiEncoderConfig, *, generator: torch.Generator,
                   device=None) -> BiEncoder:
    """The reference's init distributions: N(0, 1) · 0.02 for both
    embeddings, N(0, 1) / sqrt(d_in) for every dense weight, ones / zeros
    for the layer norms. Draws come from ``generator`` on its device, in a
    fixed order, so a seed gives the same weights on the CPU and the card;
    the model then goes to ``device`` (default: the card)."""
    dev = default_device(device)
    lm = cfg.lm_cfg()
    g = generator
    embed = (torch.randn(cfg.vocab, cfg.d_model, generator=g, device=g.device) * 0.02).to(lm.pdt)
    pos = (torch.randn(cfg.max_len, cfg.d_model, generator=g, device=g.device) * 0.02).to(lm.pdt)
    layers = [_init_layer(g, lm) for _ in range(lm.n_layers)]
    model = BiEncoder(cfg, dict(
        embed=embed, pos_embed=pos, layers=layers,
        final_norm=L.init_layernorm(cfg.d_model, lm.pdt, g.device),
        proj=L.init_dense(g, cfg.d_model, cfg.embed_dim, dtype=lm.pdt)))
    return model.to(dev)


def encode(model: BiEncoder, tokens, mask) -> torch.Tensor:
    """tokens, mask: (B, S) -> L2-normalised embeddings (B, embed_dim), f32,
    on the model's device."""
    cfg = model.cfg
    lm = cfg.lm_cfg()
    dev = model.device
    tokens = as_tensor(tokens, dev)
    mask = as_tensor(mask, dev)
    B, S = tokens.shape
    if S > cfg.max_len:
        raise ValueError(f"sequence length {S} exceeds max_len {cfg.max_len}")
    x = (model.embed[tokens.long()] + model.pos_embed[:S][None]).to(lm.cdt)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    normf = _norm(lm)

    for lp in model.layers:
        h, _ = L.apply_attention(
            lp["attn"], normf(lp["attn_norm"], x), positions,
            n_heads=lm.n_heads, n_kv_heads=lm.n_kv_heads, head_dim=lm.hd,
            rope_theta=lm.rope_theta, mode="bidirectional",
            compute_dtype=lm.cdt)
        x = x + h
        x = x + L.apply_mlp(lp["mlp"], normf(lp["mlp_norm"], x),
                            act=lm.act, compute_dtype=lm.cdt)
    x = L.apply_layernorm(model.final_norm, x)

    if cfg.pooling == "cls":
        pooled = x[:, 0]
    else:
        m = mask.float()[..., None]
        pooled = (x.float() * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
    emb = L.apply_dense(model.proj, pooled.to(lm.cdt), lm.cdt)
    emb = emb.float()
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-9)
