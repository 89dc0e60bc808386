"""Bi-encoder for dense retrieval — the paper's embedding model family
(port of ``repro/models/biencoder.py``).

A bidirectional transformer encoder (BERT-style: ANCE/TAS-B/Contriever are
all 6–12-layer encoders) with mean or CLS pooling, producing d-dim
L2-normalised text embeddings. ``encode`` computes what the reference's
``encode`` computes, step by step and in the same dtypes: the embedding
sum in the parameter dtype, the layers in the compute dtype (scores,
softmax and norms in f32), pooling in f32, the projection in the compute
dtype. As in the reference, attention ignores ``mask``: padded tokens are
attended to, and the mask only weights the mean pooling.

Training: ``contrastive_loss`` is the reference's in-batch-negative
InfoNCE, differentiated by autograd (``model.requires_grad_(True)`` turns
the parameters' gradients on; they are made without). With ``cfg.remat``
and gradients enabled, ``encode`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its layer
body); under ``torch.no_grad`` / ``inference_mode`` the forward is the
plain one. ``shard_contrastive_loss`` splits the batch over a
``DeviceMesh`` axis as the reference's ``shard_map`` does.

On a CUDA model the forward and backward are plain PyTorch: the reference
computes them outside any Pallas kernel, so the products go to
``torch.matmul`` / ``einsum`` (cuBLAS, bf16 products with f32
accumulation, fp32 scores without TF32).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerConfig, _init_layer, _norm
from repro_torch.par.mesh import DeviceMesh
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
    remat: bool = True            # recompute each layer in the backward (inference ignores it)

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
        self.layers = nn.ModuleList([L.as_module(lp) for lp in params["layers"]])
        self.final_norm = L.as_module(params["final_norm"])
        self.proj = L.as_module(params["proj"])

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


def init_biencoder(cfg: BiEncoderConfig, *, generator: torch.Generator | None,
                   device=None) -> BiEncoder:
    """The reference's init distributions: N(0, 1) · 0.02 for both
    embeddings, N(0, 1) / sqrt(d_in) for every dense weight, ones / zeros
    for the layer norms. Draws come from ``generator`` on its device, in a
    fixed order, so a seed gives the same weights on the CPU and the card;
    the model then goes to ``device`` (default: the card). Without a
    generator, shapes only: ``device`` must be ``"meta"``."""
    dev = default_device(device)
    lm = cfg.lm_cfg()
    g, gd = generator, L.gen_device(generator)
    embed = (torch.randn(cfg.vocab, cfg.d_model, generator=g, device=gd) * 0.02).to(lm.pdt)
    pos = (torch.randn(cfg.max_len, cfg.d_model, generator=g, device=gd) * 0.02).to(lm.pdt)
    layers = [_init_layer(g, lm) for _ in range(lm.n_layers)]
    model = BiEncoder(cfg, dict(
        embed=embed, pos_embed=pos, layers=layers,
        final_norm=L.init_layernorm(cfg.d_model, lm.pdt, gd),
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
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in model.layers:
        if remat:
            x = checkpoint(_layer, x, lp, positions, lm, use_reentrant=False)
        else:
            x = _layer(x, lp, positions, lm)
    x = L.apply_layernorm(model.final_norm, x)

    if cfg.pooling == "cls":
        pooled = x[:, 0]
    else:
        m = mask.float()[..., None]
        pooled = (x.float() * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
    emb = L.apply_dense(model.proj, pooled.to(lm.cdt), lm.cdt)
    emb = emb.float()
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-9)


def _layer(x: torch.Tensor, lp, positions: torch.Tensor, lm: TransformerConfig) -> torch.Tensor:
    """One encoder layer (the reference's scan body)."""
    normf = _norm(lm)
    h, _ = L.apply_attention(
        lp["attn"], normf(lp["attn_norm"], x), positions,
        n_heads=lm.n_heads, n_kv_heads=lm.n_kv_heads, head_dim=lm.hd,
        rope_theta=lm.rope_theta, mode="bidirectional",
        compute_dtype=lm.cdt)
    x = x + h
    return x + L.apply_mlp(lp["mlp"], normf(lp["mlp_norm"], x),
                           act=lm.act, compute_dtype=lm.cdt)


def _info_nce(q: torch.Tensor, d: torch.Tensor, labels: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """Mean over q's rows of -log softmax(q · dᵀ / T) at each row's label, f32."""
    logp = F.log_softmax((q @ d.T) / temperature, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def contrastive_loss(model: BiEncoder, batch: Mapping) -> torch.Tensor:
    """In-batch-negative InfoNCE. batch: q_tokens/q_mask/d_tokens/d_mask (B, S)."""
    q = encode(model, batch["q_tokens"], batch["q_mask"])
    d = encode(model, batch["d_tokens"], batch["d_mask"])
    labels = torch.arange(q.shape[0], device=q.device)
    return _info_nce(q, d, labels, model.cfg.temperature)


def _axis_slots(mesh: DeviceMesh, axis: str | tuple[str, ...]) -> list[torch.device]:
    """The device of each slot along ``axis`` (several axes flatten in the
    order given), the other axes at their first position: the slots that
    hold distinct row blocks of a batch sharded on ``axis``."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    pos = [mesh.axis_names.index(a) for a in axes]
    sizes = [mesh.shape[i] for i in pos]
    slots = []
    for flat in range(int(np.prod(sizes))):
        at = [0] * len(mesh.shape)
        for i, c in zip(pos, np.unravel_index(flat, sizes)):
            at[i] = int(c)
        slots.append(mesh.devices[tuple(at)])
    return slots


def contrastive_loss_sharded(model: BiEncoder, batch: Mapping, mesh: DeviceMesh,
                             axis: str | tuple[str, ...] = "data") -> torch.Tensor:
    """InfoNCE with the (B, B) logit matrix split over the slots of ``axis``.

    Slot ``idx`` takes rows [idx·b, (idx + 1)·b) of every batch entry
    (entries other than the tokens and masks ride along unused) and
    encodes them; the documents are gathered to the first slot; each slot
    scores its queries against all of them with labels ``idx·b + arange(b)``,
    and the loss is the mean of the slot means (the reference's ``pmean``).
    One process over the mesh, no collective; every slot must sit on the
    model's device (a replica per device waits for ``par/sharding.py``).
    """
    slots = _axis_slots(mesh, axis)
    n = len(slots)
    B = batch["q_tokens"].shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split over {n} slots of {axis!r}")
    if any(dev != model.device for dev in slots):
        raise ValueError(f"a slot of {axis!r} is not on the model's device {model.device}: "
                         f"a replica per device waits for par/sharding.py")
    b = B // n
    rows = [{k: batch[k][i * b:(i + 1) * b] for k in ("q_tokens", "q_mask", "d_tokens", "d_mask")}
            for i in range(n)]
    qs = [encode(model, r["q_tokens"], r["q_mask"]) for r in rows]
    d_all = torch.cat([encode(model, r["d_tokens"], r["d_mask"]) for r in rows])
    arange = torch.arange(b, device=model.device)
    return torch.stack([_info_nce(q, d_all, idx * b + arange, model.cfg.temperature)
                        for idx, q in enumerate(qs)]).mean()


# the reference's shard_map wrapper: here the one process is the wrapper
shard_contrastive_loss = contrastive_loss_sharded
