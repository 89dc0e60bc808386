"""The transformer's config and layer init (port of part of
``repro/models/transformer.py``): ``TransformerConfig``, ``_init_layer``
for dense layers and ``_norm``. The bi-encoder builds on them. The LM's
forward, prefill and decode wait for the model zoo; an MoE layer waits for
``models/moe.py`` and raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn as nn

from repro_torch.models import layers as L

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


def _init_layer(generator: torch.Generator, cfg: TransformerConfig) -> nn.ModuleDict:
    """One dense layer's parameters, drawn from ``generator`` on its device."""
    if cfg.n_experts:
        raise NotImplementedError("MoE layers (n_experts > 0) wait for the port of "
                                  "models/moe.py")
    g = generator
    return nn.ModuleDict({
        "attn_norm": _init_norm(cfg, g.device),
        "attn": L.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 qkv_bias=cfg.qkv_bias, dtype=cfg.pdt),
        "mlp_norm": _init_norm(cfg, g.device),
        "mlp": L.init_mlp(g, cfg.d_model, cfg.d_ff, dtype=cfg.pdt),
    })


def _norm(cfg):
    return L.apply_rmsnorm if cfg.norm == "rmsnorm" else L.apply_layernorm
