"""Mixtral 8x7B — MoE decoder, 8 experts top-2, GQA 32/8, SWA 4096.
(a copy of ``repro/configs/mixtral_8x7b.py``, same values.)

[arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, n_experts=8, top_k=2, sliding_window=4096,
    rope_theta=1e6, tie_embeddings=False, norm="rmsnorm", act="silu",
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
    moe_group_size=512, microbatch=8,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="mixtral-8x7b", family="lm", cfg=CFG,
        shapes=lm_shapes(sub_quadratic=True),   # SWA rolling cache => 500k OK
        source="arXiv:2401.04088; hf",
        optimizer="adamw",
        notes="8 experts < 16 model shards: rules fall back to TP-inside-expert.")


def smoke_cfg() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, n_experts=4, top_k=2, sliding_window=32,
        rope_theta=1e6, compute_dtype="float32", remat=False, moe_group_size=64)
