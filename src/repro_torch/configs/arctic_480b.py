"""Snowflake Arctic — dense-MoE hybrid: 128 experts top-2 + parallel dense
residual FFN. [hf:Snowflake/snowflake-arctic-base] (a copy of
``repro/configs/arctic_480b.py``, same values.)

Trains with Adafactor + bf16 params: AdamW fp32 state for ~480B params
(7.7 TB) exceeds a 256-chip v5e pod's 4 TB HBM; factored states fit
(the reference's dry-run memory table).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, n_experts=128, top_k=2, dense_residual=True,
    residual_d_ff=4864, sliding_window=None, rope_theta=1e6,
    tie_embeddings=False, norm="rmsnorm", act="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
    moe_group_size=512, microbatch=16, grad_accum_dtype="bfloat16",
    capacity_factor=1.0,  # the reference's: -7% collective vs 1.25 on its pod
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="arctic-480b", family="lm", cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        source="hf:Snowflake/snowflake-arctic-base",
        optimizer="adafactor",
        notes="128 experts = 8/chip on the 16-wide model axis (EP); "
              "dense residual FFN runs TP in parallel.")


def smoke_cfg() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, n_experts=8, top_k=2, dense_residual=True,
        residual_d_ff=96, compute_dtype="float32", remat=False,
        moe_group_size=64)
