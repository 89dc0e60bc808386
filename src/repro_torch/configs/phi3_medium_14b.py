"""Phi-3-medium 14B — dense decoder, GQA 40/10, RoPE + SwiGLU.
(a copy of ``repro/configs/phi3_medium_14b.py``, same values.)

[arXiv:2404.14219]
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, rope_theta=10000.0, tie_embeddings=False,
    norm="rmsnorm", act="silu",
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
    microbatch=8,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="phi3-medium-14b", family="lm", cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        source="arXiv:2404.14219",
        optimizer="adamw")


def smoke_cfg() -> TransformerConfig:
    return TransformerConfig(
        name="phi3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, compute_dtype="float32", remat=False)
