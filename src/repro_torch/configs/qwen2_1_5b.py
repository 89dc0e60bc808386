"""Qwen2-1.5B — dense decoder, GQA 12/2, QKV bias, tied embeddings.
(a copy of ``repro/configs/qwen2_1_5b.py``, same values.)

[arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="qwen2-1.5b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    norm="rmsnorm", act="silu",
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
    microbatch=4,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen2-1.5b", family="lm", cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        source="arXiv:2407.10671; hf",
        optimizer="adamw",
        notes="12 heads don't divide the 16-wide model axis; fused-QKV dim "
              "(1536) does — rules shard the projection, not the head dim.")


def smoke_cfg() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, qkv_bias=True, tie_embeddings=True,
        compute_dtype="float32", remat=False)
