"""SmolLM-135M — llama-architecture small model, GQA 9/3.
(a copy of ``repro/configs/smollm_135m.py``, same values.)

[hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, rope_theta=10000.0, tie_embeddings=True,
    norm="rmsnorm", act="silu",
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
    microbatch=4,
    parallelism="dp_only",  # the reference's: 21x step vs TP16 on its pod
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="smollm-135m", family="lm", cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        source="hf:HuggingFaceTB/SmolLM-135M",
        optimizer="adamw",
        notes="9 heads / 576 head-proj (=36·16) — head dim shards only via "
              "the fused projection; vocab and d_ff shard cleanly.")


def smoke_cfg() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-smoke", n_layers=3, d_model=48, n_heads=3, n_kv_heads=3,
        d_ff=128, vocab=512, tie_embeddings=True,
        compute_dtype="float32", remat=False)
