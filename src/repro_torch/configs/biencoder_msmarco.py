"""The paper's own encoder family: a BERT-base-width bi-encoder (a copy of
``repro/configs/biencoder_msmarco.py``, same values).

TAS-B / Contriever / ANCE are all 6-12-layer BERT-family bi-encoders with
d=768 embeddings; this config is the stand-in the encode -> prune -> serve
path runs at full width. ``CFG.param_count()`` is 137,491,968: the gated
MLP's third matrix puts it above BERT-base's ~110M.
"""
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.models.biencoder import BiEncoderConfig

CFG = BiEncoderConfig(
    name="biencoder-msmarco",
    n_layers=12, d_model=768, n_heads=12, d_ff=3072, vocab=30522,
    embed_dim=768, max_len=256, pooling="mean", temperature=0.05,
)

SHAPES = (
    ShapeCell("train_pairs", "train", dict(seq_len=128, global_batch=4096)),
    ShapeCell("encode_corpus", "serve", dict(seq_len=256, global_batch=8192)),
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="biencoder-msmarco", family="biencoder", cfg=CFG,
        shapes=SHAPES,
        source="paper (ANCE/TAS-B/Contriever stand-in)",
        optimizer="adamw")


def smoke_cfg() -> BiEncoderConfig:
    return BiEncoderConfig(
        name="biencoder-smoke", n_layers=2, d_model=64, n_heads=4, d_ff=128,
        vocab=512, embed_dim=64, max_len=32, compute_dtype="float32",
        remat=False)
