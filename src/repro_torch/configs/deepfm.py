"""DeepFM — FM + deep MLP with shared embeddings. [arXiv:1703.04247]
(a copy of ``repro/configs/deepfm.py``, same values.)

39 sparse fields, embed 10, deep MLP 400-400-400, FM interaction.
"""
from repro_torch.configs.autoint import _BUCKETISED_DENSE, _CRITEO_KAGGLE_CAT
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, round_up
from repro_torch.models.recsys import RecsysConfig

VOCABS = tuple(round_up(v, 512) for v in _BUCKETISED_DENSE + _CRITEO_KAGGLE_CAT)

CFG = RecsysConfig(
    name="deepfm", kind="deepfm",
    vocab_sizes=VOCABS, embed_dim=10,
    deep_mlp=(400, 400, 400),
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="deepfm", family="recsys", cfg=CFG,
        shapes=RECSYS_SHAPES,
        source="arXiv:1703.04247",
        optimizer="rowwise",
        notes="embed_dim 10 doesn't tile the MXU; lookups stay "
              "gather-bound (recorded in roofline).")


def smoke_cfg() -> RecsysConfig:
    return RecsysConfig(
        name="deepfm-smoke", kind="deepfm",
        vocab_sizes=(512, 256, 128, 64, 64), embed_dim=10,
        deep_mlp=(32, 32))
