"""AutoInt — self-attentive feature interaction. [arXiv:1810.11921]
(a copy of ``repro/configs/autoint.py``, same values.)

39 sparse fields (Criteo: 13 bucketised dense + 26 categorical), embed 16,
3 attention layers, 2 heads, d_attn 32.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, round_up
from repro_torch.models.recsys import RecsysConfig

_CRITEO_KAGGLE_CAT = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)
_BUCKETISED_DENSE = (128,) * 13

VOCABS = tuple(round_up(v, 512) for v in _BUCKETISED_DENSE + _CRITEO_KAGGLE_CAT)

CFG = RecsysConfig(
    name="autoint", kind="autoint",
    vocab_sizes=VOCABS, embed_dim=16,
    n_attn_layers=3, n_heads=2, d_attn=32,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="autoint", family="recsys", cfg=CFG,
        shapes=RECSYS_SHAPES,
        source="arXiv:1810.11921",
        optimizer="rowwise")


def smoke_cfg() -> RecsysConfig:
    return RecsysConfig(
        name="autoint-smoke", kind="autoint",
        vocab_sizes=(512, 256, 128, 64, 64, 64), embed_dim=8,
        n_attn_layers=2, n_heads=2, d_attn=8)
