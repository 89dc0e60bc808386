"""DLRM — MLPerf benchmark config (Criteo 1TB). [arXiv:1906.00091]
(a copy of ``repro/configs/dlrm_mlperf.py``, same values.)

13 dense + 26 sparse features, embed_dim 128, bottom MLP 13-512-256-128,
top MLP 1024-1024-512-256-1, dot interaction. Vocab sizes are the Criteo
Terabyte cardinalities used by the MLPerf reference, rounded up to multiples
of 512 so table rows shard evenly on both production meshes (256/512 chips).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, round_up
from repro_torch.models.recsys import RecsysConfig

_CRITEO_TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

VOCABS = tuple(round_up(v, 512) for v in _CRITEO_TB_VOCABS)

CFG = RecsysConfig(
    name="dlrm-mlperf", kind="dlrm",
    vocab_sizes=VOCABS, embed_dim=128, n_dense=13,
    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dlrm-mlperf", family="recsys", cfg=CFG,
        shapes=RECSYS_SHAPES,
        source="arXiv:1906.00091 (MLPerf reference)",
        optimizer="rowwise",   # sparse rowwise-AdaGrad tables (96x memory term)
        notes="~188M embedding rows; tables FSDP-sharded over every mesh axis.")


def smoke_cfg() -> RecsysConfig:
    return RecsysConfig(
        name="dlrm-smoke", kind="dlrm",
        vocab_sizes=(512, 256, 128, 64), embed_dim=16, n_dense=13,
        bot_mlp=(32, 16), top_mlp=(64, 32, 1))
