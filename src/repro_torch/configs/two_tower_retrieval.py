"""Two-tower retrieval — sampled-softmax dual encoder. [Yi et al., RecSys'19]
(a copy of ``repro/configs/two_tower_retrieval.py``, same values.)

embed_dim 256, tower MLP 1024-512-256, dot scoring. The ``retrieval_cand``
shape (1 query vs 10^6 candidates) is the paper's exact dense-retrieval
setting: the candidate index is built offline from the item tower and is
PCA-prunable via ``repro_torch.core.StaticPruner`` (256 → m dims).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import RecsysConfig

CFG = RecsysConfig(
    name="two-tower-retrieval", kind="two_tower",
    embed_dim=256, tower_mlp=(1024, 512, 256),
    user_vocab=2_097_152, item_vocab=1_048_576,   # 2^21 / 2^20 (shard-even)
    temperature=0.05,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="two-tower-retrieval", family="recsys", cfg=CFG,
        shapes=RECSYS_SHAPES,
        source="RecSys'19 (YouTube two-tower)",
        optimizer="adamw",
        notes="train_batch uses the sharded in-batch sampled softmax "
              "(65k x 65k logits never replicated); retrieval_cand is the "
              "paper's flagship PCA cell.")


def smoke_cfg() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-smoke", kind="two_tower",
        embed_dim=32, tower_mlp=(64, 32), user_vocab=2048, item_vocab=1024)
