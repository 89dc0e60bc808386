"""GraphCast — encoder-processor-decoder mesh GNN, 16 MP layers, d=512,
sum aggregation, 227 output variables. [arXiv:2212.12794]
(a copy of ``repro/configs/graphcast.py``, same values.)

The architecture (layer structure, width, aggregator) is GraphCast's; the
four assigned shapes exercise it across graph-size regimes (full-batch
small, sampled minibatch, full-batch 2.4M-node, batched molecules). Input
feature width comes from each shape; output stays n_vars=227 (regression),
matching the arch definition.
"""
from repro_torch.configs.base import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig

N_VARS = 227

CFG = GNNConfig(
    name="graphcast",
    n_layers=16, d_hidden=512, d_in=N_VARS, d_edge_in=4, d_out=N_VARS,
    aggregator="sum", mesh_refinement=6,
    param_dtype="float32", compute_dtype="bfloat16", remat=True,
)


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="graphcast", family="gnn", cfg=CFG,
        shapes=GNN_SHAPES,
        source="arXiv:2212.12794",
        optimizer="adamw",
        notes="d_in is overridden per shape (1433/602/100/32); d_out=227.")


def smoke_cfg() -> GNNConfig:
    return GNNConfig(name="graphcast-smoke", n_layers=3, d_hidden=32, d_in=16,
                     d_edge_in=4, d_out=8, aggregator="sum",
                     compute_dtype="float32", remat=False)
