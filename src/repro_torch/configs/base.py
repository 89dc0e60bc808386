"""ArchSpec: one architecture + its assigned input-shape set (a copy of
``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input shape) dry-run cell."""

    name: str
    kind: str                   # train | prefill | decode | decode_long |
                                # serve | retrieval | train_sampled
    dims: dict[str, int]
    skip_reason: str | None = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                 # lm | gnn | recsys | biencoder
    cfg: Any
    shapes: tuple[ShapeCell, ...]
    source: str = ""            # provenance: paper/hf reference
    optimizer: str = "adamw"    # adamw | adafactor
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


# -- canonical shape sets ----------------------------------------------------

LM_SHAPES = (
    ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeCell("long_500k", "decode_long", dict(seq_len=524288, global_batch=1)),
)


def lm_shapes(sub_quadratic: bool) -> tuple[ShapeCell, ...]:
    """long_500k runs only for sub-quadratic-attention archs (SWA etc.)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not sub_quadratic:
            out.append(dataclasses.replace(
                s, skip_reason="pure full-attention arch: 500k-token decode "
                "requires sub-quadratic attention (see DESIGN.md §5)"))
        else:
            out.append(s)
    return tuple(out)


def round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", dict(batch=65536)),
    ShapeCell("serve_p99", "serve", dict(batch=512)),
    ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)


GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeCell("minibatch_lg", "train_sampled",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout0=15, fanout1=10, d_feat=602)),
    ShapeCell("ogb_products", "train",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeCell("molecule", "train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=32)),
)
