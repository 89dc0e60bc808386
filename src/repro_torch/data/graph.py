"""Graph data: synthetic generators + a CSR fanout neighbour sampler (a copy
of ``repro/data/graph.py``; pure numpy, each output bitwise the reference's
for the same seed).

``NeighborSampler`` implements GraphSAGE-style layered fanout sampling over
a CSR adjacency (the ``minibatch_lg`` training regime): seed nodes →
fanout[0] neighbours each → fanout[1] neighbours of those → …, emitted as a
*padded, fixed-shape* subgraph so every training step has the same shapes.
The sampled ids are remapped to local ids by ``np.searchsorted`` on the
sorted unique ids (the reference walks a Python dict: the same ids, a
few hundred thousand lookups fewer a sample at Reddit scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # (N+1,)
    indices: np.ndarray    # (E,)
    n_nodes: int

    @classmethod
    def from_edge_index(cls, edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edge_index
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=dst_s.astype(np.int32), n_nodes=n_nodes)


def random_graph(n_nodes: int, avg_degree: int, seed: int = 0,
                 power_law: bool = True) -> np.ndarray:
    """Random (power-law-ish) edge_index (2, E)."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    if power_law:
        # preferential-attachment flavour via zipf-weighted endpoints
        w = 1.0 / np.arange(1, n_nodes + 1) ** 0.8
        w /= w.sum()
        src = rng.choice(n_nodes, size=n_edges, p=w)
        dst = rng.choice(n_nodes, size=n_edges, p=w)
    else:
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    return np.stack([src, dst]).astype(np.int32)


def batched_molecules(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                      d_edge: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Batch of small graphs as one block-diagonal graph (offset edge ids)."""
    rng = np.random.default_rng(seed)
    nodes = rng.standard_normal((batch * n_nodes, d_feat)).astype(np.float32)
    edges = rng.standard_normal((batch * n_edges, d_edge)).astype(np.float32)
    ei = rng.integers(0, n_nodes, (batch, 2, n_edges)).astype(np.int32)
    offset = (np.arange(batch) * n_nodes)[:, None, None].astype(np.int32)
    edge_index = (ei + offset).transpose(1, 0, 2).reshape(2, -1)
    targets = rng.standard_normal((batch * n_nodes, d_feat)).astype(np.float32)
    return {"nodes": nodes, "edges": edges, "edge_index": edge_index,
            "targets": targets}


class NeighborSampler:
    """Layered fanout sampler producing fixed-shape padded subgraphs."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 batch_nodes: int, seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        # static output sizes
        sizes = [batch_nodes]
        for f in fanouts:
            sizes.append(sizes[-1] * f)
        self.max_nodes = sum(sizes)
        self.max_edges = sum(sizes[i + 1] for i in range(len(fanouts)))

    def sample(self, seeds: np.ndarray | None = None) -> dict[str, np.ndarray]:
        g = self.g
        if seeds is None:
            seeds = self.rng.choice(g.n_nodes, size=self.batch_nodes,
                                    replace=False)
        frontier = seeds.astype(np.int32)
        all_nodes = [frontier]
        src_l, dst_l = [], []
        for f in self.fanouts:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            # sample f neighbours per frontier node (with replacement; deg-0
            # nodes emit self-loops — standard GraphSAGE practice)
            offs = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            nbr = g.indices[np.minimum(g.indptr[frontier, None] + offs,
                                       g.indptr[frontier + 1, None] - 1)]
            nbr = np.where(deg[:, None] > 0, nbr, frontier[:, None])
            src_l.append(nbr.reshape(-1))
            dst_l.append(np.repeat(frontier, f))
            frontier = nbr.reshape(-1).astype(np.int32)
            all_nodes.append(frontier)

        uniq = np.unique(np.concatenate(all_nodes))
        # remap edges into local ids: every id is in ``uniq`` (sorted)
        src_loc = np.searchsorted(uniq, np.concatenate(src_l)).astype(np.int32)
        dst_loc = np.searchsorted(uniq, np.concatenate(dst_l)).astype(np.int32)

        # pad to static shapes
        n_pad = self.max_nodes - len(uniq)
        e_pad = self.max_edges - len(src_loc)
        node_ids = np.pad(uniq.astype(np.int32), (0, max(n_pad, 0)))
        node_mask = np.pad(np.ones(len(uniq), np.float32), (0, max(n_pad, 0)))
        edge_index = np.stack([
            np.pad(src_loc, (0, max(e_pad, 0))),
            np.pad(dst_loc, (0, max(e_pad, 0))),
        ])
        seed_mask = np.zeros(self.max_nodes, np.float32)
        seed_mask[np.searchsorted(uniq, seeds)] = 1.0
        return {"node_ids": node_ids[:self.max_nodes],
                "node_mask": node_mask[:self.max_nodes],
                "edge_index": edge_index[:, :self.max_edges],
                "seed_mask": seed_mask}
