"""Cost-model fixtures: entry points that impersonate a real serving entry
(same label, same corpus) but spend more than its checked-in budget; each
must turn the cost gate red against ``costs.json`` (counterpart of
``repro/analysis/fixtures/bad_costs.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.dispatch_lints import EntryPoint, serving_entry_points
from repro_torch.core.index import project_queries
from repro_torch.kernels import ops


def _entry(label: str) -> EntryPoint:
    return next(ep for ep in serving_entry_points("cpu") if ep.label == label)


def shadow_copy_entry() -> EntryPoint:
    """The int8 dense entry with a full f32 copy of the index inside the
    search: the same one top-k call, but it streams 4x the bytes.
    ``cost.regression`` on bytes."""
    ep = _entry("DenseIndex.search_projected[int8]")
    idx = ep.index
    W, mean = ep.projection

    def search(q):
        Df = idx.vectors.float() * idx.scale[None, :]            # the shadow copy
        return ops.topk_score(Df, project_queries(q, W, mean=mean).contiguous(), k=10)

    return dataclasses.replace(ep, fn=search)


def extra_dispatch_entry() -> EntryPoint:
    """The f32 dense entry scored in two top-k calls over the two halves of
    the index, then merged. ``cost.regression`` on the exactly gated call
    count."""
    ep = _entry("DenseIndex.search_projected[f32]")
    idx = ep.index
    W, mean = ep.projection

    def search(q):
        qf = project_queries(q, W, mean=mean).contiguous()
        h = idx.n // 2
        a = ops.topk_score(idx.vectors[:h], qf, k=10)
        b = ops.topk_score(idx.vectors[h:], qf, k=10)
        s = torch.cat([a[0], b[0]], 1)
        ids = torch.cat([a[1], b[1] + h], 1)
        top, j = torch.sort(s, dim=1, descending=True, stable=True)
        return top[:, :10], torch.gather(ids, 1, j[:, :10])

    return dataclasses.replace(ep, fn=search)
