"""Rowwise-AdaGrad embedding updates + AdamW for dense params (port of
``repro/optim/rowwise.py``).

Two compounding problems with naive autograd + AdamW on 188M-row tables:

  1. the gather's backward materialises a DENSE vocab×dim gradient: O(vocab)
     memory traffic for a batch touching <0.1 % of rows;
  2. AdamW reads+writes two fp32 moments per PARAMETER.

The industry answer (FBGEMM/TorchRec), as the reference expresses it:

  * embedding rows are gathered OUTSIDE autograd; the loss is
    differentiated w.r.t. the gathered rows, so table grads never exist in
    dense form — per-step grad traffic is O(batch · dim);
  * one AdaGrad accumulator scalar per ROW; updates add into the table in
    place (duplicate ids combined exactly via a sort + segment-sum);
  * everything that isn't a table keeps AdamW.

Every sum over duplicate ids runs in a fixed order: a stable sort, then a
segment sum (``torch.segment_reduce``, which adds each segment's rows one
after another in sorted order, on the card and on the CPU; no float
atomics), so a resumed run replays bitwise. The update writes the table
and the accumulator in place: a 45 GB table is never copied. Only the
unique rows are written (one host sync a table reads their count), each
with one add, so the order of those adds cannot matter; the reference's
padding entries, which add zeros to row 0, are left out: on the card a
sorted scatter would sum tens of thousands of them into that one row one
after another.

``static=True`` (the default on meta tensors, where the count cannot be
read) is the reference's shape-static form instead: every entry is
written, padding entries with exact zeros, so the shapes do not depend on
the data; ``launch.flops`` counts the step that way, as the reference's
jaxpr does.

See ``configs/steps.py::_recsys_rowwise_bundle`` for the step wiring.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowwiseConfig:
    lr_scale: float = 10.0     # AdaGrad wants a larger lr than Adam
    eps: float = 1e-8


def rowwise_init_table(table: torch.Tensor) -> torch.Tensor:
    """Per-row accumulator."""
    return torch.zeros((table.shape[0],), dtype=torch.float32, device=table.device)


def combine_duplicate_rows(idx: torch.Tensor, g_rows: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exactly combine gradient rows with equal ids.

    idx: (n,) int32 (may repeat); g_rows: (n, E).
    Returns (ids (n,), g_combined (n, E), valid (n,)) where only ``valid``
    entries carry a (unique, ascending) id + summed gradient; the rest are
    padding (id 0, zero rows). Equal ids sum in their order in ``idx``.
    """
    n = idx.shape[0]
    order = torch.sort(idx, stable=True).indices
    sid = idx[order]
    g = g_rows[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=idx.device),
                       sid[1:] != sid[:-1]])
    seg = torch.cumsum(first, 0) - 1
    lengths = torch.zeros((n,), dtype=torch.int64, device=idx.device).scatter_add_(
        0, seg, torch.ones_like(seg))
    g_comb = torch.segment_reduce(g, "sum", lengths=lengths, axis=0, unsafe=True)
    # every entry of a segment carries the same id: the scatter's order is moot
    ids = torch.zeros((n,), dtype=idx.dtype, device=idx.device).scatter_(0, seg, sid)
    valid = torch.arange(n, device=idx.device) < seg[-1] + 1
    return ids, g_comb, valid


@torch.no_grad()
def rowwise_adagrad_update(table: torch.Tensor, acc: torch.Tensor, idx: torch.Tensor,
                           g_rows: torch.Tensor, lr,
                           cfg: RowwiseConfig = RowwiseConfig(), *,
                           static: bool | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse rowwise-AdaGrad, in place: touch only the rows in ``idx``.

    table: (V, E); acc: (V,) rowwise state; idx: (n,) touched rows; g_rows:
    (n, E) grads w.r.t. the gathered rows; lr: a float or a 0-d f32 tensor.
    ``table`` and ``acc`` are updated where they lie and returned, in the
    reference's arithmetic on its valid entries (its padding entries add
    exact zeros). ``static`` (default: on meta tensors) keeps the padding
    entries, masked, as the reference does: no host sync, static shapes.
    """
    ids, g, valid = combine_duplicate_rows(idx, g_rows.float())
    if static is None:
        static = table.device.type == "meta"
    if static:
        ids, keep = ids.long(), valid.float()
    else:
        n_rows = int(valid.sum())
        ids, g, keep = ids[:n_rows].long(), g[:n_rows], None
    row_g2 = (g ** 2).mean(dim=-1)
    if keep is not None:
        row_g2 = row_g2 * keep
    acc_new_rows = acc[ids] + row_g2
    acc.index_add_(0, ids, row_g2)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=table.device)
    scale = (lr * cfg.lr_scale) * torch.rsqrt(acc_new_rows + cfg.eps)
    delta = scale[:, None] * g
    if keep is not None:
        delta = delta * keep[:, None]
    table.index_add_(0, ids, -delta.to(table.dtype))
    return table, acc
