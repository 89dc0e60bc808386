"""Plain PyTorch oracles, one per kernel, mirroring ``repro/kernels/ref.py``.

Each kernel module takes its plain version (what a CPU tensor runs) from
here, except ``pca_project_quant_plain``: the fused epilogue multiplies by
the reciprocal scale as the TPU kernel does, while the oracle here divides,
as the reference's oracle and the default int8 build do. The two may
differ by ±1 on a rounding boundary.

The top-k breaks ties toward the lowest id (the first occurrence, as
``jax.lax.top_k`` does): ``torch.topk`` promises no order among ties, so it
sorts with ``stable=True`` instead.
"""
from __future__ import annotations

import torch


def gram_ref(D: torch.Tensor) -> torch.Tensor:
    Df = D.float()
    return Df.T @ Df


def topk_score_ref(D: torch.Tensor, Q: torch.Tensor, *, k: int,
                   n_valid: int | torch.Tensor | None = None,
                   row_ids: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every row, then one stable sort under (score desc, id asc).

    k pad candidates (-inf, -1) go first, so they win every -inf tie as the
    TPU kernel's initial running list does; a slot left at -inf reports -1.
    ``n_valid`` may be a host int or a 0-d tensor on D's device: it is
    compared with the row ids as a tensor, never read by the host, so the
    search also runs on meta tensors. Outside [0, n] it acts clamped.
    """
    n = D.shape[0]
    B = Q.shape[0]
    s = Q.float() @ D.float().T                                  # (B, n)
    if row_ids is None:
        ids = torch.arange(n, dtype=torch.int64, device=D.device)
        valid = ids < (n if n_valid is None else n_valid)
    else:
        ids = row_ids.to(torch.int64)
        valid = ids >= 0
    s = s.masked_fill(~valid[None, :], float("-inf"))
    s = torch.cat([torch.full((B, k), float("-inf"), device=s.device), s], 1)
    ids = torch.cat([torch.full((k,), -1, dtype=torch.int64, device=s.device),
                     ids])
    if row_ids is not None:
        # ascending ids first, so the stable sort below breaks ties by id
        order = torch.sort(ids, stable=True).indices
        s, ids = s[:, order], ids[order]
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    vals = vals[:, :k]
    out_ids = torch.where(torch.isneginf(vals), -1, ids[idx[:, :k]])
    return vals, out_ids.to(torch.int32)


def pca_project_ref(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return (D.float() @ W.float()).to(D.dtype)


def pca_project_quant_ref(D: torch.Tensor, W: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    t = D.float() @ W.float()
    q = torch.clamp(torch.round(t / torch.clamp_min(scale[None, :], 1e-12)),
                    -127, 127)
    return q.to(torch.int8)


_INT32_LOW = 0x7FFFFFFF
# rows of pages scored at once by ``topk_score_paged_ref`` before a merge:
# bounds its (B, rows) score block and its gathered pages
_PAGED_BLOCK_ROWS = 1 << 17


def _keys(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (score desc, id asc): the float's bits made
    monotone as a signed int32 in the high word, ``0x7FFFFFFF - id`` in the
    low word (the CUDA kernels' order). -0 and +0 tie."""
    b = (s.float() + 0.0).view(torch.int32)
    hi = torch.where(b < 0, b ^ _INT32_LOW, b).to(torch.int64)
    return hi * (1 << 32) + (_INT32_LOW - ids.to(torch.int64))


def _unkeys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = (keys >> 32).to(torch.int32)
    s = torch.where(hi < 0, hi ^ _INT32_LOW, hi).view(torch.float32)
    ids = (_INT32_LOW - (keys & 0xFFFFFFFF)).to(torch.int32)
    return s, ids


def topk_score_paged_ref(pool: torch.Tensor, page_table: torch.Tensor,
                         page_nvalid: torch.Tensor, page_offset: torch.Tensor,
                         lo: int, hi: int, Q: torch.Tensor, *, k: int,
                         tail: torch.Tensor | None = None,
                         page_scale: torch.Tensor | None = None,
                         ids_pool: torch.Tensor | None = None,
                         carry: tuple[torch.Tensor, torch.Tensor] | None = None,
                         finalize: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over logical page slots [lo, hi): a twin of the
    reference's ``_paged_core`` with ``topk_score_paged_pallas``'s
    arguments.

    Slot t's page is ``pool[table[t]]``, or ``tail[table[t] - pool_pages]``
    at or beyond the pool (an entry in neither is masked). Its scale row
    multiplies the query before the product; row r reports
    ``page_offset[t] + r`` and is masked at or beyond ``page_nvalid[t]``,
    or with ``ids_pool`` reports ``ids_pool[t, r]`` and masks negatives.
    ``carry`` seeds the running list. Candidates order as (score desc, id
    asc). Slots left at -inf get id -1 with ``finalize``, else the
    reference's un-clamped pad ids: slot j after c finite slots gets
    -(j - c + 2), so a carry chain reproduces them. Pages are walked in
    blocks of about ``_PAGED_BLOCK_ROWS`` rows with a running merge.
    """
    lo, hi = int(lo), int(hi)
    pool_pages, R, m = pool.shape
    dev = pool.device
    Qf = Q.float()
    B = Qf.shape[0]
    neg = torch.full((B, k), float("-inf"), device=dev)
    run = _keys(neg, torch.zeros((B, k), dtype=torch.int32, device=dev))
    if carry is not None:
        run = _keys(carry[0], carry[1])
    table = page_table.to(torch.int64)
    nv = page_nvalid.to(torch.int64)
    off = page_offset.to(torch.int64)
    n_tail = 0 if tail is None else tail.shape[0]
    step = max(1, _PAGED_BLOCK_ROWS // R)
    iota = torch.arange(R, dtype=torch.int64, device=dev)
    for t0 in range(lo, hi, step):
        t = torch.arange(t0, min(t0 + step, hi), device=dev)
        phys = table[t]
        in_pool = (phys >= 0) & (phys < pool_pages)
        pg = pool[phys.clamp(0, pool_pages - 1)]
        if tail is not None:
            pg = torch.where((phys >= pool_pages)[:, None, None],
                             tail[(phys - pool_pages).clamp(0, n_tail - 1)], pg)
        live = in_pool | ((phys >= pool_pages) & (phys < pool_pages + n_tail))
        pgf = pg.float()                                         # (P, R, m)
        if page_scale is None:
            s = (Qf @ pgf.reshape(-1, m).T).reshape(B, len(t), R)
        else:
            q = Qf[None, :, :] * page_scale[t][:, None, :].float()   # (P, B, m)
            s = torch.bmm(q, pgf.transpose(1, 2)).permute(1, 0, 2)   # (B, P, R)
        if ids_pool is None:
            ids = off[t][:, None] + iota[None, :]
            ok = iota[None, :] < nv[t][:, None]
        else:
            ids = ids_pool[t].to(torch.int64)
            ok = ids >= 0
        ok = ok & live[:, None]
        s = s.masked_fill(~ok[None], float("-inf")).reshape(B, -1)
        keys = _keys(s, ids.reshape(1, -1).expand(B, -1))
        run = torch.topk(torch.cat([run, keys], 1), k, dim=1).values
    scores, ids = _unkeys(run)
    pad = torch.isneginf(scores)
    if finalize:
        ids = torch.where(pad, -1, ids)
    else:
        c = (~pad).sum(1, keepdim=True)
        j = torch.arange(k, device=dev)[None, :]
        ids = torch.where(pad, -(j - c + 2), ids).to(torch.int32)
    return scores, ids.to(torch.int32)
