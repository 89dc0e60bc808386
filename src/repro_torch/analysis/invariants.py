"""Value contracts of the port's search pipeline (counterpart of
``repro/analysis/invariants.py``).

The scan, merge and cascade lean on value contracts no type sees: the
shortlist ids reaching the rescore are sorted and duplicate-free, ``-1``
dedup and pad lanes are masked to ``-inf`` before any top-k, ties go to
the lowest id, and segment id offsets partition the global id space. The
reference proves them by abstract interpretation of traced jaxprs. Eager
PyTorch has no jaxpr, so this pass **tests** them instead, which is weaker
than a proof: each entry point runs under ``dispatch_lints.Probe`` on
inputs built to break them, and what its kernel calls were given and
returned is checked.

The inputs: integer corpora (values in [-9, 9], one row of ±127 so every
int8 scale is exactly 1, and duplicated rows so exact ties exist across
segments), integer queries and an identity projection, so every score is
exact in fp32 whatever the sum order and an independent integer oracle
(numpy) gives the exact answer, cascade included. Queries repeat, so the
coarse lists overlap and the shortlist has ``-1`` lanes; the row a ``-1``
lane gathers (row 0 of its segment, by the clamp) is made the best row of
the corpus at full width but absent from the coarse width, so an unmasked
lane would surface.

  * ``inv.rowids-order``: a ``row_ids`` call's non-negative ids are
    ascending (``_shortlist``'s sort, the block-skip guard's contract).
  * ``inv.dedup-tiebreak``: they are duplicate-free, and on exact score
    ties the lowest id wins: an entry point's ids equal the oracle's where
    its scores do.
  * ``inv.sentinel-mask``: no ``-1`` lane (nor any row outside a call's
    ids) surfaces: a result id is one of the call's non-negative ids, or
    ``-1`` at ``-inf``; no entry point returns a ``-1`` with a finite
    score or a score the oracle does not have.
  * ``inv.segment-offsets``: the id intervals of a search's segment
    dispatches are pairwise disjoint: each delta's ``[offset, offset +
    capacity)``, above the base's rows; each rescore part's ``[offset,
    offset + n_valid)``; each paged slot's ``[page_offset, page_offset +
    page_nvalid)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import Finding
from repro_torch.analysis.dispatch_lints import KernelCall, run_probed


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sink_findings(label: str, call: KernelCall) -> list[Finding]:
    """The checks of one ``row_ids`` call: order, then distinctness, then
    that only its own live ids surface."""
    ids = call.kwargs.get("row_ids")
    if ids is None and call.kind == "paged":
        ids = call.kwargs.get("ids_pool")
    if ids is None:
        return []
    rows = _host(ids).reshape(-1)
    live = rows[rows >= 0]
    where = f"{label}:rescore"
    if call.kind == "topk" and np.any(np.diff(live) < 0):
        return [Finding(
            check="inv.rowids-order", where=where,
            message=(f"{label}: the row_ids of a rescore call are not sorted "
                     f"ascending: the shortlist contract (sorted, duplicates set "
                     f"to -1) is broken"))]
    if len(np.unique(live)) != len(live):
        return [Finding(
            check="inv.dedup-tiebreak", where=where,
            message=(f"{label}: row_ids reach the rescore sorted but with repeats: "
                     f"a document is scored twice and the lowest-id keep-first "
                     f"dedup is gone"))]
    s, i = (_host(t) for t in call.out)
    foreign = ~np.isin(i, live) & ~((i == -1) & np.isneginf(s))
    if foreign.any():
        return [Finding(
            check="inv.sentinel-mask", where=where,
            message=(f"{label}: a rescore call returned ids "
                     f"{sorted(set(i[foreign].tolist()))[:4]} that are none of its "
                     f"live row_ids: a -1 lane's row surfaced"))]
    return []


def _intervals(label: str, probe) -> list[Finding]:
    """Disjoint id intervals across a search's segment dispatches."""
    groups: dict[str, list[tuple[int, int]]] = {}
    base_n = None
    for c in probe.markers:
        if c.kind == "delta":
            D, _, _, _, offset = c.args[:5]
            groups.setdefault("delta", []).append((int(offset), int(offset) + D.shape[0]))
        elif c.kind == "rescore":
            offset, n_valid = c.args[4], c.args[5]
            groups.setdefault("rescore", []).append((int(offset), int(offset) + int(n_valid)))
    for c in probe.calls:
        if c.kind == "paged" and c.kwargs.get("ids_pool") is None:
            _, _, nvalid, offset, lo, hi = c.args[:6]
            nv, off = _host(nvalid), _host(offset)
            for t in range(int(lo), int(hi)):
                if nv[t] > 0:
                    groups.setdefault("paged", []).append((int(off[t]), int(off[t] + nv[t])))
        elif base_n is None and c.kind in ("scan", "topk") and "row_ids" not in c.kwargs \
                and "n_valid" not in c.kwargs:
            base_n = int(c.args[0].shape[0])
    findings: list[Finding] = []
    lows = [lo for lo, _ in groups.get("delta", [])]
    if lows and base_n is not None and min(lows) < base_n:
        findings.append(Finding(
            check="inv.segment-offsets", where=f"{label}:delta:base",
            message=(f"{label}: delta segment id offset {min(lows)} overlaps the base "
                     f"rows [0, {base_n}): delta global ids must start past the base")))
    for name, ivs in sorted(groups.items()):
        ivs = sorted(ivs)
        for (alo, ahi), (blo, bhi) in zip(ivs, ivs[1:]):
            if blo < ahi:
                findings.append(Finding(
                    check="inv.segment-offsets", where=f"{label}:{name}:{alo}-{blo}",
                    message=(f"{label}: {name} id intervals [{alo}, {ahi}) and "
                             f"[{blo}, {bhi}) overlap: two documents share a global "
                             f"id, so the cross-segment merge's dedup is wrong")))
                break
    return findings


def _output_findings(label: str, out, oracle) -> list[Finding]:
    s, i = (_host(t) for t in out)
    if np.any((i < 0) & np.isfinite(s)):
        return [Finding(
            check="inv.sentinel-mask", where=f"{label}:result",
            message=(f"{label}: the result holds id -1 at a finite score: a -1 "
                     f"dedup or pad lane was never masked to -inf"))]
    if oracle is None:
        return []
    ws, wi = oracle
    if not np.array_equal(s, ws):
        return [Finding(
            check="inv.sentinel-mask", where=f"{label}:result",
            message=(f"{label}: scores differ from the exact oracle (first query "
                     f"{s[0][:4].tolist()} vs {ws[0][:4].tolist()}): a masked or "
                     f"foreign lane took a place"))]
    if not np.array_equal(i, wi):
        return [Finding(
            check="inv.dedup-tiebreak", where=f"{label}:result",
            message=(f"{label}: equal scores, other ids than the exact oracle's: an "
                     f"exact tie did not go to the lowest id"))]
    return []


def check_entry(label: str, fn, args, oracle=None) -> list[Finding]:
    """Every contract on one entry point run once; ``oracle`` (scores,
    ids) is its exact result where one is known."""
    dev = next(t.device.type for t in args if isinstance(t, torch.Tensor))
    holder = {}

    def run(*a):
        holder["out"] = fn(*a)

    probe = run_probed(run, args, device=dev)
    findings = []
    for c in probe.calls:
        findings += _sink_findings(label, c)
    findings += _intervals(label, probe)
    out = holder["out"]
    if isinstance(out, tuple) and len(out) == 2 and all(
            isinstance(t, torch.Tensor) for t in out):
        findings += _output_findings(label, out, oracle)
    seen, unique = set(), []
    for f in findings:
        if f.key not in seen:
            seen.add(f.key)
            unique.append(f)
    return unique


# ---------------------------------------------------------------------------
# inputs built to break the contracts, and their exact oracle
# ---------------------------------------------------------------------------

N, M, MC, K, B = 400, 16, 8, 10, 6
DELTA_CAP = 64


def _rows(rng, n):
    return rng.integers(-9, 10, size=(n, M)).astype(np.float32)


def _extreme():
    """±127 at the coarse width, -127 past it: every dim's absmax, and a row
    that scores low against the positive queries."""
    row = np.where(np.arange(M) % 2 == 0, 127.0, -127.0).astype(np.float32)
    row[MC:] = -127.0
    return row[None, :]


def tie_corpus(seed: int = 0):
    """(base rows, appended rows, queries): integer rows, ±127 rows opening
    the base and every delta (int8 scales exactly 1), row 0 zero at the
    coarse width and best at full width, and duplicated rows."""
    rng = np.random.default_rng(seed)
    base = _rows(rng, N)
    base[1] = _extreme()
    base[0, :MC] = 0.0
    base[0, MC:] = 127.0
    base[200:220] = base[100:120]                  # exact ties inside the base
    new = _rows(rng, 2 * DELTA_CAP + 6)
    new[0] = new[DELTA_CAP] = _extreme()           # each delta's scale is 1
    new[10:20] = base[100:110]                     # ties across segments
    q = rng.integers(1, 4, size=(B // 2, M)).astype(np.float32)
    return base, new, np.concatenate([q, q])       # repeated queries


def _topk_exact(S: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k of integer scores by (score desc, id asc), (-inf, -1) pads."""
    out_s = np.full((S.shape[0], k), -np.inf, np.float32)
    out_i = np.full((S.shape[0], k), -1, np.int32)
    for b in range(S.shape[0]):
        order = np.lexsort((np.arange(S.shape[1]), -S[b]))[:k]
        out_s[b, :len(order)] = S[b, order]
        out_i[b, :len(order)] = order
    return out_s, out_i


def exact_search(rows: np.ndarray, q: np.ndarray, k: int = K):
    return _topk_exact(q.astype(np.int64) @ rows.astype(np.int64).T, k)


def exact_cascade(rows: np.ndarray, q: np.ndarray, nk: int, k: int = K):
    """The cascade's exact answer: each query's coarse top-nk at the coarse
    width, the batch's union, then the full-width top-k of that union."""
    _, cids = _topk_exact(q[:, :MC].astype(np.int64) @ rows[:, :MC].astype(np.int64).T, nk)
    short = np.unique(cids[cids >= 0])
    S = np.full((q.shape[0], rows.shape[0]), np.iinfo(np.int64).min // 2, np.int64)
    S[:, short] = q.astype(np.int64) @ rows[short].astype(np.int64).T
    s, i = _topk_exact(S, k)
    return s, i


def tie_entry_points(device: str = "cpu"):
    """(label, fn, args, oracle) for every serving entry point, built from
    ``tie_corpus`` with an identity projection."""
    from repro_torch.core.cascade import CascadeIndex
    from repro_torch.core.index import DenseIndex, SegmentedIndex, ShardedDenseIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.par.mesh import make_mesh

    dev = torch.device(device)
    base, new, q = tie_corpus()
    D = torch.from_numpy(base).to(dev)
    Q = torch.from_numpy(q).to(dev)
    W = torch.eye(M, device=dev)
    grown = np.concatenate([base, new])
    full, full_grown = exact_search(base, q), exact_search(grown, q)
    nf = 3
    out = []

    def add(label, index, oracle):
        out.append((label, lambda x, ix=index: ix.search_projected(x, W, k=K), (Q,), oracle))

    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        add(f"DenseIndex.search_projected[{tag}]", DenseIndex.build(D, quantize_int8=int8),
            full)
        add(f"ShardedDenseIndex.search_projected[flat,{tag}]",
            ShardedDenseIndex.build(D, make_mesh((4,), ("data",), device),
                                    quantize_int8=int8), full)
        add(f"ShardedDenseIndex.search_projected[hierarchical,{tag}]",
            ShardedDenseIndex.build(D, make_mesh((2, 2), ("data", "model"), device),
                                    quantize_int8=int8, merge="hierarchical"), full)
        cas = CascadeIndex.build(D, m_coarse=MC, n_factor=nf, quantize_int8=int8)
        add(f"CascadeIndex.search_projected[{tag}]", cas, exact_cascade(base, q, nf * K))
        pg = PagedIndex.from_index(DenseIndex.build(D, quantize_int8=int8), page_rows=64,
                                   seal_rows=128).append(new)
        add(f"PagedIndex.search_projected[{tag}]", pg, full_grown)
    seg = SegmentedIndex.from_index(DenseIndex.build(D, quantize_int8=True),
                                    delta_capacity=DELTA_CAP).append(new)
    add("SegmentedIndex.search_projected[int8]", seg, full_grown)
    cas8 = CascadeIndex.build(D, m_coarse=MC, n_factor=nf, quantize_int8=True)
    grown_cas = exact_cascade(grown, q, nf * K)
    add("CascadeIndex.search_projected[seg,int8]",
        cas8.segmented(delta_capacity=DELTA_CAP).append(new), grown_cas)
    add("CascadeIndex.search_projected[paged,int8]",
        cas8.paged(page_rows=64, seal_rows=128).append(new), grown_cas)
    add("CascadeIndex.search_projected[paged-host,int8]",
        cas8.paged(page_rows=64, seal_rows=128, pool_pages=3, coarse_pool_pages=3,
                   wave_pages=2).append(new), grown_cas)
    return out


def run(device: str = "cpu") -> list[Finding]:
    """Test the contracts on every serving entry point."""
    findings: list[Finding] = []
    for label, fn, args, oracle in tie_entry_points(device):
        findings += check_entry(label, fn, args, oracle)
    return findings
