"""Per-query cost model over the port's serving entry points (counterpart
of ``repro/analysis/cost_model.py``).

The paper's trade is static: prune dimensions once, serve cheaper for
ever. So the quantity worth gating is the one pruning changes, bytes and
FLOPs a query. Every entry point of ``dispatch_lints.serving_entry_points()``
is run once under a ``Probe`` and priced:

  * **a kernel call** (a top-k entry) by its operands and outputs: each
    operand read once at its storage width, each output written once, and
    2·B·rows·m FLOPs (a paged walk: the pages of its slots only);
  * **every other aten op** through ``launch/flops.py``'s ``op_cost``: the
    FLOPs it counts, and operand and result bytes for its memory ops; a
    copy-like op whose output exceeds one strip (65,536 rows x m) also
    costs twice its output's bytes, a write and a read back: the
    reference's shadow-copy rule, so an f32 copy of an int8 index shows;
  * **arithmetic intensity**: FLOPs over bytes.

Entry points whose host stages pages (the host tier) are not priced: their
staging is host work, not device traffic. Costs are gated against
``costs.json`` in this package: dispatches exactly, FLOPs and bytes within
10 % (regression = error, an improvement past it = warn: re-baseline),
intensity within 15 % (warn). Then the model is cross-checked against
measured batch times (``bench_crosscheck``): within a family (dense,
sharded), the entry the model says moves fewer bytes a query must be the
faster one, else ``cost.bench-mismatch`` warns. The measured file is the
one ``chip_smoke.py`` phase 18 writes (``build/analysis/measured.json``:
ms a batch and B per entry label, with the card's name and power limit);
with no such file the cross-check is skipped, as the reference skips a
missing bench.

Re-baseline after an intentional change with
``python -m repro_torch.analysis --device cpu --write-cost-baseline``.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.analysis import COSTS_PATH, Finding
from repro_torch.analysis.dispatch_lints import EntryPoint, run_probed, strip_elems

COSTS_SCHEMA = "repro_torch.analysis/costs-v1"
MEASURED_SCHEMA = "repro_torch.analysis/measured-v1"
DEFAULT_MEASURED = "build/analysis/measured.json"

# the reference's tolerances: exact for dispatches, relative otherwise
METRIC_TOL = {
    "flops_per_query": 0.10,
    "hbm_read_bytes_per_query": 0.10,
    "hbm_write_bytes_per_query": 0.10,
}
INTENSITY_TOL = 0.15
METRIC_KEYS = ("dispatches", "flops_per_query", "hbm_read_bytes_per_query",
               "hbm_write_bytes_per_query", "arithmetic_intensity")


def measure_entry(ep: EntryPoint) -> dict:
    """Price one entry point: one probed search."""
    dev = next(t.device.type for t in ep.args)
    probe = run_probed(ep.fn, ep.args, device=dev, costs=True,
                       strip_elems=strip_elems(ep.corpus_shape, ep.strip_rows))
    B = max(1, ep.batch)
    read_q, write_q = probe.reads / B, probe.writes / B
    total = read_q + write_q
    return {
        "device_count": None,
        "dispatches": probe.kernel_calls,
        "flops_per_query": probe.flops / B,
        "hbm_read_bytes_per_query": read_q,
        "hbm_write_bytes_per_query": write_q,
        "arithmetic_intensity": (probe.flops / B) / total if total else 0.0,
        "family": ep.family,
        "bench_key": ep.bench_key,
    }


def measure_all(entries=None, device: str = "cpu") -> dict[str, dict]:
    if entries is None:
        from repro_torch.analysis.dispatch_lints import serving_entry_points
        entries = serving_entry_points(device)
    return {ep.label: measure_entry(ep) for ep in entries if ep.priced}


# ---------------------------------------------------------------------------
# baseline file
# ---------------------------------------------------------------------------


def check_costs_schema(doc: dict) -> None:
    """Validate ``costs.json`` before it gates anything (or is written):
    SystemExit naming what is missing."""
    if not isinstance(doc, dict) or doc.get("schema") != COSTS_SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else type(doc).__name__
        raise SystemExit(f"costs.json schema: expected '{COSTS_SCHEMA}', got {got!r}")
    entries = doc.get("entries")
    if not isinstance(entries, dict) or not entries:
        raise SystemExit("costs.json schema: missing or empty 'entries' section")
    for label, row in entries.items():
        if not isinstance(row, dict):
            raise SystemExit(f"costs.json: entry '{label}' is not an object")
        missing = [k for k in (*METRIC_KEYS, "device_count", "family", "bench_key")
                   if k not in row]
        if missing:
            raise SystemExit(f"costs.json: entry '{label}' missing keys {missing}")
        bad = [k for k in METRIC_KEYS if not isinstance(row[k], (int, float))]
        if bad:
            raise SystemExit(f"costs.json: entry '{label}' has non-numeric metrics {bad}")


def write_baseline(path, measured: dict[str, dict]) -> None:
    doc = {
        "schema": COSTS_SCHEMA,
        "_comment": ("Per-query static cost baseline over the port's serving entry "
                     "points (src/repro_torch/analysis/cost_model.py). Regenerate "
                     "after an intentional change with: python -m repro_torch.analysis "
                     "--device cpu --write-cost-baseline"),
        "entries": {label: dict(row) for label, row in sorted(measured.items())},
    }
    check_costs_schema(doc)
    pathlib.Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def compare_costs(measured: dict[str, dict], baseline_doc: dict | None,
                  costs_path=COSTS_PATH) -> list[Finding]:
    if not baseline_doc:
        return [Finding(
            check="cost.no-baseline", where=str(costs_path),
            message=(f"no cost baseline at {costs_path}: run 'python -m "
                     f"repro_torch.analysis --device cpu --write-cost-baseline' and "
                     f"commit the file"))]
    check_costs_schema(baseline_doc)
    base = baseline_doc["entries"]
    findings: list[Finding] = []
    for label in sorted(set(base) - set(measured)):
        findings.append(Finding(
            check="cost.stale-entry", where=label,
            message=(f"cost baseline entry '{label}' matches no entry point: it was "
                     f"removed or renamed; re-baseline to drop it")))
    for label, row in sorted(measured.items()):
        if label not in base:
            findings.append(Finding(
                check="cost.unbaselined", where=label,
                message=(f"{label}: no cost baseline entry; a new serving entry point "
                         f"must be priced and committed (--write-cost-baseline)")))
            continue
        want = base[label]
        if row["dispatches"] != want["dispatches"]:
            findings.append(Finding(
                check="cost.regression", where=f"{label}:dispatches",
                message=(f"{label}: {row['dispatches']} kernel calls vs baseline "
                         f"{want['dispatches']}: the call count is gated exactly")))
        for metric, tol in METRIC_TOL.items():
            got, ref = float(row[metric]), float(want[metric])
            if ref <= 0:
                continue
            rel = (got - ref) / ref
            if rel > tol:
                findings.append(Finding(
                    check="cost.regression", where=f"{label}:{metric}",
                    message=(f"{label}: {metric} {got:,.0f} is {rel * 100:.1f}% above "
                             f"baseline {ref:,.0f} (tolerance {tol * 100:.0f}%): the "
                             f"static pruning win is being spent")))
            elif rel < -tol:
                findings.append(Finding(
                    check="cost.improved", where=f"{label}:{metric}",
                    message=(f"{label}: {metric} {got:,.0f} is {-rel * 100:.1f}% below "
                             f"baseline {ref:,.0f}: re-baseline to lock it in"),
                    severity="warn"))
        got_i, ref_i = float(row["arithmetic_intensity"]), float(want["arithmetic_intensity"])
        if ref_i > 0 and abs(got_i - ref_i) / ref_i > INTENSITY_TOL:
            findings.append(Finding(
                check="cost.intensity-drift", where=f"{label}:arithmetic_intensity",
                message=(f"{label}: arithmetic intensity {got_i:.2f} drifted "
                         f">{INTENSITY_TOL * 100:.0f}% from baseline {ref_i:.2f}"),
                severity="warn"))
    return findings


# ---------------------------------------------------------------------------
# measured cross-check
# ---------------------------------------------------------------------------


def bench_crosscheck(entries: dict[str, dict], measured_doc: dict | None) -> list[Finding]:
    """Predicted bytes a query against measured ms a query.

    Within one family (dense, sharded) the search is bound by the bytes it
    streams, so the entry the model says moves fewer bytes a query must be
    the faster one on the card. Disagreement warns: the model misprices
    something, or the kernel is off its roofline (the int8 top-k, bound by
    its multiply-adds, ROADMAP queue 2 item 1(a)). ``entries`` should be
    the checked-in baseline (artifact against artifact); measured rows
    have the same shape."""
    if not measured_doc:
        return []
    rows = measured_doc.get("entries") or {}

    def ms_per_query(key):
        row = rows.get(key) or {}
        if row.get("ms") is None or not row.get("B"):
            return None
        return float(row["ms"]) / float(row["B"])

    by_key = {row["bench_key"]: (label, row)
              for label, row in entries.items() if row.get("bench_key")}
    fams: dict[str, list[str]] = {}
    for key, (_label, row) in by_key.items():
        fams.setdefault(row["family"], []).append(key)
    where = (f" on {measured_doc.get('device')}, {measured_doc.get('power_limit')}"
             if measured_doc.get("device") else "")
    findings: list[Finding] = []
    for _fam, keys in sorted(fams.items()):
        keys = sorted(keys)
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                ta, tb = ms_per_query(a), ms_per_query(b)
                if ta is None or tb is None or ta == tb:
                    continue
                ra, rb = by_key[a][1], by_key[b][1]
                bytes_a = ra["hbm_read_bytes_per_query"] + ra["hbm_write_bytes_per_query"]
                bytes_b = rb["hbm_read_bytes_per_query"] + rb["hbm_write_bytes_per_query"]
                if bytes_a == bytes_b:
                    continue
                model_faster = a if bytes_a < bytes_b else b
                bench_faster = a if ta < tb else b
                if model_faster != bench_faster:
                    findings.append(Finding(
                        check="cost.bench-mismatch", where=f"{a}-vs-{b}",
                        message=(f"cost model predicts {model_faster} faster "
                                 f"({min(bytes_a, bytes_b):,.0f} vs "
                                 f"{max(bytes_a, bytes_b):,.0f} bytes/q) but the "
                                 f"measured file has {bench_faster} faster "
                                 f"({min(ta, tb) * 1e3:.1f} vs {max(ta, tb) * 1e3:.1f} "
                                 f"us/q{where}): the kernel is off its byte roofline"),
                        severity="warn"))
    return findings


def write_measured(path, entries: dict[str, dict], *, device: str, power_limit: str) -> None:
    """``entries``: label -> {"ms": ms a batch, "B": queries a batch, ...}."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"schema": MEASURED_SCHEMA, "device": device,
                             "power_limit": power_limit, "entries": entries},
                            indent=2, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# CLI entry
# ---------------------------------------------------------------------------


def run(costs_path=COSTS_PATH, measured_path=DEFAULT_MEASURED,
        device: str = "cpu") -> list[Finding]:
    measured = measure_all(device=device)
    baseline_doc = None
    p = pathlib.Path(costs_path)
    if p.exists():
        baseline_doc = json.loads(p.read_text())
    findings = compare_costs(measured, baseline_doc, costs_path=costs_path)
    measured_doc = None
    if measured_path is not None and pathlib.Path(measured_path).exists():
        measured_doc = json.loads(pathlib.Path(measured_path).read_text())
        if measured_doc.get("schema") != MEASURED_SCHEMA:
            raise SystemExit(f"{measured_path}: expected schema {MEASURED_SCHEMA}, "
                             f"got {measured_doc.get('schema')!r}")
    findings += bench_crosscheck(baseline_doc["entries"] if baseline_doc else measured,
                                 measured_doc)
    return findings
