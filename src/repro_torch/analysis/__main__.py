"""The gate: ``python -m repro_torch.analysis [--fail-on-findings]``
(counterpart of ``python -m repro.analysis``).

Runs the analyzers against the port's code on ``--device`` (the card by
default; without one it raises, as every port entry point does; the tests
and a CPU run pass ``--device cpu``), subtracts the suppression baseline
(``baseline.json`` in this package), writes the machine-readable report
and, with ``--fail-on-findings``, exits 1 on an unsuppressed error finding
or a stale suppression.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu --fail-on-findings
    python -m repro_torch.analysis --fail-on-findings            # on the card
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import BASELINE_PATH, COSTS_PATH

ANALYZERS = ("dispatch", "budget", "conc", "cost", "inv", "locks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--only", default=",".join(ANALYZERS),
                    help=f"comma list of analyzers to run (default: {','.join(ANALYZERS)})")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="where the entry points run (default: the card)")
    ap.add_argument("--baseline", default=str(BASELINE_PATH),
                    help="suppression baseline (missing file = empty)")
    ap.add_argument("--json", default="build/analysis/report.json",
                    help="report output path ('' disables)")
    ap.add_argument("--costs", default=str(COSTS_PATH),
                    help="checked-in cost baseline for the cost analyzer")
    ap.add_argument("--measured", default="build/analysis/measured.json",
                    help="measured batch times for the cost cross-check "
                         "(missing file = cross-check skipped)")
    ap.add_argument("--write-cost-baseline", action="store_true",
                    help="price every entry point and rewrite --costs instead of "
                         "gating against it")
    ap.add_argument("--lock-graph", default=None, metavar="PATH",
                    help="an observed runtime lock graph to cross-check against "
                         "the static acquisition graph")
    ap.add_argument("--lock-graph-out", default=None, metavar="PATH",
                    help="write the static lock graph to PATH")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 on unsuppressed error findings or stale suppressions")
    args = ap.parse_args(argv)

    chosen = [s.strip() for s in args.only.split(",") if s.strip()]
    unknown = set(chosen) - set(ANALYZERS)
    if unknown:
        ap.error(f"unknown analyzer(s): {sorted(unknown)}")
    from repro_torch.util import default_device
    device = default_device(args.device).type

    if args.write_cost_baseline:
        from repro_torch.analysis import cost_model
        cost_model.write_baseline(args.costs, cost_model.measure_all(device=device))
        print(f"[analysis] cost baseline -> {args.costs}")
        return 0

    findings = []
    if "dispatch" in chosen:
        from repro_torch.analysis import dispatch_lints
        findings += dispatch_lints.run(device)
    if "budget" in chosen:
        from repro_torch.analysis import kernel_budget
        findings += kernel_budget.run(device)
    if "conc" in chosen:
        from repro_torch.analysis import concurrency
        findings += concurrency.run()
    if "cost" in chosen:
        from repro_torch.analysis import cost_model
        findings += cost_model.run(costs_path=args.costs, measured_path=args.measured,
                                   device=device)
    if "inv" in chosen:
        from repro_torch.analysis import invariants
        findings += invariants.run(device)
    if "locks" in chosen:
        from repro_torch.analysis import lock_sanitizer
        findings += lock_sanitizer.run(lock_graph_path=args.lock_graph)
        if args.lock_graph_out:
            Path(args.lock_graph_out).write_text(
                json.dumps(lock_sanitizer.static_lock_graph(), indent=1, sort_keys=True)
                + "\n")
            print(f"[analysis] static lock graph -> {args.lock_graph_out}")

    from repro_torch.analysis.report import (apply_baseline, format_text, load_baseline,
                                             write_report)
    report = apply_baseline(findings, load_baseline(args.baseline), active_analyzers=chosen)
    if args.json:
        write_report(report, args.json)
        print(f"[analysis] report -> {args.json}")
    print(format_text(report))
    if args.fail_on_findings and (report.gating or report.stale):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
