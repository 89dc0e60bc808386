"""Finding aggregation: suppression baseline and machine-readable report
(counterpart of ``repro/analysis/report.py``).

The baseline (``baseline.json`` in this package, not the reference's file
at the repository root) is the only sanctioned way to ship code with a
finding: every entry carries the finding's stable key and a reason,
reviewed like code. Keys hold no line numbers; an entry whose key matches
no finding of an analyzer that ran is reported as stale, so the baseline
shrinks as debt is paid.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

from repro_torch.analysis import Finding

SCHEMA = "repro_torch.analysis/v1"


@dataclasses.dataclass(frozen=True)
class Report:
    findings: tuple          # unsuppressed Finding objects
    suppressed: tuple        # (Finding, reason) pairs matched by the baseline
    stale: tuple             # baseline keys that matched nothing

    @property
    def gating(self) -> tuple:
        """Unsuppressed error-severity findings: what fails the gate."""
        return tuple(f for f in self.findings if f.severity == "error")

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "counts": {
                "findings": len(self.findings),
                "gating": len(self.gating),
                "suppressed": len(self.suppressed),
                "stale_suppressions": len(self.stale),
            },
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [dict(reason=r, **f.to_json())
                           for f, r in self.suppressed],
            "stale_suppressions": list(self.stale),
        }


def load_baseline(path: str | Path | None) -> dict[str, str]:
    """key -> reason; a missing file is an empty baseline."""
    if path is None:
        return {}
    p = Path(path)
    if not p.exists():
        return {}
    doc = json.loads(p.read_text())
    out = {}
    for entry in doc.get("suppressions", ()):
        key, reason = entry["key"], entry.get("reason", "")
        if key in out:
            raise ValueError(f"duplicate baseline key: {key}")
        out[key] = reason
    return out


#: finding-key prefix -> analyzer that can produce it, for stale scoping
PREFIX_ANALYZERS = {"dispatch.": "dispatch", "budget.": "budget",
                    "conc.": "conc", "cost.": "cost", "inv.": "inv",
                    "locks.": "locks"}


def apply_baseline(findings: Sequence[Finding],
                   baseline: dict[str, str],
                   active_analyzers: Sequence[str] | None = None) -> Report:
    """``active_analyzers`` scopes staleness: with ``--only conc`` a
    ``cost.*`` suppression matches nothing because its analyzer never ran,
    which is no evidence of paid-off debt. ``None`` means every analyzer
    ran. Keys with an unrecognised prefix are always active."""
    kept, suppressed, hit = [], [], set()
    for f in findings:
        if f.key in baseline:
            suppressed.append((f, baseline[f.key]))
            hit.add(f.key)
        else:
            kept.append(f)

    def _active(key: str) -> bool:
        if active_analyzers is None:
            return True
        for prefix, analyzer in PREFIX_ANALYZERS.items():
            if key.startswith(prefix):
                return analyzer in active_analyzers
        return True
    stale = tuple(sorted(k for k in set(baseline) - hit if _active(k)))
    return Report(findings=tuple(kept), suppressed=tuple(suppressed),
                  stale=stale)


def write_report(report: Report, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(report.to_json(), indent=2,
                                     sort_keys=True) + "\n")


def format_text(report: Report) -> str:
    lines = []
    for f in report.findings:
        lines.append(f"[{f.severity}] {f.key}\n    {f.message}")
    for f, reason in report.suppressed:
        lines.append(f"[suppressed] {f.key}\n    baseline: {reason}")
    for key in report.stale:
        lines.append(f"[stale-suppression] {key}\n    baseline entry no "
                     f"longer matches any finding — remove it")
    c = report.to_json()["counts"]
    lines.append(f"{c['findings']} finding(s) ({c['gating']} gating), "
                 f"{c['suppressed']} suppressed, "
                 f"{c['stale_suppressions']} stale suppression(s)")
    return "\n".join(lines)
