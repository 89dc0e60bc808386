"""Static and runtime analysis of the port's serving path: its efficiency
gate (counterpart of ``repro/analysis``, which stays the reference's).

The paper's claim is offline, query-independent efficiency: a pruned or
int8 index streams fewer bytes a query, in its storage dtype, in one fused
call. Nothing in the type system holds that, so each invariant gets an
analyzer here. The ids keep the reference's suffixes under the port's
prefixes (``jaxpr.*`` -> ``dispatch.*``, ``host-callback`` -> ``host-sync``;
``pallas.*`` -> ``budget.*``); ``conc.*``, ``cost.*``, ``inv.*`` and
``locks.*`` are the reference's.

  * ``dispatch_lints`` (``jaxpr_lints``): every serving entry point runs
    under a ``TorchDispatchMode`` and a ``TorchFunctionMode``: the top-k
    calls of one search, no f32 shadow copy of an int8 / bf16 index, no
    host read inside the entry point, and fixed kernel-call shapes across
    a sweep of live counts.
  * ``kernel_budget`` (``pallas_budget``): registers, shared memory and
    spills of every built kernel, the dynamic shared memory each launch
    asks for, grid and alignment; it runs where ``nvcc`` and a card are.
  * ``concurrency``: the reference's AST pass over ``src/repro_torch``,
    with the port's blocking calls.
  * ``cost_model``: dispatches, FLOPs, bytes at storage dtype and
    arithmetic intensity per query of every entry point, gated against
    ``costs.json`` and cross-checked against measured batch times.
  * ``invariants``: the value contracts the kernels rely on (shortlist
    order, sentinel masking, lowest-id ties, disjoint segment ids), held
    by running each entry point on inputs built to break them.
  * ``lock_sanitizer``: handoff deadlocks and a runtime lock-order
    recorder scoped to the port, cross-checked against the static graph.

``python -m repro_torch.analysis`` runs them, subtracts the suppression
baseline (``baseline.json`` beside this file) and, with
``--fail-on-findings``, exits 1 on an unsuppressed error or a stale
suppression. Nothing here imports JAX or the reference package.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BASELINE_PATH = PACKAGE_DIR / "baseline.json"
COSTS_PATH = PACKAGE_DIR / "costs.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit.

    ``check`` is the lint id (``"dispatch.extra-dispatch"``, …); ``where``
    is a stable location key (module:Class.method:field, or an entry
    point's label, never a line number, so the suppression baseline
    survives unrelated edits); ``severity`` is ``"error"`` (gates) or
    ``"warn"`` (reported only).
    """

    check: str
    where: str
    message: str
    severity: str = "error"

    @property
    def key(self) -> str:
        return f"{self.check}:{self.where}"

    def to_json(self) -> dict:
        return dict(check=self.check, where=self.where,
                    message=self.message, severity=self.severity)


__all__ = ["Finding", "BASELINE_PATH", "COSTS_PATH", "PACKAGE_DIR"]
