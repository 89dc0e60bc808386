"""Known-bad fixtures for the port's analyzer self-tests (counterparts of
``repro/analysis/fixtures``).

Each module here breaks exactly one invariant the analyzers exist to
catch; ``tests/test_torch_analysis.py`` holds each to its finding and
nothing else. Nothing in the port imports them.

  * ``bad_jaxpr``: dispatch-contract violations (a shadow upcast, a host
    read, an extra top-k call, call shapes that follow the live count).
  * ``bad_locks``: guarded-field, lock-order and blocking-under-lock
    violations for the concurrency pass (a copy of the reference's).
  * ``bad_costs``: entry points impersonating real serving entries but
    overspending their ``costs.json`` budget.
  * ``bad_invariants``: rescores breaking one value contract each
    (sortedness, dedup, sentinel mask, segment offsets).
  * ``bad_handoff``: a cycle-free producer/consumer handoff deadlock for
    the lock sanitizer (a copy of the reference's).
"""
