"""Chaos soak: open-loop Poisson drive against a replicated fleet while a
fault plan kills and restarts a replica mid-drive (port of
``repro/serving/soak.py``).

    python -m repro_torch.serving.soak --seconds 10 --replicas 3 --rate 120
    python -m repro_torch.serving.soak --device cpu      # without a card

The corpus (seed 0), the query ids and the arrivals (``--seed``) come
from explicit numpy generators.

Asserts the robustness invariants the fleet exists for and exits
non-zero on any violation:

  * zero lost accepted replies (every accepted request got exactly one
    terminal payload — ``Router.stats()['lost_accepted'] == 0``);
  * zero misrouted replies (queries are self-retrieval over a unit-norm
    corpus, so every successful reply's top-1 id is checkable);
  * the fleet is healthy again at the end (the killed replica restarted
    and rejoined, no background maintenance errors);
  * a usable success rate under the fault (the kill window may shed or
    time out, visibly — but the fleet must keep answering).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core.pruning import StaticPruner
from repro_torch.core.store import save_index
from repro_torch.launch.serve import _drive_open
from repro_torch.serving.fleet import FaultEvent, FaultPlan, ReplicaSet
from repro_torch.util import default_device


def _unit_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, d)).astype(np.float32)
    return D / np.linalg.norm(D, axis=1, keepdims=True)


def build_fleet(tmp: str, *, n_docs: int, dim: int, replicas: int,
                max_batch: int = 32, max_outstanding: int = 512,
                replica_timeout: float = 5.0,
                device=None) -> tuple[ReplicaSet, np.ndarray]:
    """Unit-norm corpus -> pruned artifact -> fleet on ``device`` (default:
    the card). Query i is corpus row i, so top-1 correctness is exactly
    checkable."""
    dev = default_device(device)
    D = _unit_corpus(n_docs, dim)
    X = torch.from_numpy(D).to(dev)
    pruner = StaticPruner(cutoff=0.5).fit(X)
    save_index(tmp, pruner.build_index(X), pruner=pruner)
    fleet = ReplicaSet(tmp, replicas=replicas, max_batch=max_batch,
                       max_outstanding=max_outstanding,
                       replica_timeout=replica_timeout,
                       probe_queries=D[:16], device=dev)
    return fleet, D


def run_soak(*, seconds: float = 10.0, rate: float = 120.0,
             replicas: int = 3, n_docs: int = 4096, dim: int = 64,
             kill_at: float | None = None,
             restart_at: float | None = None, seed: int = 0,
             device=None) -> dict:
    if kill_at is None:
        kill_at = 0.3 * seconds
    if restart_at is None:
        restart_at = 0.6 * seconds
    n = max(32, int(rate * seconds))
    with tempfile.TemporaryDirectory() as tmp:
        fleet, D = build_fleet(tmp + "/store", n_docs=n_docs, dim=dim,
                               replicas=replicas, device=device)
        try:
            rng = np.random.default_rng(seed)
            qids = rng.integers(0, n_docs, size=n)
            Q = D[qids]
            plan = FaultPlan([FaultEvent(kill_at, "kill", "r1"),
                              FaultEvent(restart_at, "restart", "r1")])
            plan.start(fleet)
            res = _drive_open(fleet, Q, rate=rate, seed=seed, collect=True,
                              tolerate_errors=True, deadline=2.0)
            stats = fleet.stats()
            health = fleet.health()
        finally:
            fleet.close()
    misrouted = 0
    for i, out in enumerate(res.pop("results")):
        if isinstance(out, tuple):
            _, ids = out
            if int(np.asarray(ids)[0]) != int(qids[i]):
                misrouted += 1
    ok_rate = res["n_ok"] / res["n"]
    violations = []
    if stats["lost_accepted"] != 0:
        violations.append(f"lost_accepted={stats['lost_accepted']}")
    if misrouted:
        violations.append(f"misrouted={misrouted}")
    if not health["ok"]:
        violations.append("fleet unhealthy after restart")
    if ok_rate < 0.5:
        violations.append(f"success rate {ok_rate:.2f} < 0.5")
    return {"drive": res, "stats": stats, "health_ok": health["ok"],
            "misrouted": misrouted, "ok_rate": ok_rate,
            "violations": violations}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=120.0)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the fleet's index (default: cuda; "
                         "raises when there is no CUDA device)")
    args = ap.parse_args(argv)
    out = run_soak(seconds=args.seconds, rate=args.rate,
                   replicas=args.replicas, n_docs=args.n_docs,
                   dim=args.dim, seed=args.seed, device=args.device)
    print(json.dumps(out, indent=2, default=str))
    if out["violations"]:
        print(f"[soak] FAIL: {', '.join(out['violations'])}",
              file=sys.stderr)
        sys.exit(1)
    print(f"[soak] ok: {out['drive']['n_ok']}/{out['drive']['n']} replies, "
          f"p99={out['drive']['p99_ms']:.1f}ms, zero lost accepted, "
          f"zero misrouted")


if __name__ == "__main__":
    main()
