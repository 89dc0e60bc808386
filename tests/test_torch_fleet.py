"""The port's replicated serving fleet (``repro_torch.serving.fleet``) on
the CPU, case by case after ``tests/test_fleet.py``: routing, admission
control, failover, health-gated rollouts, auto-compaction and the
fault-injection harness, over port servers, plus the port fleet's replies
against ``repro``'s fleet on the same artifact and the port's chaos soak.

The corpus is unit-norm with self-retrieval queries (query i IS row i),
so every successful reply's top-1 id is exactly checkable — "misrouted"
and "wrong answer" are measured, never inferred. The shared artifact is
written by ``repro`` and served by the port. Waits are bounded as the
reference's are; no test asserts on wall time.
"""
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import StaticPruner as JaxPruner
from repro.core.store import save_index as jax_save_index
from repro.serving.fleet import ReplicaSet as JaxReplicaSet
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.store import IndexStore, save_index
from repro_torch.launch.serve import TimedOut, _drive_open
from repro_torch.serving import soak
from repro_torch.serving.fleet import (AutoCompactPolicy, FaultEvent, FaultPlan,
                                       HealthPolicy, ReplicaSet, Shed,
                                       corrupt_artifact)

N, D_DIM = 384, 64


def _unit_corpus(n=N, d=D_DIM, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, d)).astype(np.float32)
    return D / np.linalg.norm(D, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One committed store for the whole module, written by ``repro``;
    destructive tests copy."""
    D = _unit_corpus()
    pruner = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    path = str(tmp_path_factory.mktemp("fleet") / "v1")
    jax_save_index(path, pruner.build_index(jnp.asarray(D)), pruner=pruner)
    return path, D


@pytest.fixture
def make_fleet(artifact):
    """Factory for fleets over the shared artifact; closes them all."""
    path, D = artifact
    fleets = []

    def build(**kw):
        kw.setdefault("replicas", 3)
        kw.setdefault("probe_queries", D[:8])
        kw.setdefault("max_batch", 16)
        kw.setdefault("device", "cpu")
        fleet = ReplicaSet(path, **kw)
        fleets.append(fleet)
        return fleet, D

    yield build
    for fleet in fleets:
        fleet.close()


def _assert_self_topk(fleet, D, qid):
    _, ids = fleet.query(D[qid])
    assert int(np.asarray(ids)[0]) == qid


# -- routing + accounting ---------------------------------------------------

def test_fleet_completes_all_and_balances(make_fleet):
    fleet, D = make_fleet()
    fleet.query(D[0])                           # warm the dispatch path
    # slow every replica so in-flight counts accumulate: a burst of
    # submits must then spread by least-in-flight, deterministically
    for rep in fleet.replicas:
        rep.faultable.state.inject(("slow", 0.05))
    qids = np.random.default_rng(1).integers(0, N, size=60)
    replies = [fleet.submit(D[q]) for q in qids]
    outs = [r.get(timeout=30.0) for r in replies]
    for q, out in zip(qids, outs):
        assert isinstance(out, tuple), f"reply failed: {out!r}"
        assert int(np.asarray(out[1])[0]) == q
    stats = fleet.stats()
    assert stats["accepted"] == 60 + 1          # +1 warmup query
    assert stats["lost_accepted"] == 0
    assert stats["shed"] == 0
    # replica worker logs prove the load actually spread
    served = [rep.server.worker_stats()["batches"] for rep in fleet.replicas]
    assert all(b > 0 for b in served), served
    for rep in fleet.replicas:
        rep.faultable.state.clear()


def test_admission_control_sheds_explicitly(make_fleet):
    fleet, D = make_fleet(max_outstanding=4, replica_timeout=5.0)
    for rep in fleet.replicas:
        rep.faultable.state.inject(("slow", 0.2))
    replies = [fleet.submit(D[i % N]) for i in range(40)]
    outs = [r.get(timeout=30.0) for r in replies]
    shed = [o for o in outs if isinstance(o, Shed)]
    ok = [o for o in outs if isinstance(o, tuple)]
    assert len(shed) + len(ok) == 40            # every submit got a reply
    assert shed, "a 10x overload over 4 slots must shed"
    stats = fleet.stats()
    assert stats["shed"] == len(shed)
    assert stats["accepted"] == len(ok)
    assert stats["lost_accepted"] == 0
    for rep in fleet.replicas:
        rep.faultable.state.clear()


def test_router_query_raises_shed(make_fleet):
    fleet, D = make_fleet(max_outstanding=1)
    fleet.replicas[0].faultable.state.inject(("slow", 0.3))
    fleet.submit(D[0])                          # occupies the only slot
    with pytest.raises(Shed):
        fleet.query(D[1])
    for rep in fleet.replicas:
        rep.faultable.state.clear()


# -- failover ---------------------------------------------------------------

def test_kill_fails_over_without_losing_replies(make_fleet):
    fleet, D = make_fleet()
    fleet.query(D[0])                           # warm the dispatch path
    fleet.replicas[0].faultable.state.inject("crash")
    qids = np.random.default_rng(2).integers(0, N, size=48)
    outs = [fleet.submit(D[q], deadline=10.0) for q in qids]
    for q, reply in zip(qids, outs):
        out = reply.get(timeout=30.0)
        assert isinstance(out, tuple), f"reply failed: {out!r}"
        assert int(np.asarray(out[1])[0]) == q
    stats = fleet.stats()
    assert stats["lost_accepted"] == 0
    assert "r0" in stats["down"]
    assert stats["marked_down"] >= 1


def test_restart_rejoins_and_serves(make_fleet):
    fleet, D = make_fleet()
    fleet.query(D[0])
    # slow the siblings so a burst actually reaches r1 (a zero-load tie
    # always routes to r0), then crash r1 and let failover mark it down
    for rep in (fleet.replicas[0], fleet.replicas[2]):
        rep.faultable.state.inject(("slow", 0.05))
    fleet.replicas[1].faultable.state.inject("crash")
    qids = np.random.default_rng(8).integers(0, N, size=12)
    outs = [fleet.submit(D[q], deadline=10.0) for q in qids]
    for q, reply in zip(qids, outs):
        out = reply.get(timeout=30.0)
        assert isinstance(out, tuple), f"reply failed: {out!r}"
        assert int(np.asarray(out[1])[0]) == q
    for rep in (fleet.replicas[0], fleet.replicas[2]):
        rep.faultable.state.clear()
    assert fleet.router.states()["r1"] == "down"
    fleet.restart("r1")
    assert fleet.router.states() == {"r0": "up", "r1": "up", "r2": "up"}
    health = fleet.health()
    assert health["ok"]
    assert {"kind": "restart", "replica": "r1"} in health["events"]
    _assert_self_topk(fleet, D, 7)


def test_hung_replica_fails_over_via_deadline(make_fleet):
    fleet, D = make_fleet(replica_timeout=0.5)
    fleet.query(D[0])
    fleet.replicas[2].faultable.state.inject("hang")
    qids = np.random.default_rng(3).integers(0, N, size=24)
    outs = [fleet.submit(D[q], deadline=10.0) for q in qids]
    got = [r.get(timeout=30.0) for r in outs]
    assert all(isinstance(o, tuple) for o in got)
    stats = fleet.stats()
    assert stats["lost_accepted"] == 0
    fleet.replicas[2].faultable.state.clear()


def test_fault_plan_kill_restart_mid_drive(make_fleet):
    fleet, D = make_fleet()
    qids = np.random.default_rng(4).integers(0, N, size=240)
    plan = FaultPlan([FaultEvent(0.4, "kill", "r1"),
                      FaultEvent(1.0, "restart", "r1")])
    plan.start(fleet)
    res = _drive_open(fleet, D[qids], rate=150.0, collect=True,
                      tolerate_errors=True, deadline=2.0)
    stats = fleet.stats()
    assert stats["lost_accepted"] == 0
    misrouted = sum(1 for i, out in enumerate(res["results"])
                    if isinstance(out, tuple)
                    and int(np.asarray(out[1])[0]) != qids[i])
    assert misrouted == 0
    assert res["n_ok"] >= 0.8 * res["n"]
    assert fleet.health()["ok"]                 # r1 restarted and rejoined


# -- rolling rollout --------------------------------------------------------

def _build_artifact(path, D):
    X = torch.from_numpy(np.ascontiguousarray(D))
    pruner = StaticPruner(cutoff=0.5).fit(X)
    save_index(path, pruner.build_index(X), pruner=pruner)
    return path


def test_rollout_good_commits_fleet_wide(make_fleet, tmp_path):
    fleet, D = make_fleet()
    v2 = _build_artifact(str(tmp_path / "v2"), D)
    result = fleet.rollout(v2)
    assert result["ok"] and not result["rolled_back"]
    assert len(result["per_replica"]) == len(fleet.replicas)
    assert all(p["recall"] == 1.0 for p in result["per_replica"])
    assert fleet.version == v2
    assert fleet.router.states() == {"r0": "up", "r1": "up", "r2": "up"}
    _assert_self_topk(fleet, D, 11)


def test_rollout_regression_rolls_back_with_zero_misrouted(make_fleet,
                                                           tmp_path):
    fleet, D = make_fleet()
    v1 = fleet.version
    # same rows, shuffled order: every id the bad index returns is wrong
    perm = np.random.default_rng(5).permutation(N)
    bad = _build_artifact(str(tmp_path / "vbad"), D[perm])
    qids = np.random.default_rng(6).integers(0, N, size=160)
    result = {}
    roller = threading.Thread(
        target=lambda: result.update(fleet.rollout(bad)), daemon=True)
    roller.start()
    res = _drive_open(fleet, D[qids], rate=120.0, collect=True,
                      tolerate_errors=True, deadline=2.0)
    roller.join(timeout=60.0)
    assert result["rolled_back"] and not result["ok"]
    # the health gate must have caught it on the FIRST replica probed —
    # live traffic never reached the regressing index
    assert len(result["per_replica"]) == 1
    misrouted = sum(1 for i, out in enumerate(res["results"])
                    if isinstance(out, tuple)
                    and int(np.asarray(out[1])[0]) != qids[i])
    assert misrouted == 0
    assert fleet.stats()["lost_accepted"] == 0
    assert fleet.version == v1
    assert fleet.router.states() == {"r0": "up", "r1": "up", "r2": "up"}


def test_rollout_rejects_corrupt_artifact_and_keeps_serving(make_fleet,
                                                            tmp_path):
    fleet, D = make_fleet()
    v1 = fleet.version
    bad = _build_artifact(str(tmp_path / "vtorn"), D)
    corrupt_artifact(bad)                       # torn blob: open() must fail
    result = fleet.rollout(bad)
    assert not result["ok"] and not result["rolled_back"]
    assert "rejected" in result["reason"]
    assert fleet.version == v1
    assert not result["per_replica"]            # no replica was touched
    _assert_self_topk(fleet, D, 3)


def test_rollout_rejects_partial_commit_and_keeps_serving(make_fleet,
                                                          tmp_path):
    """Crash mid-rollout publication: an artifact whose manifest never
    landed (the blob-then-manifest-swap was interrupted) must be rejected
    by open() and the fleet keeps serving the previous version."""
    fleet, D = make_fleet()
    v1 = fleet.version
    partial = str(tmp_path / "vpartial")
    _build_artifact(partial, D)
    (tmp_path / "vpartial" / "manifest.json").unlink()
    result = fleet.rollout(partial)
    assert not result["ok"] and not result["rolled_back"]
    assert fleet.version == v1
    _assert_self_topk(fleet, D, 9)


def test_rollout_probes_catch_crashing_replica(make_fleet, tmp_path):
    """A fault during the probe window (not a bad artifact) also rolls
    back: the gate checks the replica actually answers, not just ids."""
    fleet, D = make_fleet(health_policy=HealthPolicy(probes=4,
                                                     timeout_s=2.0))
    v2 = _build_artifact(str(tmp_path / "v2"), D)
    # crash the LAST replica: reference answers still come from a healthy
    # one, and the gate must catch the crash on r2's own probe
    fleet.replicas[2].faultable.state.inject("crash")
    result = fleet.rollout(v2)
    assert result["rolled_back"] and not result["ok"]
    assert not result["per_replica"][-1]["ok"]
    fleet.replicas[2].faultable.state.clear()
    fleet.restart("r2")
    assert fleet.health()["ok"]


# -- maintenance: appends, auto-compaction, health --------------------------

def test_append_visible_on_every_replica(make_fleet):
    fleet, D = make_fleet()
    extra = _unit_corpus(n=32, d=D_DIM, seed=99)
    n0 = fleet.index.n
    fleet.append(extra)
    assert fleet.index.n == n0 + 32
    q = extra[5]
    for rep in fleet.replicas:
        _, ids = rep.server.query(q, timeout=10.0)
        assert int(np.asarray(ids)[0]) == n0 + 5


def test_autocompact_controller_triggers_and_serves(make_fleet):
    fleet, D = make_fleet(
        autocompact=AutoCompactPolicy(max_delta_fraction=0.10,
                                      interval_s=0.1))
    fleet.append(_unit_corpus(n=96, d=D_DIM, seed=7))   # 96/480 = 20%
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and fleet.updater.compactions == 0:
        time.sleep(0.05)
    assert fleet.updater.compactions == 1
    assert len(fleet.index.deltas) == 0
    kinds = [e["kind"] for e in fleet.events]
    assert "autocompact" in kinds
    _assert_self_topk(fleet, D, 21)
    # durably compacted too: a cold reload of the store sees no deltas
    cold = IndexStore.open(fleet.store.path)
    assert all(s.kind == "base" for s in cold.segments())


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fleet_health_surfaces_background_compaction_death(make_fleet,
                                                           monkeypatch):
    """Satellite: a dead compact_async thread must degrade fleet health,
    not vanish (the updater records it, the fleet reads it). The re-raise
    in the background thread is part of the contract (loud death), hence
    the filtered warning."""
    fleet, D = make_fleet()

    def boom(**kw):
        raise RuntimeError("simulated compaction death")

    monkeypatch.setattr(fleet.updater, "compact", boom)
    th = fleet.updater.compact_async()
    th.join(timeout=30.0)
    health = fleet.health()
    assert not health["ok"]
    assert not health["maintenance"]["ok"]
    errs = health["maintenance"]["background_errors"]
    assert errs and "simulated compaction death" in errs[0]["error"]
    # serving itself is unaffected — health is degraded, not the traffic
    _assert_self_topk(fleet, D, 2)


# -- deadlines through the router -------------------------------------------

def test_router_deadline_times_out_hung_fleet(make_fleet):
    fleet, D = make_fleet(replica_timeout=10.0, max_retries=0)
    fleet.query(D[0])
    for rep in fleet.replicas:
        rep.faultable.state.inject("hang")
    out = fleet.submit(D[1], deadline=0.5).get(timeout=30.0)
    assert isinstance(out, TimedOut)
    assert fleet.stats()["lost_accepted"] == 0
    for rep in fleet.replicas:
        rep.faultable.state.clear()


def test_corrupt_artifact_helper_removes_a_live_blob(artifact, tmp_path):
    path, D = artifact
    cp = str(tmp_path / "copy")
    shutil.copytree(path, cp)
    removed = corrupt_artifact(cp)
    assert removed.endswith(".npy")
    with pytest.raises(Exception):
        IndexStore.open(cp)


# -- against the reference's fleet, and the soak ----------------------------

def test_fleet_replies_equal_reference_fleet(make_fleet, artifact):
    """The port's fleet and ``repro``'s, over the same artifact, answer a
    query tape alike: ids equal, scores within rtol = atol = 1e-5."""
    path, D = artifact
    fleet, _ = make_fleet()
    ref = JaxReplicaSet(path, replicas=3, max_batch=16, probe_queries=D[:8])
    try:
        rng = np.random.default_rng(12)
        tape = (D[rng.integers(0, N, 40)]
                + 0.05 * rng.standard_normal((40, D_DIM))).astype(np.float32)
        want = [ref.submit(q).get(timeout=30.0) for q in tape]
        got = [fleet.submit(q).get(timeout=30.0) for q in tape]
    finally:
        ref.close()
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), rtol=1e-5, atol=1e-5)


def test_soak_on_cpu_holds_its_invariants():
    """The chaos soak's kill and restart mid-drive: no accepted reply
    lost, none misrouted, the fleet healthy after."""
    out = soak.run_soak(seconds=2.0, rate=100.0, replicas=3, device="cpu")
    assert out["violations"] == []
    assert out["stats"]["lost_accepted"] == 0 and out["misrouted"] == 0
