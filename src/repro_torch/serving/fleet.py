"""Replicated serving fleet: R RetrievalServer replicas behind one Router
(port of ``repro/serving/fleet.py``).

Topology::

    client -> Router (admission control, least-in-flight dispatch,
              |        retry-with-failover, per-replica health state)
              +-> Replica r0: RetrievalServer over FaultableIndex ----+
              +-> Replica r1: RetrievalServer over FaultableIndex ----+--> one
              +-> Replica r2: RetrievalServer over FaultableIndex ----+   shared
                                                                          index
    ReplicaSet actor thread (the ONLY mutator): appends, compaction,
    rolling index rollout (health-gated, auto-rollback), restarts, and
    the auto-compaction controller.

Every replica serves the SAME logical index version, one set of tensors
on one device (the card by default); the per-replica ``FaultableIndex``
proxy exists so the fault-injection harness can crash/hang/slow one
replica without touching the others. Every replica server runs each batch
shape once (``warmup``) before it takes traffic, at start and at a restart:
on a fresh checkout the first search on the card builds the top-k kernel
with nvcc, which must not meet a replica timeout.

Request lifecycle: ``Router.submit`` either *sheds* (explicit ``Shed``
payload — never a silent drop) when ``max_outstanding`` accepted
requests are already in flight, or accepts and dispatches to the ready
replica with the fewest in-flight requests. A per-replica waiter thread
collects the server reply with a bounded wait; a crash or timeout marks
the replica down and fails the request over to another replica (up to
``max_retries``), and every accepted request ends in exactly ONE
terminal payload — result, ``TimedOut``, ``Shed`` never (it was not
accepted), or an error — so ``stats()['lost_accepted']`` is an invariant
the chaos soak asserts at zero.

Rolling rollout (``ReplicaSet.rollout``): open + validate the new
artifact (a partial/corrupt artifact aborts with the fleet untouched),
record reference answers from the serving fleet, then replica-by-replica
quiesce -> drain -> swap -> probe (recall vs reference, p99, worker
liveness) -> rejoin. Any probe failure swaps every already-swapped
replica back and reports ``rolled_back`` — live traffic is only ever
routed to a replica AFTER its new index passed the probe, so a
recall-regressing rollout serves zero misrouted replies by construction.

Lock discipline (the reference's, checked by the runtime lock sanitizer
of the test suite): ``Router._lock`` is the only lock this module creates, it is
only ever acquired with an empty held-lock stack, and no cross-component
call (``server.submit``, ``reply.resolve``, ``updater.*``) happens while
holding it — state is snapshotted under the lock and acted on outside.
``ReplicaSet`` owns NO locks at all: every mutation is serialised
through its single actor thread via a ``queue.Queue``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from repro_torch.core.index import SegmentedIndex
from repro_torch.core.maintenance import IndexUpdater
from repro_torch.core.store import IndexStore
from repro_torch.launch.serve import Reply, RetrievalServer, TimedOut


class Shed(RuntimeError):
    """Admission control rejected the request: the fleet is at capacity.

    Delivered as an explicit reply payload — load shedding is a visible
    outcome, never a silent drop."""


class ReplicaCrash(RuntimeError):
    """Injected (or real) replica failure surfaced through a reply."""


class NoHealthyReplica(RuntimeError):
    """Dispatch found every replica marked down."""


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

class FaultState:
    """Mutable fault mode shared between a replica's proxy generations.

    ``mode`` is published by plain reference assignment (single writer —
    the injector; readers see either the old or the new mode, both
    valid). ``clear`` releases a pending hang by setting the resume
    event; each new hang gets a FRESH event so cleared hangs don't leak
    into later ones.
    """

    def __init__(self):
        self.mode = None             # None | "crash" | "hang" | ("slow", s)
        self._resume = threading.Event()

    def inject(self, mode) -> None:
        if mode == "hang":
            self._resume = threading.Event()
        self.mode = mode

    def clear(self) -> None:
        self.mode = None
        self._resume.set()

    def apply(self) -> None:
        """Run inside the replica's search call — which executes OUTSIDE
        every server lock (``_dispatch`` snapshots then searches
        unlocked), so a hang parks only this replica's stager."""
        mode = self.mode
        if mode is None:
            return
        if mode == "crash":
            raise ReplicaCrash("injected replica crash")
        if mode == "hang":
            self._resume.wait()
            return
        if isinstance(mode, tuple) and mode[0] == "slow":
            time.sleep(float(mode[1]))


class FaultableIndex:
    """Delegating index proxy that applies the replica's fault mode on
    every search. ``inner`` is rebound on append/compaction swaps (same
    proxy object, read once per search call); rollouts install a fresh
    proxy via ``swap_index`` so (index, projection) stay paired."""

    def __init__(self, inner, state: FaultState | None = None):
        self.inner = inner
        self.state = state if state is not None else FaultState()

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def device(self):
        return self.inner.device

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def nbytes(self) -> int:
        return self.inner.nbytes

    def search(self, queries, k: int = 10, **kw):
        inner = self.inner
        self.state.apply()
        return inner.search(queries, k=k, **kw)

    def search_projected(self, queries, components, k: int = 10, **kw):
        inner = self.inner
        self.state.apply()
        return inner.search_projected(queries, components, k=k, **kw)


def corrupt_artifact(path) -> str:
    """Delete one data blob from an on-disk artifact — simulates a torn
    rollout payload. ``IndexStore.open`` must reject the result."""
    p = Path(path)
    blobs = sorted(p.glob("vectors_*.npy")) or sorted(p.glob("*.npy"))
    if not blobs:
        raise FileNotFoundError(f"no data blobs under {path}")
    blobs[0].unlink()
    return str(blobs[0])


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    at_s: float                 # offset from plan start
    action: str                 # kill | hang | slow | clear | restart | corrupt
    replica: str | None = None
    arg: object = None          # slow: seconds; corrupt: artifact path


@dataclasses.dataclass
class FaultPlan:
    """Timed fault schedule, driven by a daemon injector thread."""

    events: Sequence[FaultEvent]

    def start(self, fleet: "ReplicaSet") -> threading.Thread:
        ordered = sorted(self.events, key=lambda e: e.at_s)

        def _inject():
            t0 = time.perf_counter()
            for ev in ordered:
                delay = ev.at_s - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                fleet.apply_fault(ev)

        th = threading.Thread(target=_inject, daemon=True,
                              name="fault-injector")
        th.start()
        return th


# --------------------------------------------------------------------------
# replicas and routing
# --------------------------------------------------------------------------

class Replica:
    """Plain holder — no locks. ``server``/``faultable`` are rebound by
    the ReplicaSet actor (restart, rollout); readers see a consistent
    reference either way. ``work`` feeds this replica's Router waiter."""

    def __init__(self, name: str, server: RetrievalServer,
                 faultable: FaultableIndex):
        self.name = name
        self.server = server
        self.faultable = faultable
        self.work: queue.Queue = queue.Queue()


class Router:
    """Load-aware front door over a set of replicas.

    One lock (``_lock``) guards the health/load/counter state; it is
    never held across a call into a replica or a reply — pick under the
    lock, dispatch outside it.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 max_outstanding: int = 256,
                 replica_timeout: float = 5.0,
                 max_retries: int = 2):
        self.replicas = tuple(replicas)
        self.max_outstanding = max_outstanding
        self.replica_timeout = replica_timeout
        self.max_retries = max_retries
        self._lock = threading.Lock()
        self._loads = {r.name: 0 for r in replicas}
        self._down: set = set()
        self._outstanding = 0
        self._counters = {"accepted": 0, "shed": 0, "completed": 0,
                          "timed_out": 0, "failed": 0, "failovers": 0,
                          "marked_down": 0}
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._waiter, args=(r,),
                                          daemon=True,
                                          name=f"waiter-{r.name}")
                         for r in replicas]
        for t in self._threads:
            t.start()

    # -- client API ---------------------------------------------------------
    def submit(self, qvec: np.ndarray, deadline: float | None = None) -> Reply:
        """Admit-or-shed, then dispatch. Always returns a Reply that will
        carry exactly one terminal payload."""
        abs_dl = (None if deadline is None
                  else time.perf_counter() + deadline)
        reply = Reply(deadline=abs_dl)
        with self._lock:
            shed = self._outstanding >= self.max_outstanding
            if shed:
                self._counters["shed"] += 1
            else:
                self._outstanding += 1
                self._counters["accepted"] += 1
        if shed:
            reply.resolve(Shed(
                f"fleet at capacity ({self.max_outstanding} outstanding)"),
                time.perf_counter())
            return reply
        self._dispatch(qvec, reply, attempts=0)
        return reply

    def query(self, qvec: np.ndarray, timeout: float = 30.0,
              deadline: float | None = None):
        out = self.submit(qvec, deadline=deadline).get(timeout=timeout)
        if isinstance(out, BaseException):
            raise out
        return out

    def reset_stats(self) -> None:
        with self._lock:
            self._counters = dict.fromkeys(self._counters, 0)
        for rep in self.replicas:
            if rep.server.error is None:
                rep.server.reset_stats()

    # -- health / introspection --------------------------------------------
    def quiesce(self, name: str) -> None:
        """Stop routing NEW work to ``name`` (maintenance or failure)."""
        with self._lock:
            self._down.add(name)

    def revive(self, name: str) -> None:
        with self._lock:
            self._down.discard(name)

    def loads(self) -> dict:
        with self._lock:
            return dict(self._loads)

    def states(self) -> dict:
        with self._lock:
            return {name: ("down" if name in self._down else "up")
                    for name in self._loads}

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["outstanding"] = self._outstanding
            out["loads"] = dict(self._loads)
            out["down"] = sorted(self._down)
            # droplessness invariant: every accepted request must end in
            # exactly one terminal payload — once outstanding drains to
            # zero, any residue here is a silently dropped reply
            out["lost_accepted"] = (out["accepted"] - out["completed"]
                                    - out["timed_out"] - out["failed"]
                                    - out["outstanding"])
        return out

    def close(self) -> None:
        self._stop.set()
        for rep in self.replicas:
            rep.work.put(None)
        for t in self._threads:
            t.join(timeout=10.0)

    # -- dispatch internals -------------------------------------------------
    def _pick(self) -> Replica | None:
        with self._lock:
            up = [r for r in self.replicas if r.name not in self._down]
            if not up:
                return None
            rep = min(up, key=lambda r: self._loads[r.name])
            self._loads[rep.name] += 1
        return rep

    def _unload(self, name: str) -> None:
        with self._lock:
            # clamp: items dispatched before a restart may drain after
            # the load counter was rebuilt
            self._loads[name] = max(0, self._loads[name] - 1)

    def _mark_down(self, name: str) -> None:
        with self._lock:
            if name not in self._down:
                self._down.add(name)
                self._counters["marked_down"] += 1

    def _dispatch(self, qvec, reply: Reply, attempts: int) -> None:
        rep = self._pick()
        if rep is None:
            self._finish(reply, NoHealthyReplica("every replica is down"))
            return
        now = time.perf_counter()
        budget = self.replica_timeout
        if reply.deadline is not None:
            budget = min(budget, max(0.01, reply.deadline - now))
        try:
            srv_reply = rep.server.submit(qvec, deadline=budget)
        except Exception as e:   # crashed or invalid replica: fail over
            self._unload(rep.name)
            self._mark_down(rep.name)
            self._retry(qvec, reply, attempts, e)
            return
        rep.work.put((reply, srv_reply, qvec, attempts, now + budget))

    def _retry(self, qvec, reply: Reply, attempts: int,
               cause: BaseException) -> None:
        with self._lock:
            self._counters["failovers"] += 1
        now = time.perf_counter()
        if (attempts + 1 > self.max_retries
                or (reply.deadline is not None and reply.deadline <= now)):
            self._finish(reply, cause)
            return
        self._dispatch(qvec, reply, attempts + 1)

    def _finish(self, reply: Reply, payload, t: float | None = None) -> None:
        """Deliver the terminal payload (outside every lock), then account
        for it. Called exactly once per accepted request."""
        reply.resolve(payload, time.perf_counter() if t is None else t)
        with self._lock:
            self._outstanding -= 1
            if isinstance(payload, TimedOut):
                self._counters["timed_out"] += 1
            elif isinstance(payload, BaseException):
                self._counters["failed"] += 1
            else:
                self._counters["completed"] += 1

    def _waiter(self, rep: Replica) -> None:
        """Collect server replies for one replica with BOUNDED waits; a
        timeout or crash marks the replica down and fails the request
        over. Items carry their own absolute wait limit, so a wedged
        head-of-line item does not serialise the timeouts behind it."""
        while True:
            try:
                item = rep.work.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            reply, srv_reply, qvec, attempts, t_limit = item
            try:
                # the server's own deadline sweep normally resolves first
                # (TimedOut payload); the +0.5 grace only catches a fully
                # dead server whose sweep is gone too
                wait = max(0.01, t_limit - time.perf_counter()) + 0.5
                out = srv_reply.get(timeout=wait)
            except queue.Empty:
                out = TimedOut(f"replica {rep.name}: no reply by deadline")
            self._unload(rep.name)
            if isinstance(out, tuple):
                self._finish(reply, out, srv_reply.completed_at)
                continue
            if isinstance(out, TimedOut):
                now = time.perf_counter()
                if reply.deadline is not None and reply.deadline <= now:
                    # the CLIENT deadline expired — not the replica's
                    # fault; report without penalising the replica
                    self._finish(reply, out)
                    continue
            self._mark_down(rep.name)
            self._retry(qvec, reply, attempts, out)


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Rollout gate: probe each swapped replica before it rejoins."""

    probes: int = 8              # probe queries per replica
    k: int = 10
    min_recall: float = 0.9      # mean top-k overlap vs pre-rollout answers
    max_p99_ms: float = 2000.0   # probe latency ceiling (post-warmup)
    timeout_s: float = 10.0      # per-probe reply timeout


@dataclasses.dataclass(frozen=True)
class AutoCompactPolicy:
    """Compaction controller thresholds: when the delta tier outgrows the
    base or per-segment scales diverge, the actor compacts and swaps the
    fresh base into the least-loaded replica first."""

    max_delta_fraction: float = 0.25
    max_scale_divergence: float = 1.5    # scale ratio; floor is 1.0
    interval_s: float = 1.0      # evaluation cadence


# --------------------------------------------------------------------------
# the fleet
# --------------------------------------------------------------------------

class ReplicaSet:
    """R replicas over one IndexStore, one Router, one maintenance actor.

    The actor thread is the only code that mutates the index, the store,
    or replica membership — appends, compaction (including the
    auto-compaction controller), rollouts, and restarts are all
    serialised through ``_tasks``, so no replica-swap race is possible
    and the class needs no locks of its own.
    """

    def __init__(self, store, *, replicas: int = 3, k: int = 10,
                 max_batch: int = 32, pipeline_depth: int = 3,
                 delta_capacity: int = 4096,
                 max_outstanding: int = 256, replica_timeout: float = 5.0,
                 max_retries: int = 2,
                 health_policy: HealthPolicy | None = None,
                 autocompact: AutoCompactPolicy | None = None,
                 probe_queries: np.ndarray | None = None, device=None):
        if not isinstance(store, IndexStore):
            store = IndexStore.open(store)
        self.store = store
        self.k = k
        self.max_batch = max_batch
        self.pipeline_depth = pipeline_depth
        self.delta_capacity = delta_capacity
        self.health_policy = health_policy or HealthPolicy()
        self.autocompact = autocompact
        self.probe_queries = probe_queries
        self.index = SegmentedIndex.load(store, delta_capacity=delta_capacity,
                                         device=device)
        self.device = self.index.device
        self.pruner = store.load_pruner(device=self.device)
        self.version = str(store.path)
        self.events: list = []       # actor-appended; snapshot via health()
        self.replicas = []
        for i in range(replicas):
            f = FaultableIndex(self.index)
            self.replicas.append(Replica(f"r{i}", self._server(f), f))
        self.router = Router(self.replicas, max_outstanding=max_outstanding,
                             replica_timeout=replica_timeout,
                             max_retries=max_retries)
        self.updater = IndexUpdater(pruner=self.pruner, index=self.index,
                                    store=store, server=None,
                                    delta_capacity=delta_capacity)
        self._tasks: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._last_tick = time.monotonic()
        self._actor_thread = threading.Thread(target=self._actor, daemon=True,
                                              name="fleet-actor")
        self._actor_thread.start()

    # -- client passthroughs (duck-types RetrievalServer for _drive_open) --
    def submit(self, qvec, deadline: float | None = None) -> Reply:
        return self.router.submit(qvec, deadline=deadline)

    def query(self, qvec, timeout: float = 30.0,
              deadline: float | None = None):
        return self.router.query(qvec, timeout=timeout, deadline=deadline)

    def reset_stats(self) -> None:
        self.router.reset_stats()

    def stats(self) -> dict:
        return self.router.stats()

    def health(self) -> dict:
        maint = self.updater.health()
        states = self.router.states()
        reps = {}
        for rep in self.replicas:
            err = rep.server.error
            reps[rep.name] = {"state": states.get(rep.name, "up"),
                              "error": None if err is None else repr(err)}
        ok = maint["ok"] and all(v["error"] is None and v["state"] == "up"
                                 for v in reps.values())
        return {"ok": ok, "version": self.version, "maintenance": maint,
                "replicas": reps, "events": list(self.events)}

    # -- maintenance API (serialised through the actor) ---------------------
    def append(self, rows, timeout: float = 120.0) -> int:
        return self._call("append", timeout, rows=rows)

    def compact(self, timeout: float = 600.0) -> None:
        return self._call("compact", timeout)

    def rollout(self, path, timeout: float = 600.0) -> dict:
        return self._call("rollout", timeout, path=path)

    def restart(self, name: str, timeout: float = 120.0) -> None:
        return self._call("restart", timeout, name=name)

    def apply_fault(self, ev: FaultEvent) -> None:
        """Fault-plan entry point; mutating actions route via the actor."""
        if ev.action == "corrupt":
            removed = corrupt_artifact(ev.arg)
            self.events.append({"kind": "fault", "action": "corrupt",
                                "blob": removed})
            return
        if ev.action == "restart":
            self.restart(ev.replica)
            return
        state = self._replica(ev.replica).faultable.state
        if ev.action == "kill":
            state.inject("crash")
        elif ev.action == "hang":
            state.inject("hang")
        elif ev.action == "slow":
            state.inject(("slow", float(ev.arg if ev.arg is not None
                                        else 0.05)))
        elif ev.action == "clear":
            state.clear()
        else:
            raise ValueError(f"unknown fault action {ev.action!r}")
        self.events.append({"kind": "fault", "action": ev.action,
                            "replica": ev.replica})

    def close(self) -> None:
        self._stop.set()
        self._tasks.put(None)
        self._actor_thread.join(timeout=30.0)
        for rep in self.replicas:
            rep.faultable.state.clear()   # release any injected hang
        self.router.close()
        for rep in self.replicas:
            rep.server.close()

    # -- actor --------------------------------------------------------------
    def _server(self, faultable: FaultableIndex) -> RetrievalServer:
        """A replica server over ``faultable``, every batch shape run once."""
        srv = RetrievalServer(faultable, self.pruner, k=self.k,
                              max_batch=self.max_batch,
                              pipeline_depth=self.pipeline_depth)
        srv.warmup()
        return srv

    def _replica(self, name: str) -> Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    def _call(self, kind: str, timeout: float, **kw):
        box = {"evt": threading.Event(), "out": None, "err": None}
        self._tasks.put((kind, kw, box))
        if not box["evt"].wait(timeout=timeout):
            raise TimeoutError(f"fleet task {kind!r} did not finish "
                               f"within {timeout}s")
        if box["err"] is not None:
            raise box["err"]
        return box["out"]

    def _actor(self) -> None:
        handlers = {"append": self._task_append,
                    "compact": self._task_compact,
                    "rollout": self._task_rollout,
                    "restart": self._task_restart}
        while not self._stop.is_set():
            try:
                task = self._tasks.get(timeout=0.1)
            except queue.Empty:
                self._maybe_autocompact()
                continue
            if task is None:
                return
            kind, kw, box = task
            try:
                box["out"] = handlers[kind](**kw)
            except BaseException as e:   # noqa: BLE001 — relayed to caller
                box["err"] = e
            finally:
                box["evt"].set()

    def _maybe_autocompact(self) -> None:
        pol = self.autocompact
        if pol is None:
            return
        now = time.monotonic()
        if now - self._last_tick < pol.interval_s:
            return
        self._last_tick = now
        df = self.updater.delta_fraction
        sd = self.updater.scale_divergence()
        if df <= pol.max_delta_fraction and sd <= pol.max_scale_divergence:
            return
        loads = self.router.loads()
        target = min(loads, key=loads.get) if loads else None
        self.events.append({"kind": "autocompact", "delta_fraction": df,
                            "scale_divergence": sd, "first_swap": target})
        self.updater.compact()
        self._adopt_updater()
        self._swap_all(order_first=target)

    def _adopt_updater(self) -> None:
        """Pull the updater's post-mutation view into the fleet."""
        self.index = self.updater.index
        if self.updater.store is not None:
            self.store = self.updater.store

    def _swap_all(self, order_first: str | None = None) -> None:
        """Install ``self.index`` on every replica (same projection —
        appends/compaction never change the rotation), least-loaded
        first so the fresh arrays warm where it is cheapest."""
        reps = sorted(self.replicas, key=lambda r: r.name != order_first)
        for rep in reps:
            rep.faultable.inner = self.index
            rep.server.swap_index(rep.faultable)

    def _task_append(self, rows) -> int:
        n = self.updater.add_documents(rows)
        self._adopt_updater()
        self._swap_all()
        return n

    def _task_compact(self) -> None:
        self.updater.compact()
        self._adopt_updater()
        self._swap_all()

    def _task_restart(self, name: str) -> None:
        rep = self._replica(name)
        self.router.quiesce(name)            # no new dispatches mid-restart
        self._await_drain(name)
        rep.faultable.state.clear()          # un-hang before joining threads
        try:
            rep.server.close()
        except Exception:                    # noqa: BLE001 — replacing anyway
            pass
        fresh = FaultableIndex(self.index, rep.faultable.state)
        rep.faultable = fresh
        rep.server = self._server(fresh)
        self.router.revive(name)
        self.events.append({"kind": "restart", "replica": name})

    # -- rolling rollout ----------------------------------------------------
    def _await_drain(self, name: str, timeout: float = 10.0) -> None:
        t0 = time.monotonic()
        while self.router.loads().get(name, 0) > 0:
            if time.monotonic() - t0 > timeout:
                break                        # swap is batch-atomic anyway
            time.sleep(0.005)

    def _probe_set(self) -> np.ndarray:
        pol = self.health_policy
        if self.probe_queries is None:
            raise RuntimeError("rollout needs probe_queries: the health "
                               "gate compares answers before/after swap")
        return np.asarray(self.probe_queries)[:pol.probes]

    def _reference_answers(self, probes: np.ndarray) -> list:
        """Top-k ids from a currently-serving healthy replica (bypasses
        admission so a saturated fleet can still health-check)."""
        states = self.router.states()
        rep = next((r for r in self.replicas
                    if states.get(r.name) == "up" and r.server.error is None),
                   None)
        if rep is None:
            raise NoHealthyReplica("no healthy replica to take rollout "
                                   "reference answers from")
        pol = self.health_policy
        return [np.asarray(rep.server.query(q, timeout=pol.timeout_s)[1])
                for q in probes]

    def _probe(self, rep: Replica, probes: np.ndarray, ref: list) -> dict:
        """Health-check one swapped replica: recall vs the pre-rollout
        reference and probe p99. First probe is untimed warmup (a fresh
        index's first batch may pay a kernel build)."""
        pol = self.health_policy
        try:
            rep.server.query(probes[0], timeout=pol.timeout_s)
        except Exception as e:
            return {"replica": rep.name, "ok": False,
                    "reason": f"warmup probe failed: {e!r}"}
        recalls, lats = [], []
        for q, ids_ref in zip(probes, ref):
            t0 = time.perf_counter()
            try:
                _, ids = rep.server.query(q, timeout=pol.timeout_s)
            except Exception as e:
                return {"replica": rep.name, "ok": False,
                        "reason": f"probe failed: {e!r}"}
            lats.append(time.perf_counter() - t0)
            got = np.asarray(ids)[:pol.k]
            want = set(np.asarray(ids_ref)[:pol.k].tolist())
            recalls.append(len(want & set(got.tolist())) / max(1, len(want)))
        recall = float(np.mean(recalls))
        p99_ms = float(np.percentile(np.array(lats) * 1e3, 99))
        ok = (recall >= pol.min_recall and p99_ms <= pol.max_p99_ms
              and rep.server.error is None)
        return {"replica": rep.name, "ok": ok, "recall": recall,
                "p99_ms": p99_ms}

    def _swap_replica(self, rep: Replica, index, pruner) -> None:
        """Quiesce -> drain -> install (index, pruner) atomically."""
        self.router.quiesce(rep.name)
        self._await_drain(rep.name)
        fresh = FaultableIndex(index, rep.faultable.state)
        rep.server.swap_index(fresh, pruner=pruner)
        rep.faultable = fresh

    def _task_rollout(self, path) -> dict:
        pol = self.health_policy
        result = {"kind": "rollout", "version": str(path), "ok": False,
                  "rolled_back": False, "per_replica": []}
        try:
            # open + validate BEFORE touching any replica: a torn or
            # corrupt artifact aborts here with the fleet untouched
            store_new = IndexStore.open(path)
            pruner_new = store_new.load_pruner(device=self.device)
            index_new = SegmentedIndex.load(
                store_new, delta_capacity=self.delta_capacity,
                device=self.device)
        except Exception as e:
            result["reason"] = f"artifact rejected: {e!r}"
            self.events.append(result)
            return result
        probes = self._probe_set()
        ref = self._reference_answers(probes)
        prev_index, prev_pruner = self.index, self.pruner
        swapped: list[Replica] = []
        for rep in self.replicas:
            t0 = time.perf_counter()
            self._swap_replica(rep, index_new, pruner_new)
            swapped.append(rep)
            verdict = self._probe(rep, probes, ref)
            verdict["seconds"] = time.perf_counter() - t0   # swap + probe
            result["per_replica"].append(verdict)
            if not verdict["ok"]:
                # regression: swap every touched replica back BEFORE any
                # of them rejoins — live traffic never saw the bad index
                for r in swapped:
                    self._swap_replica(r, prev_index, prev_pruner)
                    self.router.revive(r.name)
                result["rolled_back"] = True
                result["reason"] = verdict.get("reason", "probe regression")
                self.events.append(result)
                return result
            self.router.revive(rep.name)
        self.index, self.pruner, self.store = index_new, pruner_new, store_new
        self.version = str(path)
        self.updater = IndexUpdater(pruner=pruner_new, index=index_new,
                                    store=store_new, server=None,
                                    delta_capacity=self.delta_capacity)
        result["ok"] = True
        self.events.append(result)
        return result
