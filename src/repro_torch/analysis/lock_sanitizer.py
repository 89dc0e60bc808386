"""Happens-before lock sanitizer for the port: static handoff analysis and
runtime lock-order recording, cross-checked against the static graph
(counterpart of ``repro/analysis/lock_sanitizer.py``).

  * **Handoff deadlocks** (``locks.handoff-deadlock``): a consumer blocks
    on a channel (``queue.Queue.get``, ``Condition.wait``, a reply future)
    while holding a lock every producer of that channel needs to publish.
    A condition's own lock is exempt (``wait`` releases it), as is any
    receive with a timeout (a stall, not a deadlock).
  * **Dynamic orders the AST cannot see**: ``instrument`` replaces
    ``threading.Lock/RLock/Condition`` with recording wrappers for locks
    created by code under ``src/repro_torch`` (the analysis package
    excluded). Each acquisition adds held -> acquired edges to a
    :class:`LockMonitor`; the observed graph must embed in the transitive
    closure of the static acquisition graph (``locks.graph-divergence``),
    and an observed lock the static pass never found is
    ``locks.unknown-lock``.

Two repairs against the reference. The scope is the package directory
*with* a trailing separator, so a ``src/repro_torch`` file never matches a
``src/repro`` scope or the reverse. Labels are keyed by module
(``repro_torch.launch.serve:RetrievalServer._index_lock``), in the static
graph and at run time alike, so two packages' classes of one name never
share a node. ``instrument`` takes the real primitives from ``_thread``
(and the real ``Condition`` class), never whatever ``threading.Lock`` is at
import: a test session may already have wrapped it with the reference's
monitor, and ``uninstrument`` puts back exactly the objects it replaced.
"""
from __future__ import annotations

import _thread
import json
import linecache
import os
import re
import sys
import threading
from pathlib import Path
from typing import Sequence

from repro_torch.analysis import Finding, concurrency as _conc

LOCKGRAPH_SCHEMA = "repro_torch.analysis/lockgraph-v1"

# --------------------------------------------------------------------------
# static half: handoff (happens-before) analysis
# --------------------------------------------------------------------------

#: blocking receive method -> the channel kinds it blocks on
_RECV_METHODS = frozenset({"get", "wait", "wait_for", "result", "join"})
#: methods that publish to / wake a channel
_PRODUCE_METHODS = frozenset({"put", "put_nowait", "set", "notify",
                              "notify_all", "set_result"})


# --------------------------------------------------------------------------
# static half: handoff (happens-before) analysis
# --------------------------------------------------------------------------

def _channel_fields(info) -> set:
    """Fields a thread can park on: self-sync primitives (queues, events)
    plus condition variables (wait/notify handoff)."""
    return set(info.selfsync) | set(info.locks)


def handoff_findings(infos: Sequence) -> list[Finding]:
    findings = []
    for info in infos:
        channels = _channel_fields(info)
        produced_under: dict[str, list[frozenset]] = {}
        for c in info.calls:
            if (c.owner in channels and c.target in _PRODUCE_METHODS):
                # locks held at the producing site, plus any the producing
                # method acquires on some path before/around the publish
                need = set(c.held) | info.locks_acquired_by(c.method)
                produced_under.setdefault(c.owner, []).append(
                    frozenset(need))
        for c in info.calls:
            if (c.owner not in channels or c.target not in _RECV_METHODS
                    or c.bounded or not c.held):
                continue
            # a condition's wait releases the condition's own lock
            blocked_holding = set(c.held) - {c.owner}
            if not blocked_holding:
                continue
            sites = produced_under.get(c.owner, [])
            if not sites:
                continue
            # deadlock needs EVERY producer path to require the held lock;
            # one lock-free producer can still complete the handoff
            stuck = blocked_holding & frozenset.intersection(*sites)
            if not stuck:
                continue
            findings.append(Finding(
                check="locks.handoff-deadlock",
                where=f"{info.module}:{info.name}.{c.method}:{c.owner}",
                message=(f"{info.name}.{c.method}() blocks on "
                         f"{c.owner}.{c.target}() holding "
                         f"{'/'.join(sorted(stuck))}, but the producer of "
                         f"{c.owner} needs that lock to publish — the "
                         f"handoff can never complete")))
    return findings


# --------------------------------------------------------------------------
# static lock graph (exported for the runtime cross-check)
# --------------------------------------------------------------------------

def _tree_infos() -> list:
    infos = []
    for module, path in _conc.source_targets():
        infos += _conc.analyze_classes(Path(path).read_text(), module)
    return infos


def _qualify(label: str, modules: dict) -> str:
    """``Class.lock`` -> ``module:Class.lock``."""
    cls = label.split(".", 1)[0]
    return f"{modules.get(cls, '?')}:{label}"


def static_lock_graph(infos: Sequence | None = None) -> dict:
    """Nodes (every lock field of an analysed class) and acquisition
    edges, labelled ``module:Class.field``."""
    if infos is None:
        infos = _tree_infos()
    modules: dict = {}
    for i in infos:
        modules.setdefault(i.name, i.module)
    edges = _conc.acquisition_edges(infos)
    nodes = {f"{i.module}:{i.name}.{l}" for i in infos for l in i.locks}
    nodes |= {_qualify(a, modules) for a in edges}
    nodes |= {_qualify(b, modules) for bs in edges.values() for b in bs}
    return {
        "schema": LOCKGRAPH_SCHEMA,
        "nodes": sorted(nodes),
        "edges": sorted([_qualify(a, modules), _qualify(b, modules)]
                        for a, bs in edges.items() for b in bs),
        "handoffs": sorted(f.key for f in handoff_findings(infos)),
    }


def _closure(edges: dict[str, set]) -> dict[str, set]:
    out = {a: set(bs) for a, bs in edges.items()}
    changed = True
    while changed:
        changed = False
        for a in list(out):
            for b in list(out[a]):
                for c in out.get(b, ()):
                    if c not in out[a] and c != a:
                        out[a].add(c)
                        changed = True
    return out


def crosscheck(observed: dict, static: dict) -> list[Finding]:
    """Observed (runtime) lock graph must embed in the static one."""
    findings = []
    static_nodes = set(static.get("nodes", ()))
    sedges: dict[str, set] = {}
    for a, b in static.get("edges", ()):
        sedges.setdefault(a, set()).add(b)
    closed = _closure(sedges)
    for node in sorted(set(observed.get("nodes", ())) - static_nodes):
        findings.append(Finding(
            check="locks.unknown-lock", where=node, severity="warn",
            message=(f"runtime observed lock {node} that the static pass "
                     f"never discovered — naming drift or a lock created "
                     f"outside the analysed tree")))
    for a, b in observed.get("edges", ()):
        if a not in static_nodes or b not in static_nodes:
            continue                      # already reported as unknown
        if b not in closed.get(a, set()):
            findings.append(Finding(
                check="locks.graph-divergence", where=f"{a}->{b}",
                message=(f"runtime acquired {b} while holding {a}, an "
                         f"order the static acquisition graph does not "
                         f"contain — the deadlock lint is blind to this "
                         f"path")))
    return findings


# --------------------------------------------------------------------------
# runtime half: recording lock wrappers
# --------------------------------------------------------------------------


def _real_condition() -> type:
    """The interpreter's ``threading.Condition`` class, even when the name
    is already bound to another monitor's factory: the main thread's
    ``_started`` event was built with it when ``threading`` was imported."""
    cond = threading.Condition
    if isinstance(cond, type):
        return cond
    return type(threading.main_thread()._started._cond)


_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_REAL_CONDITION = _real_condition()

_SELF_ATTR_RE = re.compile(r"self\.(\w+)")


def _port_scope() -> tuple[str, str]:
    """The port's package directory and its analysis package, each with a
    trailing separator."""
    import repro_torch
    root = str(Path(next(iter(repro_torch.__path__))))
    return root + os.sep, os.path.join(root, "analysis") + os.sep


class LockMonitor:
    """Thread-safe recorder of per-thread held stacks and the directed
    held->acquired edge set."""

    def __init__(self):
        self._tl = threading.local()
        self._mu = _REAL_LOCK()
        self.nodes: set[str] = set()
        self.edges: set[tuple[str, str]] = set()

    def _stack(self) -> list:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    def on_acquire(self, label: str) -> None:
        st = self._stack()
        with self._mu:
            self.nodes.add(label)
            for held in st:
                if held != label:
                    self.edges.add((held, label))
        st.append(label)

    def on_release(self, label: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == label:
                del st[i]
                break

    def to_doc(self) -> dict:
        with self._mu:
            return {"schema": LOCKGRAPH_SCHEMA,
                    "nodes": sorted(self.nodes),
                    "edges": sorted([a, b] for a, b in self.edges)}

    def write(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_doc(), indent=1) + "\n")


def _derive_label(skip: int = 2) -> str | None:
    """Walk the acquiring stack to the first frame inside the port (not its
    analysis package) and name the lock ``module:Class.field`` from its
    source line."""
    root, analysis = _port_scope()
    f = sys._getframe(skip)
    for _ in range(12):
        if f is None:
            return None
        fname = f.f_code.co_filename
        if fname.startswith(root) and not fname.startswith(analysis):
            m = _SELF_ATTR_RE.search(linecache.getline(fname, f.f_lineno))
            obj = f.f_locals.get("self")
            if m and obj is not None:
                module = f.f_globals.get("__name__", "?")
                return f"{module}:{type(obj).__name__}.{m.group(1)}"
            return None
        f = f.f_back
    return None


class _TrackedLock:
    """Recording proxy over a real Lock/RLock. The label is derived at
    first acquisition from the acquiring frame; unlabelled acquisitions
    (locks only ever touched outside the port) record nothing."""

    def __init__(self, inner, mon: LockMonitor):
        self._inner = inner
        self._mon = mon
        self._label: str | None = None
        self._named = False

    def _name(self) -> str | None:
        if not self._named:
            label = _derive_label(skip=3)
            if label is not None:
                self._label, self._named = label, True
        return self._label

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            label = self._name()
            if label is not None:
                self._mon.on_acquire(label)
        return got

    def release(self):
        if self._label is not None:
            self._mon.on_release(self._label)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _TrackedCondition:
    """Recording proxy over a real Condition. ``wait`` / ``wait_for``
    release the underlying lock for their whole park, so the held stack
    drops the label across the call and restores it on wake."""

    def __init__(self, inner, mon: LockMonitor):
        self._inner = inner
        self._mon = mon
        self._label: str | None = None
        self._named = False

    def _name(self) -> str | None:
        if not self._named:
            label = _derive_label(skip=3)
            if label is not None:
                self._label, self._named = label, True
        return self._label

    def __enter__(self):
        self._inner.__enter__()
        label = self._name()
        if label is not None:
            self._mon.on_acquire(label)
        return self

    def __exit__(self, *exc):
        if self._label is not None:
            self._mon.on_release(self._label)
        return self._inner.__exit__(*exc)

    def _park(self, fn, *args):
        if self._label is not None:
            self._mon.on_release(self._label)
        try:
            return fn(*args)
        finally:
            if self._label is not None:
                self._mon.on_acquire(self._label)

    def wait(self, timeout=None):
        return self._park(self._inner.wait, timeout)

    def wait_for(self, predicate, timeout=None):
        return self._park(self._inner.wait_for, predicate, timeout)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def acquire(self, *a, **k):
        got = self._inner.acquire(*a, **k)
        if got:
            label = self._name()
            if label is not None:
                self._mon.on_acquire(label)
        return got

    def release(self):
        if self._label is not None:
            self._mon.on_release(self._label)
        self._inner.release()


def instrument(mon: LockMonitor):
    """Bind ``threading.Lock/RLock/Condition`` to factories that give locks
    created by code under ``src/repro_torch`` (not this analysis package)
    recording proxies into ``mon``, and everything else the interpreter's
    real primitives. Returns the three objects it replaced, for
    :func:`uninstrument`."""
    root, analysis = _port_scope()

    def _in_scope() -> bool:
        fname = sys._getframe(2).f_code.co_filename
        return fname.startswith(root) and not fname.startswith(analysis)

    def _lock_factory(real, cls):
        def factory(*args, **kwargs):
            inner = real(*args, **kwargs)
            return cls(inner, mon) if _in_scope() else inner
        return factory

    def _condition_factory(lock=None):
        if isinstance(lock, _TrackedLock):
            lock = lock._inner
        inner = _REAL_CONDITION(_REAL_RLOCK() if lock is None else lock)
        return _TrackedCondition(inner, mon) if _in_scope() else inner

    originals = (threading.Lock, threading.RLock, threading.Condition)
    threading.Lock = _lock_factory(_REAL_LOCK, _TrackedLock)
    threading.RLock = _lock_factory(_REAL_RLOCK, _TrackedLock)
    threading.Condition = _condition_factory
    return originals


def uninstrument(originals) -> None:
    """Put back exactly the objects ``instrument`` replaced."""
    threading.Lock, threading.RLock, threading.Condition = originals


# --------------------------------------------------------------------------
# analyzer entry point
# --------------------------------------------------------------------------

def run(lock_graph_path: str | None = None) -> list[Finding]:
    """Static handoff findings over the port's tree; with an observed
    runtime graph, also cross-check it against the static one."""
    infos = _tree_infos()
    findings = handoff_findings(infos)
    if lock_graph_path is not None:
        observed = json.loads(Path(lock_graph_path).read_text())
        if observed.get("schema") != LOCKGRAPH_SCHEMA:
            raise SystemExit(
                f"{lock_graph_path}: expected schema {LOCKGRAPH_SCHEMA}, "
                f"got {observed.get('schema')!r}")
        findings += crosscheck(observed, static_lock_graph(infos))
    return findings
