"""AST concurrency lint for the port's serving tier (no imports, no
execution); counterpart of ``repro/analysis/concurrency.py``.

The live-serving classes (``RetrievalServer``, ``BatchingQueue``,
``IndexUpdater``) share mutable state across worker, appender and compactor
threads behind ``threading`` locks, a discipline Python cannot check. This
pass parses the source and rebuilds it statically:

  * **guarded-field map**: for every class owning a lock field
    (``threading.Lock/RLock/Condition``, including dataclass
    ``field(default_factory=...)``), every ``self.X`` access in every
    method is recorded with the set of locks lexically held at that point
    (``with self.lock:`` nesting, plus one level of call-site propagation:
    a private method whose in-class call sites all hold a lock is analysed
    as running under it).
  * **conc.unguarded-field**: a field written outside ``__init__`` with
    both locked and unlocked accesses.
  * **conc.unlocked-shared-mutable**: a mutated field touched from several
    methods of a lock-owning class with no locked access at all.
  * **conc.lock-order**: directed acquisition edges (lock held -> lock
    acquired), including edges through calls to known methods of the
    analysed classes; any cycle is a deadlock waiting for an interleaving.
  * **conc.blocking-under-lock**: a call that waits for the card or the
    host while a lock is held stalls every thread parked on that lock.
    The port's are ``torch.cuda.synchronize``, ``Event.synchronize`` and
    ``Stream.synchronize`` (any ``.synchronize()``), ``.item()``,
    ``.cpu()``, ``.tolist()`` and ``.numpy()`` (device reads), and, as in
    the reference, ``np.asarray`` (a host copy) and ``time.sleep``; the
    reference lists ``block_until_ready`` and JAX's transfers instead.

Self-synchronised stdlib primitives (``queue.Queue``, ``threading.Event``
/ ``Semaphore``) are exempt; fields only ever written in ``__init__`` /
``__post_init__`` are configuration, not shared mutable state.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Sequence

from repro_torch.analysis import Finding

_LOCK_TYPES = ("Lock", "RLock", "Condition")
_SELFSYNC_TYPES = ("Event", "Semaphore", "BoundedSemaphore", "Queue",
                   "SimpleQueue", "LifoQueue", "PriorityQueue", "Barrier")
_INIT_METHODS = ("__init__", "__post_init__")
# method calls on a field that mutate it in place
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "remove", "discard",
    "pop", "popleft", "clear", "update", "put", "put_nowait", "setdefault",
    "sort", "reverse",
})
# calls that wait for the card or block the host: any ``.synchronize()``
# (torch.cuda, an Event, a Stream) and the device reads by method name ...
_BLOCKING_TAILS = frozenset({"synchronize", "item", "cpu", "tolist", "numpy"})
# ... and by dotted name
_BLOCKING_DOTTED = frozenset({
    "torch.cuda.synchronize", "np.asarray", "numpy.asarray", "time.sleep",
})


@dataclasses.dataclass(frozen=True)
class Access:
    method: str
    field: str
    kind: str                  # "read" | "write"
    held: frozenset            # lock field names held at the access


@dataclasses.dataclass(frozen=True)
class CallSite:
    method: str
    held: frozenset
    target: str                # bare method name being invoked
    via_self: bool             # self._m() vs self.field._m()
    owner: str | None = None   # field name for self.field._m() calls
    bounded: bool = False      # call passes args/timeout (cannot block forever)


@dataclasses.dataclass
class ClassInfo:
    module: str
    name: str
    locks: set = dataclasses.field(default_factory=set)
    selfsync: set = dataclasses.field(default_factory=set)
    methods: dict = dataclasses.field(default_factory=dict)
    accesses: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    # (method, held_before frozenset, lock acquired)
    acquisitions: list = dataclasses.field(default_factory=list)
    blocking: list = dataclasses.field(default_factory=list)

    def locks_acquired_by(self, method: str) -> set:
        return {l for m, _, l in self.acquisitions if m == method}


def _dotted(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_self_attr(node) -> str | None:
    """``self.X`` -> ``"X"``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _value_typename(value) -> str | None:
    """Tail name of the constructor in ``self.x = threading.Lock()``."""
    if isinstance(value, ast.Call):
        d = _dotted(value.func)
        if d:
            return d.rsplit(".", 1)[-1]
    return None


class _ClassScanner:
    """Two-pass scan of one ClassDef: lock discovery, then lexical
    held-lock tracking through every method body."""

    def __init__(self, module: str, node: ast.ClassDef):
        self.info = ClassInfo(module=module, name=node.name)
        self.node = node
        self._discover()

    def _discover(self) -> None:
        info = self.info
        for stmt in self.node.body:
            # dataclass-style: _lock: RLock = field(default_factory=...)
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                              ast.Name):
                names = [stmt.target.id]
                ann = ast.dump(stmt.annotation) if stmt.annotation else ""
                factory = ""
                if isinstance(stmt.value, ast.Call):
                    for kw in stmt.value.keywords:
                        if kw.arg == "default_factory":
                            factory = _dotted(kw.value) or ""
                blob = ann + " " + factory
                if any(t in blob for t in _LOCK_TYPES):
                    info.locks.update(names)
                elif any(t in blob for t in _SELFSYNC_TYPES):
                    info.selfsync.update(names)
            if (isinstance(stmt, ast.FunctionDef)
                    and not any(_dotted(d) in ("staticmethod", "classmethod")
                                for d in stmt.decorator_list)):
                info.methods[stmt.name] = stmt
        for name in _INIT_METHODS:
            fn = info.methods.get(name)
            if fn is None:
                continue
            for sub in ast.walk(fn):
                targets = []
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets, value = [sub.target], sub.value
                else:
                    continue
                tn = _value_typename(value)
                if tn is None:
                    continue
                for t in targets:
                    f = _is_self_attr(t)
                    if f is None:
                        continue
                    if tn in _LOCK_TYPES:
                        self.info.locks.add(f)
                    elif tn in _SELFSYNC_TYPES:
                        self.info.selfsync.add(f)

    # -- pass 2: per-method lexical scan -----------------------------------
    def scan(self, entry_held: dict | None = None) -> None:
        entry_held = entry_held or {}
        info = self.info
        info.accesses, info.calls = [], []
        info.acquisitions, info.blocking = [], []
        for name, fn in info.methods.items():
            if name in _INIT_METHODS:
                continue
            held = frozenset(entry_held.get(name, ()))
            for stmt in fn.body:
                self._scan(stmt, held, name)

    def _lock_of(self, expr) -> str | None:
        f = _is_self_attr(expr)
        return f if f in self.info.locks else None

    def _scan(self, node, held: frozenset, method: str) -> None:
        info = self.info
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return      # nested defs run at unknown times / threads
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                self._scan(item.context_expr, held, method)
                lf = self._lock_of(item.context_expr)
                if lf is not None:
                    info.acquisitions.append((method, held, lf))
                    acquired.append(lf)
            inner = held | frozenset(acquired)
            for s in node.body:
                self._scan(s, inner, method)
            return
        if isinstance(node, ast.Attribute):
            f = _is_self_attr(node)
            if f is not None and f not in info.locks \
                    and f not in info.selfsync:
                kind = ("write" if isinstance(node.ctx,
                                              (ast.Store, ast.Del))
                        else "read")
                info.accesses.append(Access(method, f, kind, held))
        if isinstance(node, ast.Call):
            fn = node.func
            # self.field.mutator(...) counts as a write to the field
            if isinstance(fn, ast.Attribute):
                owner = _is_self_attr(fn.value)
                if (owner is not None and fn.attr in _MUTATORS
                        and owner not in info.locks
                        and owner not in info.selfsync):
                    info.accesses.append(Access(method, owner, "write",
                                                held))
                bounded = bool(node.args) or any(
                    kw.arg in ("timeout", "block") for kw in node.keywords)
                if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                    info.calls.append(CallSite(method, held, fn.attr, True,
                                               None, bounded))
                elif owner is not None:
                    info.calls.append(CallSite(method, held, fn.attr, False,
                                               owner, bounded))
            dotted = _dotted(fn)
            tail = dotted.rsplit(".", 1)[-1] if dotted else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if held and (tail in _BLOCKING_TAILS
                         or (dotted and dotted in _BLOCKING_DOTTED)):
                info.blocking.append((method, dotted or tail, sorted(held)))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, method)


def _propagated_context(info: ClassInfo) -> dict:
    """One level of call-site lock propagation for private methods: if
    every in-class call site of ``self._m()`` holds lock L, ``_m``'s body
    is re-analysed with L held on entry."""
    ctx = {}
    for name in info.methods:
        if not name.startswith("_") or name.startswith("__"):
            continue
        sites = [c.held for c in info.calls
                 if c.via_self and c.target == name]
        if not sites:
            continue
        common = frozenset.intersection(*sites)
        if common:
            ctx[name] = common
    return ctx


def analyze_classes(source: str, module: str) -> list[ClassInfo]:
    tree = ast.parse(source)
    infos = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            sc = _ClassScanner(module, node)
            sc.scan()
            sc.scan(_propagated_context(sc.info))   # second pass, propagated
            infos.append(sc.info)
    return infos


def field_findings(info: ClassInfo) -> list[Finding]:
    findings = []
    fields = sorted({a.field for a in info.accesses})
    for field in fields:
        acc = [a for a in info.accesses if a.field == field]
        writes = [a for a in acc if a.kind == "write"]
        if not writes:
            continue                     # read-only after init: config
        locked = [a for a in acc if a.held]
        unlocked = [a for a in acc if not a.held]
        if locked and unlocked:
            guards = sorted({l for a in locked for l in a.held})
            for method in sorted({a.method for a in unlocked}):
                kinds = sorted({a.kind for a in unlocked
                                if a.method == method})
                findings.append(Finding(
                    check="conc.unguarded-field",
                    where=f"{info.module}:{info.name}.{method}:{field}",
                    message=(f"{info.name}.{field} is guarded by "
                             f"{'/'.join(guards)} elsewhere but "
                             f"{'/'.join(kinds)} without it in "
                             f"{method}() — torn snapshot or lost "
                             f"update under contention")))
        elif not locked and info.locks and len({a.method for a in acc}) > 1:
            methods = sorted({a.method for a in acc})
            findings.append(Finding(
                check="conc.unlocked-shared-mutable",
                where=f"{info.module}:{info.name}:{field}",
                message=(f"{info.name}.{field} is mutated and shared "
                         f"across {', '.join(methods)} with no lock ever "
                         f"held, in a class that owns "
                         f"{'/'.join(sorted(info.locks))}")))
    return findings


def acquisition_edges(infos: Sequence[ClassInfo]) -> dict[str, set]:
    """Directed acquisition graph over qualified locks (``Class.lock``
    held -> acquired), including interprocedural edges through calls to
    known methods of the analysed classes."""
    by_method: dict[str, list[tuple[ClassInfo, set]]] = {}
    for info in infos:
        for m in info.methods:
            locks = info.locks_acquired_by(m)
            if locks:
                by_method.setdefault(m, []).append((info, locks))
    edges: dict[str, set] = {}

    def _edge(a: str, b: str) -> None:
        if a != b:
            edges.setdefault(a, set()).add(b)

    for info in infos:
        for _method, held, lock in info.acquisitions:
            for h in held:
                _edge(f"{info.name}.{h}", f"{info.name}.{lock}")
        for c in info.calls:
            if not c.held:
                continue
            for target_info, locks in by_method.get(c.target, ()):
                if c.via_self and target_info is not info:
                    continue            # self-call: same class only
                for l in locks:
                    for h in c.held:
                        _edge(f"{info.name}.{h}",
                              f"{target_info.name}.{l}")
    return edges


def lock_order_findings(infos: Sequence[ClassInfo]) -> list[Finding]:
    """Cycles in the acquisition graph are potential deadlocks."""
    edges = acquisition_edges(infos)
    findings, seen = [], set()

    def _dfs(n, stack, on_stack):
        for nxt in sorted(edges.get(n, ())):
            if nxt in on_stack:
                cyc = stack[stack.index(nxt):] + [nxt]
                key = tuple(sorted(cyc[:-1]))
                if key not in seen:
                    seen.add(key)
                    findings.append(Finding(
                        check="conc.lock-order",
                        where=":".join(sorted(key)),
                        message=("lock acquisition cycle "
                                 + " -> ".join(cyc)
                                 + " — two threads entering from opposite "
                                   "ends deadlock")))
            elif nxt not in visited:
                visited.add(nxt)
                _dfs(nxt, stack + [nxt], on_stack | {nxt})

    visited: set = set()
    for n in sorted(edges):
        if n not in visited:
            visited.add(n)
            _dfs(n, [n], {n})
    return findings


def blocking_findings(infos: Sequence[ClassInfo]) -> list[Finding]:
    findings = []
    for info in infos:
        for method, call, held in info.blocking:
            findings.append(Finding(
                check="conc.blocking-under-lock",
                where=f"{info.module}:{info.name}.{method}:{call}",
                message=(f"{info.name}.{method}() calls {call} while "
                         f"holding {'/'.join(held)} — every thread parked "
                         f"on that lock now waits on the device/host "
                         f"transfer")))
    return findings


def analyze(paths: Sequence[tuple[str, str | Path]]) -> list[Finding]:
    """(module-label, source-path) pairs -> combined findings."""
    infos: list[ClassInfo] = []
    for module, path in paths:
        infos += analyze_classes(Path(path).read_text(), module)
    findings: list[Finding] = []
    for info in infos:
        findings += field_findings(info)
    findings += lock_order_findings(infos)
    findings += blocking_findings(infos)
    return findings


#: the serving-tier modules under contract
TARGETS = (("repro_torch.launch.serve", "launch/serve.py"),
           ("repro_torch.core.maintenance", "core/maintenance.py"))


def source_targets() -> list[tuple[str, Path]]:
    """(dotted-module, path) for every module in the ``repro_torch`` tree,
    excluding the analysis package itself (its fixtures are deliberately
    broken and its passes are not serving code)."""
    import repro_torch
    root = Path(next(iter(repro_torch.__path__)))
    targets = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if rel.parts[0] == "analysis":
            continue
        dotted = ".".join(("repro_torch",) + rel.parts[:-1]
                          + (() if rel.name == "__init__.py"
                             else (rel.stem,)))
        targets.append((dotted, path))
    return targets


def run() -> list[Finding]:
    return analyze(source_targets())
