"""Dispatch lints over the port's serving entry points (counterpart of
``repro/analysis/jaxpr_lints.py``).

Eager PyTorch has no jaxpr to trace, so each entry point is run once on a
small seeded corpus (CUDA tensors on the card) under a ``Probe``: a
``TorchDispatchMode`` sees every aten op, a ``TorchFunctionMode`` every
Python-level tensor conversion, and the top-k entries are tapped where the
index modules call them (``ops.topk_score``, ``ops.topk_score_paged``, and
on the CPU ``core/index.py``'s ``_scan_topk``, which the dense search and
the sharded slots call directly): on the CPU a search makes the same
top-k calls as on the card. Four checks:

  * **dispatch.extra-dispatch**: the top-k calls of one search are exactly
    the entry point's contract: one a dense search, one more a delta, one
    a shard slot, one a paged run or host wave, and for a cascade its
    coarse scan's plus its rescore's. A top-k call inside another (the
    CUDA wrapper under ``ops``) is not counted again.
  * **dispatch.upcast**: no aten op makes an f32 / f64 tensor of more
    elements than one scan strip (65,536 rows x m, the ``_scan_topk``
    block) from an int8 or bf16 index tensor: the bandwidth win is
    streaming the index in its storage dtype, not a shadow copy. The
    small entry points here use the reference's 128-row strip, so that a
    copy of their whole 600-row index is caught too.
  * **dispatch.host-sync**: no host read inside an entry point:
    ``aten._local_scalar_dense``, ``item``, ``nonzero``, ``is_nonzero``,
    ``equal``, or a Python-level ``item`` / ``tolist`` / ``numpy`` /
    ``bool`` / ``int`` / ``float`` / ``index`` of a tensor on the entry
    point's device, or a ``cpu()`` / ``to("cpu")`` off the card. On the
    CPU the plain kernel stand-ins are exempt (the CPU scan's block skip
    reads the host by design). On the card the entry point also runs under
    ``torch.cuda.set_sync_debug_mode("error")``. Findings are keyed by
    entry point, so the card and the CPU report the same keys.
  * **dispatch.recompile**: over a sweep of delta live counts (appends
    inside one delta's capacity, so the id offsets move too) every search
    makes top-k calls of the same operand shapes, and none reads the host:
    a CUDA graph captured once replays as the index grows
    (``chip_smoke.py`` phase 18 replays one).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import Finding

#: rows of one ``_scan_topk`` block (``core/index.py``): the unit a storage
#: dtype may be upcast in
STRIP_ROWS = 65536
#: the strip of the small entry points (600 rows): the reference's 128 rows,
#: so that a copy of the whole small index is more than one strip
SMALL_STRIP_ROWS = 128
_NARROW = (torch.int8, torch.bfloat16, torch.float16)
_WIDE = (torch.float32, torch.float64)
_HOST_READ_METHODS = frozenset({"item", "tolist", "numpy", "__bool__", "__int__",
                                "__float__", "__index__"})
_HOST_SYNC_ATEN = frozenset({"_local_scalar_dense", "item", "nonzero", "is_nonzero",
                             "equal"})
#: copy-like aten ops: an output larger than one strip is a materialised
#: copy (the cost model prices it as a write and a read back)
MATERIALIZE_OPS = frozenset({"_to_copy", "copy", "clone", "index", "index_select",
                             "gather", "cat", "stack", "sort", "constant_pad_nd",
                             "index_put", "scatter", "where"})


def _aten_name(func) -> str:
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(x):
    """The shape-and-dtype signature of a call argument: tensors by layout,
    small host ints kept (k), anything else by type."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    return type(x).__name__


@dataclasses.dataclass
class KernelCall:
    """One top-k entry call (``kind``: ``topk``, ``paged`` or ``scan``) or
    a segment marker (``delta``, ``rescore``), with what it was given and
    what it returned."""

    kind: str
    args: tuple
    kwargs: dict
    out: object = None

    def signature(self) -> tuple:
        """Operand shapes and dtypes and k; the live count and offsets,
        host values a graph would bake in, are left out (``lo`` / ``hi`` of
        a paged walk too: they stay host ints, ROADMAP queue 2 item 5)."""
        if self.kind == "paged":
            keep = (self.args[:4] + self.args[6:])
        elif self.kind == "scan":
            keep = self.args[:3]
        else:
            keep = self.args
        kw = {k: v for k, v in self.kwargs.items() if k not in ("n_valid",)}
        return (self.kind, _sig(keep), tuple(sorted((k, _sig(v)) for k, v in kw.items())))

    # -- pricing (cost model) ---------------------------------------------
    def price(self) -> tuple[float, float, float]:
        """(FLOPs, read bytes, write bytes) of the kernel call: each operand
        read once, each output written once, 2·B·rows·m multiply-adds over
        the rows it scores (a paged walk: its slots' pages only)."""
        writes = float(sum(_nbytes(t) for t in _tensors(self.out)))
        if self.kind in ("topk", "scan"):
            D, Q = self.args[0], self.args[1]
            reads = _nbytes(D) + _nbytes(Q)
            reads += sum(_nbytes(t) for t in _tensors(self.kwargs))
            return 2.0 * Q.shape[0] * D.shape[0] * D.shape[1], float(reads), writes
        pool, table, nvalid, offset, lo, hi, Q = self.args[:7]
        _, R, m = pool.shape
        slots = max(int(hi) - int(lo), 0)
        reads = slots * R * m * pool.element_size() + 3 * 4 * slots + _nbytes(Q)
        if self.kwargs.get("page_scale") is not None:
            reads += slots * m * 4
        if self.kwargs.get("ids_pool") is not None:
            reads += slots * R * 4
        carry = self.kwargs.get("carry")
        if carry is not None:
            reads += sum(_nbytes(t) for t in carry)
        return 2.0 * Q.shape[0] * slots * R * m, float(reads), writes


#: (module, attribute, kind) of every top-k entry and segment marker the
#: index modules call through a module attribute
_TAPS = (("repro_torch.kernels.ops", "topk_score", "topk"),
         ("repro_torch.kernels.ops", "topk_score_paged", "paged"),
         ("repro_torch.core.index", "_scan_topk", "scan"),
         ("repro_torch.core.index", "_delta_topk", "delta"),
         ("repro_torch.core.index", "_rows_rescore", "rescore"))
_KERNEL_KINDS = ("topk", "paged", "scan")


class Probe:
    """Runs code under the taps and both modes and records its top-k calls
    (outermost only), segment markers, host reads, upcasts and, with
    ``costs``, the aten work outside the kernel calls.

    ``device``: the entry point's device type (``"cpu"`` / ``"cuda"``);
    ``strip_elems``: the upcast threshold (None: not checked)."""

    def __init__(self, device: str = "cpu", strip_elems: int | None = None,
                 costs: bool = False):
        self.device = device
        self.strip_elems = strip_elems
        self.costs = costs
        self.calls: list[KernelCall] = []
        self.markers: list[KernelCall] = []
        self.host_reads: list[str] = []
        self.upcasts: list[str] = []
        self.flops = self.reads = self.writes = 0.0
        self.depth = 0                 # inside a top-k entry
        self._undo: list = []
        self._modes: list = []

    # -- taps -------------------------------------------------------------
    def _wrap(self, kind: str, fn: Callable) -> Callable:
        probe = self

        def tapped(*args, **kwargs):
            if kind not in _KERNEL_KINDS:
                rec = KernelCall(kind, args, kwargs)
                probe.markers.append(rec)
                rec.out = fn(*args, **kwargs)
                return rec.out
            outer = probe.depth == 0
            probe.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                probe.depth -= 1
            if outer:
                rec = KernelCall(kind, args, kwargs, out)
                probe.calls.append(rec)
                if probe.costs:
                    f, r, w = rec.price()
                    probe.flops += f
                    probe.reads += r
                    probe.writes += w
            return out
        tapped.__wrapped__ = fn
        return tapped

    def __enter__(self) -> "Probe":
        import importlib
        for mod_name, attr, kind in _TAPS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            self._undo.append((mod, attr, real))
            setattr(mod, attr, self._wrap(kind, real))
        self._modes = [_Functions(self), _Dispatch(self)]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        for mod, attr, real in reversed(self._undo):
            setattr(mod, attr, real)
        self._undo.clear()

    # -- what the modes report --------------------------------------------
    def _exempt(self) -> bool:
        """Inside a plain kernel stand-in on the CPU."""
        return self.depth > 0 and self.device == "cpu"

    def host_read(self, what: str) -> None:
        if not self._exempt():
            self.host_reads.append(what)

    @property
    def kernel_calls(self) -> int:
        return len(self.calls)


class _Functions(TorchFunctionMode):
    def __init__(self, probe: Probe):
        super().__init__()
        self.probe = probe

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        t = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if t is not None:
            if name in _HOST_READ_METHODS and t.device.type == self.probe.device:
                self.probe.host_read(f"Tensor.{name}")
            elif name in ("cpu", "to") and t.device.type != "cpu" and (
                    name == "cpu" or _to_cpu(args[1:], kwargs)):
                self.probe.host_read(f"Tensor.{name}(cpu)")
        return func(*args, **kwargs)


def _to_cpu(args, kwargs) -> bool:
    for v in (*args, kwargs.get("device")):
        if isinstance(v, torch.device):
            return v.type == "cpu"
        if isinstance(v, str):
            return v.split(":")[0] == "cpu"
    return False


class _Dispatch(TorchDispatchMode):
    def __init__(self, probe: Probe):
        super().__init__()
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        p = self.probe
        name = _aten_name(func)
        ins = list(_tensors((args, kwargs)))
        if name in _HOST_SYNC_ATEN and any(t.device.type == p.device for t in ins):
            p.host_read(f"aten.{name}")
        outs = list(_tensors(out))
        if p.strip_elems is not None and not p._exempt():
            src = [t for t in ins if t.dtype in _NARROW and t.numel() > p.strip_elems]
            big = [t for t in outs if t.dtype in _WIDE and t.numel() > p.strip_elems]
            if src and big:
                p.upcasts.append(f"aten.{name}: {src[0].dtype} {tuple(src[0].shape)} -> "
                                 f"{big[0].dtype} {tuple(big[0].shape)}")
        if p.costs and p.depth == 0:
            from repro_torch.launch.flops import _MEM, op_cost
            f, _, _ = op_cost(func, args, kwargs, out)
            p.flops += f
            if name in _MEM:
                p.reads += sum(map(_nbytes, ins))
                p.writes += sum(map(_nbytes, outs))
            if name in MATERIALIZE_OPS and p.strip_elems is not None:
                big = [t for t in outs if t.numel() > p.strip_elems]
                if big:
                    mat = 2.0 * _nbytes(max(big, key=lambda t: t.numel()))
                    p.reads += mat
                    p.writes += mat
        return out


def run_probed(fn: Callable, args: Sequence, *, device: str = "cpu",
               strip_elems: int | None = None, costs: bool = False) -> Probe:
    with torch.no_grad(), Probe(device, strip_elems, costs) as probe:
        fn(*args)
    return probe


def _device_of(args) -> str:
    for t in _tensors(list(args)):
        return t.device.type
    return "cpu"


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def check_dispatch_count(label: str, fn: Callable, args: Sequence, expected: int,
                         probe: Probe | None = None) -> list[Finding]:
    probe = probe or run_probed(fn, args, device=_device_of(args))
    got = probe.kernel_calls
    if got == expected:
        return []
    kinds = [c.kind for c in probe.calls]
    return [Finding(
        check="dispatch.extra-dispatch", where=label,
        message=(f"{label}: {got} top-k calls a search ({kinds}), contract "
                 f"says exactly {expected}: a segment, shard or stage made "
                 f"a call of its own"))]


def check_upcast(label: str, fn: Callable, args: Sequence, corpus_shape: tuple[int, int],
                 strip_rows: int = STRIP_ROWS, probe: Probe | None = None
                 ) -> list[Finding]:
    """No f32 / f64 tensor of more than one strip (``strip_rows`` x m)
    elements made from an int8 / bf16 one. Callers check an index whose
    storage is narrow; one larger than a strip makes the check bite."""
    strip = min(strip_rows, corpus_shape[0]) * corpus_shape[1]
    if probe is None or probe.strip_elems != strip:
        probe = run_probed(fn, args, device=_device_of(args), strip_elems=strip)
    return [Finding(
        check="dispatch.upcast", where=label,
        message=(f"{label}: {probe.upcasts[0]} (> one {strip_rows}-row strip; "
                 f"{len(probe.upcasts)} such op(s)): a shadow copy defeats "
                 f"storage-dtype streaming"))] if probe.upcasts else []


def check_host_sync(label: str, fn: Callable, args: Sequence,
                    probe: Probe | None = None) -> list[Finding]:
    device = _device_of(args)
    probe = probe or run_probed(fn, args, device=device)
    reads = list(dict.fromkeys(probe.host_reads))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                fn(*args)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            reads.append("a synchronizing CUDA operation (set_sync_debug_mode)")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not reads:
        return []
    return [Finding(
        check="dispatch.host-sync", where=label,
        message=(f"{label}: host read(s) inside the entry point: "
                 f"{', '.join(reads[:4])} — the host waits for the card "
                 f"on every search"))]


def check_recompile_stability(dispatch: Callable[[int], Callable[[], object]],
                              sweep: Sequence[int], label: str,
                              device: str = "cpu") -> list[Finding]:
    """``dispatch(live_rows)`` appends ``live_rows`` rows and returns the
    search to run; each search's top-k calls must keep the first one's
    signatures, and none may read the host."""
    sigs, reads = [], []
    for live in sweep:
        search = dispatch(live)
        with torch.no_grad(), Probe(device) as probe:
            search()
        sigs.append([c.signature() for c in probe.calls])
        reads += probe.host_reads
    findings = []
    changed = [i for i, s in enumerate(sigs) if s != sigs[0]]
    if changed:
        i = changed[0]
        findings.append(Finding(
            check="dispatch.recompile", where=label,
            message=(f"{label}: the top-k calls changed across a live-count "
                     f"sweep ({len(sigs[0])} calls at live step 0, "
                     f"{len(sigs[i])} at step {i}, shapes "
                     f"{[s for s in sigs[i] if s not in sigs[0]][:2]}): a live "
                     f"quantity leaked into an operand shape, so a captured "
                     f"graph cannot replay as the index grows")))
    if reads:
        findings.append(Finding(
            check="dispatch.recompile", where=f"{label}:host-read",
            message=(f"{label}: the swept searches read the host "
                     f"({sorted(set(reads))[:3]}): a captured graph would bake "
                     f"the value in")))
    return findings


# ---------------------------------------------------------------------------
# the port's serving entry points, on small seeded corpora
# ---------------------------------------------------------------------------


def _tiny(n=600, d=32, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((B, d)).astype(np.float32))


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One serving entry point, shared by the dispatch lints, the cost
    model and the invariants.

    ``fn(*args)`` runs one search. ``expected_calls`` is its top-k
    contract; ``storage_dtype`` is set where the upcast check applies (an
    int8 or bf16 index); ``bench_key`` names the row of a measured file
    this entry stands for (the cost cross-check); ``family`` groups
    entries whose costs are compared; ``priced`` is False where the host
    does the staging (host-tier pages), which the cost model leaves out;
    ``index`` and ``projection`` (W, mean) are what ``fn`` searches with."""

    label: str
    fn: Callable
    args: tuple
    expected_calls: int
    corpus_shape: tuple[int, int]
    family: str
    storage_dtype: str | None = None
    strip_rows: int = STRIP_ROWS
    bench_key: str | None = None
    batch: int = 4
    priced: bool = True
    index: object = None
    projection: tuple = ()


def _search(index, W, mean, k=10):
    return lambda q: index.search_projected(q, W, k=k, mean=mean)


def _paged_calls(pidx) -> int:
    """Top-k calls of a paged search: one a device run, one a host wave."""
    return sum(1 if dev else len(pidx._waves(lo, hi)) for lo, hi, dev in pidx._runs())


def _paged_rescore_calls(pidx) -> int:
    """Calls of a paged rescore: one for a float index, one an extent with
    rows for an int8 one (each folds its own scale)."""
    st = pidx.storage
    return 1 if st.page_scale is None else sum(1 for e in st.extents if e.n_rows)


def serving_entry_points(device: str = "cpu") -> tuple[EntryPoint, ...]:
    """Every serving entry point on the small synthetic corpus, on
    ``device``: dense, cascade (dense, paged, host-tier paged, segmented),
    sharded (flat and hierarchical over four slots), segmented and paged
    (device-resident and with a host tier), f32 and int8."""
    from repro_torch.core.cascade import CascadeIndex
    from repro_torch.core.index import DenseIndex, SegmentedIndex, ShardedDenseIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.par.mesh import make_mesh

    dev = torch.device(device)
    Dn, Qn = _tiny()
    D = torch.from_numpy(Dn).to(dev)
    Q = torch.from_numpy(Qn).to(dev)
    pruner = StaticPruner(cutoff=0.5).fit(D)
    Dh = pruner.prune_index(D)
    W, mean = pruner.projection()
    n, m = Dh.shape
    B = Q.shape[0]
    entries: list[EntryPoint] = []

    def add(label, index, expected, family, *, int8=False, bench=False, priced=True,
            storage=None):
        entries.append(EntryPoint(
            label=label, fn=_search(index, W, mean), args=(Q,), expected_calls=expected,
            corpus_shape=(n, m), family=family,
            storage_dtype=storage or ("int8" if int8 else None),
            strip_rows=SMALL_STRIP_ROWS,
            bench_key=label if bench else None, batch=B, priced=priced, index=index,
            projection=(W, mean)))

    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        add(f"DenseIndex.search_projected[{tag}]",
            DenseIndex.build(Dh, quantize_int8=int8), 1, "dense", int8=int8, bench=True)
    add("DenseIndex.search_projected[bf16]", DenseIndex.build(Dh, dtype=torch.bfloat16), 1,
        "dense-bf16", storage="bfloat16")

    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        cas = CascadeIndex.build(Dh, m_coarse=max(2, m // 2), n_factor=2,
                                 quantize_int8=int8)
        add(f"CascadeIndex.search_projected[{tag}]", cas, 2, "cascade", int8=int8)

    mesh = make_mesh((4,), ("data",), device)
    for merge in ("flat", "hierarchical"):
        mesh_m = mesh if merge == "flat" else make_mesh((2, 2), ("data", "model"), device)
        for int8 in (False, True):
            tag = "int8" if int8 else "f32"
            sidx = ShardedDenseIndex.build(Dh, mesh_m, quantize_int8=int8, merge=merge)
            add(f"ShardedDenseIndex.search_projected[{merge},{tag}]", sidx, mesh_m.size,
                "sharded" if merge == "flat" else "sharded-hier", int8=int8,
                bench=merge == "flat")

    rng = np.random.default_rng(3)
    seg = SegmentedIndex.from_index(DenseIndex.build(Dh, quantize_int8=True),
                                    delta_capacity=64)
    seg = seg.append(rng.standard_normal((70, m)).astype(np.float32))
    nd = len(seg.deltas)
    add(f"SegmentedIndex.search_projected[int8,{nd}d]", seg, 1 + nd, "segmented")

    rng_p = np.random.default_rng(11)
    for int8 in (False, True):
        tag = "int8" if int8 else "f32"
        pidx = PagedIndex.from_index(DenseIndex.build(Dh, quantize_int8=int8),
                                     page_rows=64, seal_rows=128)
        pidx = pidx.append(rng_p.standard_normal((70, m)).astype(np.float32))
        add(f"PagedIndex.search_projected[{tag}]", pidx, _paged_calls(pidx), "paged",
            int8=int8)
    host = PagedIndex.from_index(DenseIndex.build(Dh, quantize_int8=True), page_rows=64,
                                 pool_pages=4, seal_rows=128, wave_pages=2)
    add("PagedIndex.search_projected[host,int8]", host, _paged_calls(host), "paged-host",
        int8=True, priced=False)

    rng_pc = np.random.default_rng(13)
    base = CascadeIndex.build(Dh, m_coarse=max(2, m // 2), n_factor=2, quantize_int8=True)
    pcas = base.paged(page_rows=64, seal_rows=128)
    pcas = pcas.append(rng_pc.standard_normal((70, m)).astype(np.float32))
    add("CascadeIndex.search_projected[paged,int8]", pcas,
        _paged_calls(pcas.coarse) + _paged_rescore_calls(pcas.full), "cascade-paged")
    hcas = base.paged(page_rows=64, seal_rows=128, pool_pages=4, coarse_pool_pages=4,
                      wave_pages=2)
    add("CascadeIndex.search_projected[paged-host,int8]", hcas,
        _paged_calls(hcas.coarse) + _paged_rescore_calls(hcas.full), "cascade-paged-host",
        priced=False)

    rng_c = np.random.default_rng(7)
    cseg = base.segmented(delta_capacity=64)
    cseg = cseg.append(rng_c.standard_normal((70, m)).astype(np.float32))
    cnd = len(cseg.full.deltas)
    add(f"CascadeIndex.search_projected[seg,int8,{cnd}d]", cseg, 2 * (1 + cnd),
        "cascade-seg")
    return tuple(entries)


def lint_entry(ep: EntryPoint) -> list[Finding]:
    """The three per-search checks of one entry point (one probed run,
    plus a run under the sync debug mode on the card)."""
    device = _device_of(ep.args)
    strip = min(ep.strip_rows, ep.corpus_shape[0]) * ep.corpus_shape[1]
    probe = run_probed(ep.fn, ep.args, device=device, strip_elems=strip)
    findings = check_dispatch_count(ep.label, ep.fn, ep.args, ep.expected_calls, probe)
    findings += check_host_sync(ep.label, ep.fn, ep.args, probe)
    if ep.storage_dtype is not None:
        findings += check_upcast(ep.label, ep.fn, ep.args, ep.corpus_shape, ep.strip_rows,
                                 probe)
    return findings


def live_sweeps(device: str = "cpu") -> list[tuple[str, Callable, list[int]]]:
    """(label, dispatch, sweep) for the live indexes: appends inside the
    open delta's capacity (or the open tail page's), each followed by the
    search whose calls are compared."""
    from repro_torch.core.cascade import CascadeIndex
    from repro_torch.core.index import DenseIndex, SegmentedIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.pruning import StaticPruner

    dev = torch.device(device)
    Dn, Qn = _tiny()
    D, Q = torch.from_numpy(Dn).to(dev), torch.from_numpy(Qn).to(dev)
    pruner = StaticPruner(cutoff=0.5).fit(D)
    Dh = pruner.prune_index(D)
    W, mean = pruner.projection()
    m = Dh.shape[1]
    rng = np.random.default_rng(3)
    sweep = [1, 2, 3, 5, 1]

    def grower(index, attr_rng):
        state = {"ix": index}

        def dispatch(live_rows: int):
            state["ix"] = state["ix"].append(
                attr_rng.standard_normal((live_rows, m)).astype(np.float32))
            ix = state["ix"]
            return lambda: ix.search_projected(Q, W, k=5, mean=mean)
        return dispatch

    seg = SegmentedIndex.from_index(DenseIndex.build(Dh, quantize_int8=True),
                                    delta_capacity=64)
    seg = seg.append(rng.standard_normal((70, m)).astype(np.float32))
    cseg = CascadeIndex.build(Dh, m_coarse=max(2, m // 2), n_factor=2,
                              quantize_int8=True).segmented(delta_capacity=64)
    cseg = cseg.append(rng.standard_normal((70, m)).astype(np.float32))
    pg = PagedIndex.from_index(DenseIndex.build(Dh, quantize_int8=True), page_rows=64,
                               seal_rows=128)
    pg = pg.append(rng.standard_normal((40, m)).astype(np.float32))
    return [("SegmentedIndex.append+search_projected", grower(seg, rng), sweep),
            ("CascadeIndex.append+search_projected", grower(cseg, rng), sweep),
            ("PagedIndex.append+search_projected", grower(pg, rng), sweep)]


def run(device: str = "cpu") -> list[Finding]:
    """Lint every serving entry point and the live sweeps on ``device``."""
    findings: list[Finding] = []
    for ep in serving_entry_points(device):
        findings += lint_entry(ep)
    for label, dispatch, sweep in live_sweeps(device):
        findings += check_recompile_stability(dispatch, sweep, label, device)
    return findings


def strip_elems(corpus_shape: tuple[int, int], strip_rows: int = STRIP_ROWS) -> int:
    return min(strip_rows, corpus_shape[0]) * corpus_shape[1]


__all__ = ["EntryPoint", "Probe", "KernelCall", "STRIP_ROWS", "check_dispatch_count",
           "check_upcast", "check_host_sync", "check_recompile_stability", "lint_entry",
           "live_sweeps", "run", "run_probed", "serving_entry_points", "strip_elems"]
