"""Resource check of the port's hand-written kernels on the card
(counterpart of ``repro/analysis/pallas_budget.py``: VMEM becomes shared
memory and registers).

For every kernel of ``src/repro_torch/csrc`` (every template instance),
from the built libraries:

  * ``cudaFuncGetAttributes`` through each source's ``<name>_kernel_attrs``
    C entry (``common.cuh``): registers a thread, static shared bytes,
    local bytes, and the threads and dynamic shared bytes a launch gives
    it at the entry points' widths (16, 384 and 768: the chunk kernel's
    tile grows with m up to its 384-wide panel);
  * registers, static shared memory and spills from ``ptxas -v``
    (``_build.ptxas_summary`` of the report the build keeps).

Findings:

  * ``budget.smem`` (error): static + dynamic shared bytes above the
    card's opt-in limit a block (232,448 bytes, 227 KiB, on an H100): the
    launch would fail;
  * ``budget.registers`` (error): more than 255 registers a thread, or
    threads x registers above the 65,536-register file: it would not launch;
  * ``budget.spill`` (warn): nonzero ptxas spill bytes: local-memory
    traffic, a cost and not a failure (as the reference warns on
    alignment);
  * ``budget.grid`` (error): a call whose ``gridDim.y`` exceeds 65,535:
    the top-k wrappers' query groups (``_group`` / ``MAX_GROUP``, one query
    a ``gridDim.y`` in the merge and select) at B up to 200,000, and the
    Gram's ranges (``gridDim.y``) at the full corpus;
  * ``budget.alignment`` (error): a top-k call that takes the 16-byte
    vector path on a pointer not 16-byte aligned or with m % 16 != 0 (the
    wrappers decide ``vec``; ``gram`` and ``pca_project`` decide it on the
    device side). The C entries' ``vec`` argument is recorded over aligned
    and deliberately misaligned calls.

``pallas.index-map`` has no counterpart: CUDA kernels have no index maps,
each computes its own addresses. Without a card or ``nvcc`` (or with
``--device cpu``) the pass reports one warn, ``budget.not-run``, with the
reason, and never a pass.
"""
from __future__ import annotations

import contextlib
import ctypes
import re

from repro_torch.analysis import Finding

SMEM_OPTIN = 232_448            # H100: shared bytes a block may opt in to
REG_LIMIT = 255
REG_FILE = 65_536
GRID_Y_LIMIT = 65_535
WIDTHS = (16, 384, 768)
SOURCES = ("gram", "pca_project", "topk_score")
_ATTRS = ("registers", "static_smem", "max_dynamic_smem", "local_bytes",
          "max_threads", "threads", "dynamic_smem")


def not_run_reason(device: str = "cuda") -> str | None:
    """Why the pass cannot run here, or None."""
    import torch
    if device != "cuda":
        return f"the run asked for device {device!r}; the budget needs the card"
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is False)"
    try:
        from repro_torch.kernels import _build
        _build.nvcc()
    except RuntimeError as e:
        return str(e)
    return None


def _load(source: str):
    from repro_torch.kernels import _build, gram, pca_project, topk_score
    sigs = {"gram": gram._SIGNATURES, "pca_project": pca_project._SIGNATURES,
            "topk_score": topk_score._SIGNATURES}[source]
    lib = _build.load(source, sigs)
    fn = getattr(lib, f"{source}_kernel_attrs")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                   ctypes.POINTER(ctypes.c_int)]
    return lib, fn


def kernel_table(widths=WIDTHS) -> list[dict]:
    """One row a kernel: its source, name, ``cudaFuncGetAttributes`` and the
    largest dynamic shared memory a launch asks for over ``widths``."""
    rows = []
    for source in SOURCES:
        _, fn = _load(source)
        i = 0
        while True:
            name = ctypes.c_char_p()
            best = None
            for m in widths:
                attrs = (ctypes.c_int * len(_ATTRS))()
                rc = fn(i, m, ctypes.byref(name), attrs)
                if rc == -1:
                    break
                if rc != 0:
                    raise RuntimeError(f"{source}_kernel_attrs({i}): CUDA error {rc}")
                row = dict(zip(_ATTRS, list(attrs)))
                if best is None or row["dynamic_smem"] > best["dynamic_smem"]:
                    best = dict(row, width=m)
            if best is None:
                break
            rows.append(dict(source=source, kernel=name.value.decode(), **best))
            i += 1
    return rows


_NAME_RE = re.compile(r"\d+([a-z][a-z_]*_kernel)")
_TARGS_RE = re.compile(r"_kernelI(\w+?)EEv")


def ptxas_rows() -> list[dict]:
    """Registers, static shared memory and spills of every compiled kernel,
    from the build's kept ``ptxas -v`` reports."""
    from repro_torch.kernels import _build
    rows = []
    for source in SOURCES:
        path = _build.report_path(source)
        if not path.exists():
            _build.build((source,))
        for fn in _build.ptxas_summary(path.read_text()):
            mangled = fn.pop("function")
            name = _NAME_RE.search(mangled)
            targs = _TARGS_RE.search(mangled)
            rows.append(dict(source=source, kernel=(name.group(1) if name else mangled)
                             + (f"<{targs.group(1)}>" if targs else ""), **fn))
    return rows


def resource_findings(table: list[dict], ptxas: list[dict],
                      smem_limit: int = SMEM_OPTIN) -> list[Finding]:
    findings = []
    for r in table:
        where = f"{r['source']}:{r['kernel']}"
        smem = r["static_smem"] + r["dynamic_smem"]
        if smem > smem_limit:
            findings.append(Finding(
                check="budget.smem", where=where,
                message=(f"{where}: {smem:,} shared bytes a block ({r['static_smem']:,} "
                         f"static + {r['dynamic_smem']:,} dynamic at m {r['width']}) "
                         f"exceed the {smem_limit:,}-byte opt-in limit: the launch "
                         f"fails")))
        regs = r["registers"]
        if regs > REG_LIMIT or regs * r["threads"] > REG_FILE:
            findings.append(Finding(
                check="budget.registers", where=where,
                message=(f"{where}: {regs} registers x {r['threads']} threads "
                         f"= {regs * r['threads']:,} (limits {REG_LIMIT} a thread, "
                         f"{REG_FILE:,} a block)")))
    for r in ptxas:
        spill = r["spill_store_bytes"] + r["spill_load_bytes"]
        if spill:
            where = f"{r['source']}:{r['kernel']}"
            findings.append(Finding(
                check="budget.spill", where=where, severity="warn",
                message=(f"{where}: {r['spill_store_bytes']} bytes of spill stores and "
                         f"{r['spill_load_bytes']} of spill loads at {r['registers']} "
                         f"registers: local-memory traffic in the mainloop")))
    return findings


def grid_findings() -> list[Finding]:
    """Query groups of the top-k wrappers and the Gram's ranges against the
    65,535 limit of ``gridDim.y``."""
    import torch
    from repro_torch.kernels import topk_score as T
    findings = []
    for n, k in ((8_841_823, 10), (8_841_823, 100), (4096, 2048), (100_000, 10_000)):
        for B in (1, 32, 65_535, 65_537, 200_000):
            G = T._group(B, lambda b, n=n, k=k: T.topk_plan(n, k, b)[0])
            worst = max(G, -(-G // 32))           # merge / select rows, chunk tiles
            if worst > GRID_Y_LIMIT:
                findings.append(Finding(
                    check="budget.grid", where=f"topk_score:n{n}:k{k}:B{B}",
                    message=(f"topk_score at n {n}, k {k}, B {B}: a call of {G} queries "
                             f"puts {worst} rows on gridDim.y (limit {GRID_Y_LIMIT})")))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, d in ((8_841_823, 768), (100_000, 768), (1_000_448, 256)):
        splits = _load("gram")[0].gram_splits(n, d, sms)
        if splits > GRID_Y_LIMIT:
            findings.append(Finding(
                check="budget.grid", where=f"gram:n{n}:d{d}",
                message=f"gram at {n} x {d}: {splits} ranges on gridDim.y"))
    return findings


@contextlib.contextmanager
def _recording_vec(calls: list):
    """Record (pointers, m, vec) of every dense and paged C call."""
    lib, _ = _load("topk_score")
    real_dense, real_paged = lib.topk_score_f32, lib.topk_score_paged_f32

    def dense(*a):
        calls.append(("dense", (a[0],), a[4], a[10]))
        return real_dense(*a)

    def paged(*a):
        calls.append(("paged", tuple(p for p in (a[0], a[1], a[5]) if p), a[13], a[19]))
        return real_paged(*a)

    lib.topk_score_f32, lib.topk_score_paged_f32 = dense, paged
    try:
        yield
    finally:
        lib.topk_score_f32, lib.topk_score_paged_f32 = real_dense, real_paged


def alignment_findings(extra=()) -> list[Finding]:
    """The top-k wrappers' ``vec`` choice over aligned and misaligned
    operands (and ``extra`` callables, e.g. the entry points' searches)."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, 384), device=dev, generator=g)
    cases = []
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        full = torch.randn((2049 * 384 + 16,), device=dev, generator=g).to(dtype)
        for off in (0, 1, 8):                      # elements: aligned, then not
            D = full[off:off + 2049 * 384].view(2049, 384)
            cases.append((D, q))
        odd = torch.randn((700, 100), device=dev, generator=g).to(dtype)
        cases.append((odd, torch.randn((4, 100), device=dev, generator=g)))
    calls: list = []
    with _recording_vec(calls):
        for D, Q in cases:
            ops.topk_score(D, Q, k=10)
        for fn in extra:
            fn()
    torch.cuda.synchronize()
    bad = [(kind, m, [p % 16 for p in ptrs]) for kind, ptrs, m, vec in calls
           if vec and (m % 16 or any(p % 16 for p in ptrs))]
    if not bad:
        return []
    return [Finding(
        check="budget.alignment", where="topk_score",
        message=(f"{len(bad)} top-k call(s) took the 16-byte vector path on "
                 f"misaligned operands (kind, m, pointer % 16): {bad[:3]}"))]


def run(device: str = "cuda", extra=()) -> list[Finding]:
    reason = not_run_reason(device)
    if reason is not None:
        return [Finding(check="budget.not-run", where="kernels", severity="warn",
                        message=f"kernel budget not checked: {reason}")]
    import torch
    limit = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                    SMEM_OPTIN)
    findings = resource_findings(kernel_table(), ptxas_rows(), smem_limit=limit)
    findings += grid_findings()
    findings += alignment_findings(extra)
    return findings


__all__ = ["run", "kernel_table", "ptxas_rows", "resource_findings", "grid_findings",
           "alignment_findings", "not_run_reason"]
