"""One run of one cell: set-up, the open-loop window, the check, the result.

1. Draw the corpus and the query tape on the device from the seed
   (``data.py``), and the arrival times on the host (``traffic.py``).
2. Build the index through the port's own path: ``StaticPruner.fit``,
   ``prune_index``, ``DenseIndex.build``.
3. Start ``RetrievalServer`` with the pruner attached and warm it up on the
   cell's batch shapes.
4. Submit the tape open loop for the window. A request's latency runs from
   its scheduled arrival to its reply's ``completed_at`` (the copy of the
   port's ``_drive_open`` timing, without a thread per reply).
5. Close the server, read its counters and the memory peak, free the
   program's state, and judge a seeded sample of replies against the
   reference (``reference.py``, ``compare.py``), and the program's fit
   against the fp64 eigendecomposition of the same corpus.

With ``trace`` a slice of the window runs under ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import queue
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench import compare, data, devtrace, traffic
from bench.proxy import TracedIndex
from bench.reference import Reference, Spectrum
from bench.spec import ROOT, Cell, load_cell

SAMPLE = 512          # replies judged a run
DRAIN_S = 60.0        # how long past the window's close a reply may come
SLICE_S = 2.0         # seconds of the window under the profiler
WARMUPS = 2           # warm-up passes over the cell's batch shapes


class RunError(RuntimeError):
    """The run cannot give a result."""


class NoDevice(RunError):
    """No card, or fewer cards than the cell asks for."""


@dataclasses.dataclass
class Record:
    """What the metric readers (``metrics/<name>.py``) read."""
    cell: Cell
    setup_s: float
    t0: float                  # the window's start (perf_counter)
    sched: np.ndarray          # scheduled arrivals, seconds after t0
    submit: np.ndarray         # when each submit began (perf_counter)
    done: np.ndarray           # each reply's completed_at; nan if none came
    batch_log: list            # (size, t_dispatch, t_done) of the window's batches
    worker: dict               # RetrievalServer.worker_stats()
    cuda_launches: int         # topk_score CUDA launches during the window
    shapes: dict               # n, m, d, k, store of the served index
    trace: devtrace.Trace | None = None
    profiled: tuple[float, float] | None = None   # the profiler's slice, seconds after t0


def process_age() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None
    return age if 0 <= age < 120 else None


def devices(cell: Cell) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"cell {cell.name} needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def topk_cuda_launches() -> int:
    from repro_torch.kernels.topk_score import topk_score_cuda
    return int(sum(topk_score_cuda.cuda_launches.values()))


@dataclasses.dataclass
class Deployment:
    index: object
    pruner: object
    fingerprint: float
    shapes: dict


def build(cell: Cell, gen: torch.Generator, device: torch.device, fit_rows=None
          ) -> tuple[Deployment, torch.Tensor]:
    """The corpus drawn from ``gen`` and the index built from it through the
    port's path; returns the deployment and the corpus. ``fit_rows`` (tests)
    picks the rows the pruner is fitted on: ``fit_rows(D)``."""
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.pruning import StaticPruner

    cfg = cell.config
    D = data.corpus(cfg, gen, device)
    pruner = StaticPruner(cutoff=float(cfg["cutoff"])).fit(
        D if fit_rows is None else fit_rows(D))
    pruned = pruner.prune_index(D)
    index = DenseIndex.build(pruned, quantize_int8=cfg["store"] == "int8")
    del pruned
    if pruner.kept_dims != int(cfg["m"]):
        raise RunError(f"the pruner kept {pruner.kept_dims} dims, the config says {cfg['m']}")
    shapes = dict(n=int(D.shape[0]), d=int(D.shape[1]), m=int(cfg["m"]),
                  k=int(cell.traffic["k"]), store=cfg["store"])
    return Deployment(index, pruner, fingerprint(D), shapes), D


def fingerprint(D: torch.Tensor) -> float:
    return float(D[::4099].double().sum())


def start_server(cell: Cell, dep: Deployment, wrap=None, traced: bool = False):
    """The port's server over the deployment, warmed up on the cell's batch
    shapes; ``wrap`` (tests) replaces the index, ``traced`` names each
    search call for the profiler (``proxy.py``)."""
    from repro_torch.launch.serve import RetrievalServer

    target = dep.index if wrap is None else wrap(dep.index)
    target = TracedIndex(target) if traced else target
    s = cell.server
    server = RetrievalServer(target, dep.pruner, k=int(cell.traffic["k"]),
                             max_batch=int(s["max_batch"]),
                             pipeline_depth=int(s["pipeline_depth"]),
                             bucket_batches=bool(s["bucket_batches"]))
    for _ in range(WARMUPS):
        server.warmup()
    return server, target


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:   # an older torch profiles the starting thread only
        cfg = None
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def drive(server, tape: np.ndarray, sched: np.ndarray, *, keep=(), prof=None,
          slice_at: tuple[float, float] | None = None) -> dict:
    """Submit ``tape[i]`` at ``t0 + sched[i]`` for every i, then wait for
    every reply; with ``prof``, profile the window's slice ``slice_at``.

    Between submits the generator takes each answered reply off its hands,
    oldest first, keeping its ``completed_at`` and, for the indices in
    ``keep``, its answer: a client does not hold its answered futures, and
    a hundred thousand of them would make the collector's full passes
    stall every thread of the process."""
    n = len(sched)
    replies: list = [None] * n
    submit = np.empty(n)
    done = np.full(n, np.nan)
    keep = set(int(i) for i in keep)
    payload: dict = {}
    oldest = 0

    def take(i, wait: float | None = None) -> bool:
        """Record reply i if it has come (within ``wait`` seconds); False if
        it has not."""
        r = replies[i]
        if not isinstance(r, BaseException):
            try:
                out = r.get_nowait() if wait is None else r.get(timeout=wait)
            except queue.Empty:
                return False
            if not isinstance(out, BaseException) and r.completed_at is not None:
                done[i] = r.completed_at
                if i in keep:
                    payload[i] = out
        replies[i] = None
        return True

    state = "off" if prof is not None else "done"
    t0 = time.perf_counter()
    due = t0 + sched
    for i in range(n):
        if state == "off" and sched[i] >= slice_at[0]:
            prof.start()
            with torch.profiler.record_function("bench.slice_start"):
                state = "on"
        elif state == "on" and sched[i] >= slice_at[1]:
            with torch.profiler.record_function("bench.slice_end"):
                state = "done"
            prof.stop()
        while oldest < i and take(oldest):
            oldest += 1
        delay = due[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        submit[i] = time.perf_counter()
        try:
            replies[i] = server.submit(tape[i])
        except Exception as e:   # noqa: BLE001 — a refused request is a failed one
            replies[i] = e
    if state == "on":
        with torch.profiler.record_function("bench.slice_end"):
            pass
        prof.stop()
    give_up = max(time.perf_counter(), t0 + float(sched[-1])) + DRAIN_S
    for i in range(oldest, n):
        if not take(i, wait=max(0.0, give_up - time.perf_counter())):
            replies[i] = None       # never came: stays nan in ``done``
    return dict(t0=t0, submit=submit, done=done, payload=payload)


def settle() -> None:
    """Collect set-up's garbage and freeze what is left, as a Python server
    does after warming up: the collector's full passes then skip the
    imports' and set-up's objects (hundreds of thousands: a pass over them
    stops every thread for about a tenth of a second) and see only what the
    window makes."""
    gc.collect()
    gc.freeze()


class GCWatch:
    """Counts the collector's full (generation 2) passes and their time
    while it is on: a pass stops every thread of the process."""

    def __init__(self):
        self.passes, self.seconds, self._t = 0, 0.0, None

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.passes += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def read_trace(prof) -> devtrace.Trace | None:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return devtrace.parse(json.load(f))
    finally:
        os.remove(path)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def sample(seed: int, n: int) -> np.ndarray:
    """The requests whose answers are judged: drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5A3])
    return np.sort(rng.choice(n, size=min(SAMPLE, n), replace=False))


def judge(cell: Cell, seed: int, device: torch.device, tape: np.ndarray,
          drove: dict, fp: float, W: torch.Tensor) -> dict[str, float]:
    """``unanswered`` over the window, the comparison's readings over the
    answered requests of the seed's sample under the program's ``W_m``, and
    that ``W_m``'s readings against the fp64 spectrum of the corpus."""
    answered = int((~np.isnan(drove["done"])).sum())
    pick = np.array(sorted(drove["payload"]), dtype=np.int64)
    values = dict(unanswered=float(len(tape) - answered))
    if len(pick) == 0:
        return dict(values, malformed=float("inf"), score_gap=float("inf"),
                    rank_gap=float("inf"), shortfall=float("inf"), leak=float("inf"))
    scores = np.stack([drove["payload"][i][0] for i in pick]).astype(np.float32)
    ids = np.stack([drove["payload"][i][1] for i in pick]).astype(np.int64)
    D = data.corpus(cell.config, data.generator(seed, device), device)
    if fingerprint(D) != fp:
        raise RunError("the corpus drawn again for the reference differs from the served one")
    ref = Reference(D, W, store=cell.config["store"])
    Q = torch.as_tensor(tape[pick], device=device)
    values.update(compare.readings(scores, ids, Q, ref, int(cell.traffic["k"])))
    del ref
    values.update(Spectrum(D).readings(W))
    return values


def finite(x):
    return x if x is None or np.isfinite(x) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device: torch.device | None = None, wrap=None, fit_rows=None,
             t_start: float | None = None) -> dict:
    """One run; returns the result's line as a dict (``checks`` last).

    ``device`` None means the card (checked); tests pass the CPU and a
    ``wrap`` that breaks the served index or ``fit_rows`` that breaks the
    fit."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    device = devices(cell) if device is None else device
    import repro_torch  # noqa: F401  (the program's fp32 policy)

    gen = data.generator(seed, device)
    dep, D = build(cell, gen, device, fit_rows)
    offsets = traffic.arrivals(cell.traffic, cell.rate, seconds, seed)
    tape = data.queries(D, len(offsets), float(cell.traffic["query_noise"]),
                        gen).cpu().numpy()
    del D
    if device.type == "cuda":
        torch.cuda.empty_cache()
    server, target = start_server(cell, dep, wrap, traced=trace)
    prof = None
    if trace:
        warm = profiler(device)        # the profiler's own first start
        warm.start()
        warm.stop()
        prof = profiler(device)
    sync(device)
    settle()
    try:
        launches0 = topk_cuda_launches()
        server.reset_stats()
        if isinstance(target, TracedIndex):
            target.reset()
        setup_s = time.perf_counter() - t_start
        slice_at = (seconds / 2 - SLICE_S / 2, seconds / 2 + SLICE_S / 2)
        with GCWatch() as gcw:
            drove = drive(server, tape, offsets, keep=sample(seed, len(offsets)), prof=prof,
                          slice_at=slice_at)
    finally:
        server.close()
        gc.unfreeze()
    worker = server.worker_stats()
    log = list(server.batch_log)
    if server.error is not None:
        raise RunError(f"server worker failed: {server.error!r}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(cell=cell, setup_s=setup_s, t0=drove["t0"],
                 sched=offsets, submit=drove["submit"], done=drove["done"],
                 batch_log=log, worker=worker,
                 cuda_launches=topk_cuda_launches() - launches0, shapes=dep.shapes,
                 trace=read_trace(prof) if prof is not None else None,
                 profiled=slice_at if prof is not None else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader(cell.root)(rec)
        if value is not None and np.isfinite(value):
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    fp, W = dep.fingerprint, dep.pruner.projection()[0].detach().clone()
    if W.shape != (dep.shapes["d"], dep.shapes["m"]):
        raise RunError(f"the fit's W_m is {tuple(W.shape)}")
    del server, target, dep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = judge(cell, seed, device, tape, drove, fp, W)
    correct, checks = compare.verdict(values, cell.config["limits"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    if device.type == "cuda":
        dev["power"] = power_limit()
    out = dict(correct=correct, attempted=len(offsets),
               failed=int(values["unanswered"]), metrics=metrics, device=dev)
    if trace and rec.trace is not None:
        dev.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in rec.trace.device_ops],
                            "idle_gaps": [list(x) for x in rec.trace.idle_gaps]}
    late = drove["submit"] - (drove["t0"] + offsets)
    out["host"] = dict(gc_full_passes=gcw.passes, gc_full_s=gcw.seconds,
                       late_max_ms=float(late.max()) * 1e3,
                       batch_max_ms=max((t1 - t0 for _, t0, t1 in log), default=0.0) * 1e3)
    out["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out
