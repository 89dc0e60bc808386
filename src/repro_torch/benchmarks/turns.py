"""Another build of the port's kernels beside this tree's, and the timers
that compare the two in turns (``topk_large_k.py``, ``small_calls.py``).

``load_other(tree, out, names)`` compiles TREE's
``src/repro_torch/csrc/<name>.cu`` (one ``nvcc`` each, all started
together) into ``out`` and loads TREE's own wrapper module
``src/repro_torch/kernels/<name>.py`` bound to that library. The other
build is then called through its own Python entry points, with its own C
signatures and launch plans, so any tree of the port can be compared with
this one, and its eager times include its own host code. ``edit`` rewrites
a source's text before it is compiled (a constant changed for a variant).

Times are CUDA events: ``cuda_ms`` the mean of R eager calls after one
warmup (host work between the calls counts), ``graph_ms`` one call's
device time from R calls captured in one CUDA graph and replayed, and
``in_turns`` the two builds in the order other, this, this, other.
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import types
from pathlib import Path


def load_other(tree: Path, out: Path, names, edit=None) -> types.SimpleNamespace:
    """TREE's wrapper modules ``names``, each bound to its source built into
    ``out``; exits if a build fails."""
    from repro_torch.kernels import _build
    csrc = tree / "src/repro_torch/csrc"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = csrc / f"{name}.cu"
        if edit is not None:
            cu = out / cu.name
            cu.write_text(edit(name, (csrc / cu.name).read_text()))
        so = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(name, ()), "-I",
             str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    mods = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"turns: nvcc failed for {csrc / name}.cu:\n{log}")
        (out / f"{name}.ptxas.txt").write_text(log)
        mods[name] = _bound(tree / "src/repro_torch/kernels" / f"{name}.py",
                            ctypes.CDLL(str(so)), f"_other_{out.name}_{name}")
    return types.SimpleNamespace(**mods)


def _bound(path: Path, lib: ctypes.CDLL, module_name: str) -> types.ModuleType:
    """The wrapper module at ``path``, its ``_build.load`` returning ``lib``."""
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for fn, (restype, argtypes) in mod._SIGNATURES.items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    build = types.ModuleType(f"{module_name}_build")
    build.__dict__.update({k: v for k, v in vars(_build).items() if not k.startswith("__")})
    build.load = lambda name, signatures: lib
    mod._build = build
    return mod


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` eager calls after one warmup."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls in one CUDA graph,
    replayed, the replay's time over ``reps``. No host work runs between the
    calls, so where ``cuda_ms`` of the same call is longer, the difference
    is the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, 5) / reps
    del graph
    return ms


def in_turns(this, other, reps: int) -> tuple[list[float], list[float]]:
    """``cuda_ms`` of ``this`` and of ``other`` in the order other, this,
    this, other: (this's two times, other's two)."""
    times = {"this": [], "other": []}
    for turn in ("other", "this", "this", "other"):
        times[turn].append(cuda_ms(this if turn == "this" else other, reps))
    return times["this"], times["other"]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
