"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>.so`` at the repository root, for ``sm_90a`` (Hopper).
The build happens at first use in a process, or up front with ``build()``,
which starts one ``nvcc`` per source at once. Nothing here runs at import:
this module imports on machines without ``nvcc`` or a card.

Every C entry returns a ``cudaError_t`` (0 on success); ``check`` raises on
anything else. A refused launch (too many threads, too much shared memory)
never runs and no later synchronise reports it, so the code is read right
after each launch.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gram", "pca_project", "topk_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def report_path(name: str) -> Path:
    """The ``ptxas -v`` report of the last build of ``name``."""
    return BUILD_DIR / f"{name}.ptxas.txt"


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))


def build(names=SOURCES) -> dict[str, str]:
    """Compile ``names``, one ``nvcc`` each, all started together.

    Returns each source's compiler output (the ``ptxas -v`` report), also
    kept beside the library (``report_path``) for the resource check.
    Raises if any build fails. Each library is written under a temporary
    name and renamed into place, so concurrent processes never load a
    partial file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    reports, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                          f"\n{out}")
        else:
            report_path(name).write_text(out)
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or older than
    its sources. ``signatures`` maps each C entry to ``(restype,
    argtypes)``; pointers and the stream must be ``c_void_p`` or ctypes
    would pass them as 32-bit ints."""
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t) at launch")


_FN_RE = re.compile(r"Compiling entry function '(\w+)'")
_USE_RE = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                     r"(?:, (\d+) bytes smem)?")
_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_summary(report: str) -> list[dict]:
    """Per compiled kernel: registers, static shared memory and spills, as
    ``ptxas -v`` reported them."""
    out, cur = [], None
    for line in report.splitlines():
        if m := _FN_RE.search(line):
            cur = dict(function=m.group(1), registers=None, smem_bytes=0,
                       spill_store_bytes=0, spill_load_bytes=0)
            out.append(cur)
        elif cur is not None and (m := _SPILL_RE.search(line)):
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        elif cur is not None and (m := _USE_RE.search(line)):
            cur["registers"] = int(m.group(1))
            cur["smem_bytes"] = int(m.group(2) or 0)
    return out
