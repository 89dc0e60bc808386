"""Keeps JAX and the JAX package out of the benchmark.

Two checks, both by whole top-level module names (the part before the first
dot), so that ``repro_torch``, the program, is never taken for ``repro``:

- ``scan``: no module under ``bench/`` imports ``jax``, ``jaxlib``, ``flax``
  or ``repro``, and the reference imports nothing of ``repro_torch``;
- ``loaded``: which of those a process holds in ``sys.modules``; a run
  refuses to print its result when any is there once its window has closed.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})
PROGRAM = "repro_torch"
PURE = ("reference.py", "data.py", "compare.py", "roofline.py", "traffic.py")


def imported(path: Path) -> set[str]:
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def scan(bench_dir: Path) -> list[str]:
    """Every breach under ``bench_dir``, as readable lines (none: [])."""
    out = []
    for path in sorted(Path(bench_dir).rglob("*.py")):
        names = imported(path)
        for name in sorted(names & BANNED):
            out.append(f"{path}: imports {name}")
        if path.parent == Path(bench_dir) and path.name in PURE and PROGRAM in names:
            out.append(f"{path}: imports {PROGRAM}, the program")
    return out


def loaded() -> list[str]:
    """Banned top-level modules that this process has loaded."""
    return sorted({name.split(".")[0] for name in sys.modules} & BANNED)
