"""Checkpoints in the reference's on-disk format: atomic, async, retained
(port of ``repro/checkpoint/manager.py``).

  * **Layout**, byte for byte the reference's: one ``.npy`` blob per leaf
    under ``<dir>/step_%010d/``, named by the leaf's path with ``/`` as
    ``__``, and a ``manifest.json`` of ``{"leaves": [{"path", "file",
    "shape", "dtype", "spec"}, ...], "extra": {..., "step": N}}``. Paths
    flatten a tree as JAX does: a dict's keys in sorted order, a tuple's or
    list's positions, joined by ``/`` (``0/layers/attn/wq/w``,
    ``1/mu/embed``, ``1/step`` for a ``(params, opt_state)`` pair). A
    checkpoint either package writes restores in the other.
  * **Commit**: every blob and the manifest are fsynced inside
    ``step_N.tmp/``, which is then renamed into place and its parent fsynced
    (``checkpoint/fsio.py``), so a crashed save is never taken for a
    checkpoint: only directories with a manifest count.
  * **Async**: ``save`` copies the tree to host memory (the only part that
    blocks) and writes it on a background thread; ``wait`` joins the
    writes and raises the first error one of them met.
  * **Retention**: the last ``keep_n`` checkpoints stay (GC after commit).

Leaves are tensors or numpy arrays (f32 or integer: numpy has no bf16).
The port writes ``"spec": []`` for every leaf, as the reference does
without a spec tree; elastic restore onto a mesh with specs waits for the
port of ``par/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.fsio import commit_dir, fsync_file, write_json_fsync


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _map_with_paths(fn, tree: Any, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: _map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save_pytree(path: str, tree: Any, extra: dict | None = None) -> None:
    """Synchronous atomic save of ``tree`` (nested dicts, tuples and lists
    of tensors or arrays) to the directory ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"leaves": [], "extra": extra or {}}
    for name, leaf in _flatten_with_paths(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        fname = name.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        fsync_file(fpath)
        manifest["leaves"].append({
            "path": name, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "spec": [],
        })
    write_json_fsync(os.path.join(tmp, "manifest.json"), manifest)
    commit_dir(tmp, path)


def load_pytree(path: str, target: Any) -> Any:
    """Restore into the structure of ``target``: each leaf a tensor on the
    target leaf's device when that is a tensor, else on the CPU. Raises
    ``ValueError`` where a stored shape differs from the target leaf's."""
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def leaf(name, tgt):
        e = by_path[name]
        arr = np.load(os.path.join(path, e["file"]))
        shape = getattr(tgt, "shape", None)
        if shape is not None and tuple(shape) != arr.shape:
            raise ValueError(f"{path}: leaf {name!r} is {arr.shape}, the target's {tuple(shape)}")
        return torch.from_numpy(arr).to(tgt.device if isinstance(tgt, torch.Tensor) else "cpu")

    return _map_with_paths(leaf, target)


@dataclasses.dataclass
class CheckpointManager:
    """Step-indexed checkpoint directory with async save and auto-resume."""

    directory: str
    keep_n: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pending: list[threading.Thread] = []
        self._errors: list[Exception] = []

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, extra: dict | None = None, *,
             async_: bool = True) -> None:
        """Save ``tree`` as step ``step``. The host copy is taken before this
        returns, so the caller may update the tensors in place at once."""
        host_tree = _map_with_paths(lambda _, x: _host_copy(x), tree)
        extra = dict(extra or {}, step=step)

        def work():
            save_pytree(self._step_dir(step), host_tree, extra)
            self._gc()

        if not async_:
            work()
            return

        def run():
            try:
                work()
            except Exception as e:      # handed to wait(), which raises it
                self._errors.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._pending.append(t)

    def wait(self) -> None:
        """Join every pending save; raise the first error one of them met."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def restore(self, target: Any, step: int | None = None) -> tuple[Any, int]:
        """``(tree, step)``: checkpoint ``step`` (default: the latest) in the
        structure of ``target``; raises ``FileNotFoundError`` when there is
        none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self._step_dir(step), target), step

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
