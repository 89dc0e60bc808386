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
  * **Specs**: with a spec tree (``par.sharding.PartitionSpec`` leaves in
    the tree's structure) each leaf's entry holds its spec, as the
    reference writes it (``[None, "model", ["pod", "data"]]``); without one
    ``[]``. The specs name mesh axes, not devices.
  * **Elastic restore**: ``load_pytree(mesh=)`` places each leaf on a mesh
    by its stored spec (or ``spec_resolver``'s), with every entry whose
    axes are missing or no longer divide the dim dropped (``_fit_spec``),
    so a checkpoint written on one mesh restores onto another.
  * **Retention**: the last ``keep_n`` checkpoints stay (GC after commit).

Leaves are tensors or numpy arrays (f32 or integer: numpy has no bf16).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.fsio import commit_dir, fsync_file, write_json_fsync
from repro_torch.par.mesh import DeviceMesh
from repro_torch.par.sharding import PartitionSpec, axis_sizes, place
from repro_torch.util import flatten_with_paths, map_with_paths


def _spec_to_json(spec: PartitionSpec | None) -> list:
    return [] if spec is None else spec.to_json()


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save_pytree(path: str, tree: Any, spec_tree: Any | None = None,
                extra: dict | None = None) -> None:
    """Synchronous atomic save of ``tree`` (nested dicts, tuples and lists
    of tensors or arrays) to the directory ``path``, with each leaf's spec
    from ``spec_tree`` (the same structure) when given."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    specs = dict(flatten_with_paths(spec_tree)) if spec_tree is not None else {}
    manifest = {"leaves": [], "extra": extra or {}}
    for name, leaf in flatten_with_paths(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        fname = name.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        fsync_file(fpath)
        manifest["leaves"].append({
            "path": name, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "spec": _spec_to_json(specs.get(name)),
        })
    write_json_fsync(os.path.join(tmp, "manifest.json"), manifest)
    commit_dir(tmp, path)


def load_pytree(path: str, target: Any, mesh: DeviceMesh | None = None,
                spec_resolver: Callable[[str, tuple], PartitionSpec] | None = None) -> Any:
    """Restore into the structure of ``target``. Without ``mesh``, each leaf
    a tensor on the target leaf's device when that is a tensor, else on the
    CPU. With ``mesh``, each leaf a ``par.sharding.ShardedTensor`` placed
    by the manifest's spec (or ``spec_resolver(path, shape)``'s), refitted
    to this mesh (elastic: an entry that no longer divides is dropped).
    Raises ``ValueError`` where a stored shape differs from the target
    leaf's."""
    with open(os.path.join(path, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}

    def leaf(name, tgt):
        e = by_path[name]
        arr = np.load(os.path.join(path, e["file"]))
        shape = getattr(tgt, "shape", None)
        if shape is not None and tuple(shape) != arr.shape:
            raise ValueError(f"{path}: leaf {name!r} is {arr.shape}, the target's {tuple(shape)}")
        if mesh is None:
            return torch.from_numpy(arr).to(tgt.device if isinstance(tgt, torch.Tensor)
                                            else "cpu")
        spec = (spec_resolver(name, arr.shape) if spec_resolver
                else PartitionSpec.from_json(e["spec"]))
        return place(torch.from_numpy(arr).to(mesh.device),
                     _fit_spec(spec, arr.shape, mesh), mesh)

    return map_with_paths(leaf, target)


def _fit_spec(spec: PartitionSpec, shape: tuple, mesh: DeviceMesh) -> PartitionSpec:
    """Drop spec entries that no longer divide on this mesh (elastic)."""
    sizes = axis_sizes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, part in enumerate(parts[:len(shape)]):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        size = 1
        ok = True
        for a in axes:
            if a not in sizes:
                ok = False
                break
            size *= sizes[a]
        out.append(part if ok and shape[d] % size == 0 else None)
    return PartitionSpec(*out)


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

    def save(self, step: int, tree: Any, spec_tree: Any | None = None,
             extra: dict | None = None, *, async_: bool = True) -> None:
        """Save ``tree`` (with ``spec_tree``'s specs) as step ``step``. The
        host copy is taken before this returns, so the caller may update the
        tensors in place at once."""
        host_tree = map_with_paths(lambda _, x: _host_copy(x), tree)
        extra = dict(extra or {}, step=step)

        def work():
            save_pytree(self._step_dir(step), host_tree, spec_tree, extra)
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

    def restore(self, target: Any, step: int | None = None, mesh: DeviceMesh | None = None,
                spec_resolver: Callable | None = None) -> tuple[Any, int]:
        """``(tree, step)``: checkpoint ``step`` (default: the latest) in the
        structure of ``target``, placed on ``mesh`` when given
        (``load_pytree``); raises ``FileNotFoundError`` when there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self._step_dir(step), target, mesh, spec_resolver), step

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
