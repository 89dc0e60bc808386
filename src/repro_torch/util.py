"""Device resolution, the fp32 precision policy and tree helpers of the port."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def set_fp32_policy() -> None:
    """Keep every float32 product in full fp32.

    The port is held to the reference at rtol = atol = 1e-5 on scores and to
    equal ids. TF32 keeps about three decimal digits, enough to reorder
    near-ties, so cuBLAS matmuls and cuDNN convolutions may not use it.
    A bf16 product (the encoder's) accumulates in fp32 to the end: cuBLAS
    may not reduce split-K partial sums in bf16.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Raises when a CUDA device is asked for (or defaulted to) and there is
    none: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            f"(torch.cuda.is_available() is False); pass device='cpu' to run "
            f"on the CPU")
    return dev


def as_tensor(x, device: str | torch.device | None = None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; anything
    else (numpy arrays, lists) goes to ``default_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(default_device(device))
    a = np.asarray(x)
    if not a.flags.writeable:   # e.g. a view of a JAX array: torch needs its own
        a = a.copy()
    return torch.as_tensor(a, device=default_device(device))


# ---------------------------------------------------------------------------
# trees: nested mappings, tuples and lists, flattened as JAX flattens them
# ---------------------------------------------------------------------------


def flatten_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in JAX's flattening order: a mapping's keys
    sorted, a tuple's or list's positions, joined by ``/``."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def map_with_paths(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
