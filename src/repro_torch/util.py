"""Device resolution and the fp32 precision policy of the port."""
from __future__ import annotations

import numpy as np
import torch


def set_fp32_policy() -> None:
    """Keep every float32 product in full fp32.

    The port is held to the reference at rtol = atol = 1e-5 on scores and to
    equal ids. TF32 keeps about three decimal digits, enough to reorder
    near-ties, so cuBLAS matmuls and cuDNN convolutions may not use it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
