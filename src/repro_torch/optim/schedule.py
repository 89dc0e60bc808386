"""LR schedules as step -> lr functions (port of ``repro/optim/schedule.py``).

Each returns a 0-d float32 CPU tensor, computed in float32 in the
reference's order of operations, so it can scale a tensor on any device.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``, flat after it."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant_lr(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
