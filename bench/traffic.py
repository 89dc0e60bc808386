"""The one traffic generator: arrival times from a mix file and the seed.

A mix (``traffic/<mix>.json``) holds parameters only:

- ``arrivals``: ``"poisson"`` (a steady rate) or ``"onoff"`` (bursts:
  ``on_s`` seconds at a raised rate, then ``off_s`` seconds at
  ``off_share`` of the mean rate, repeating);
- ``k``: the depth each query asks for;
- ``query_noise``: the query's Gaussian perturbation of a corpus row, times
  ``1 / sqrt(d)``.

The cell fixes the mean rate. Every seed gets exactly ``round(rate *
seconds)`` arrivals: the times are a Poisson process conditioned on that
count (uniform order statistics under the mix's intensity), so seeds differ
in the order and spacing of the same amount of work, never in its amount.
"""
from __future__ import annotations

import numpy as np


def _intensity(mix: dict, seconds: float) -> tuple[np.ndarray, np.ndarray]:
    """Piecewise-constant relative intensity over [0, seconds]: the knots
    and the level of each piece."""
    kind = mix["arrivals"]
    if kind == "poisson":
        return np.array([0.0, seconds]), np.array([1.0])
    if kind == "onoff":
        on, off, low = float(mix["on_s"]), float(mix["off_s"]), float(mix["off_share"])
        if on <= 0 or off <= 0 or not 0 < low <= 1:
            raise ValueError(f"onoff needs on_s, off_s > 0 and 0 < off_share <= 1: {mix}")
        knots, levels, t = [0.0], [], 0.0
        while t < seconds:
            for span, level in ((on, 1.0), (off, low)):
                t = min(seconds, t + span)
                knots.append(t)
                levels.append(level)
                if t >= seconds:
                    break
        return np.array(knots), np.array(levels)
    raise ValueError(f"unknown arrivals {kind!r} (poisson, onoff)")


def count(rate: float, seconds: float) -> int:
    return max(1, int(round(rate * seconds)))


def arrivals(mix: dict, rate: float, seconds: float, seed: int) -> np.ndarray:
    """Sorted arrival offsets in seconds, in [0, seconds)."""
    n = count(rate, seconds)
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x7AF])
    u = np.sort(rng.random(n))
    knots, levels = _intensity(mix, seconds)
    mass = np.concatenate([[0.0], np.cumsum(np.diff(knots) * levels)])
    target = u * mass[-1]
    piece = np.clip(np.searchsorted(mass, target, side="right") - 1, 0, len(levels) - 1)
    return knots[piece] + (target - mass[piece]) / levels[piece]
