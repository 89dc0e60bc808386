"""Reads a ``torch.profiler`` chrome trace of a slice of the window.

The harness marks the slice with two ``record_function`` ranges on its own
thread (``bench.slice_start``, ``bench.slice_end``) and wraps every
``search_projected`` call in a range ``bench.search#<i>`` (``proxy.py``).
From the trace it takes:

- the device's operations (kernels, copies, sets) inside the slice, their
  union (busy seconds) and the gaps between them;
- each search call's device span, from its first kernel's start to its last
  kernel's end: a kernel belongs to the call whose range, on the same host
  thread, holds the runtime call that launched it (by correlation id);
- what the host threads were doing in each long idle gap, at its middle
  (``_host_label``).
"""
from __future__ import annotations

import bisect
import dataclasses
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
CALL_RE = re.compile(r"^bench\.search#(\d+)$")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: dict[int, float]                 # call number -> device span, s
    device_ops: list[tuple[str, float]]     # by total seconds in the slice
    idle_gaps: list[tuple[str, float]]      # longest first


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_label(host: dict, t: float) -> str:
    """What each host thread was doing at time ``t``: the innermost traced
    event covering it, else ``after <the last event that ended before>``;
    threads with no event near ``t`` are left out."""
    names = []
    for starts, evs in host.values():
        j = bisect.bisect_right(starts, t)
        inner = last = None
        for ev in reversed(evs[max(0, j - 64):j]):
            if ev[0] <= t <= ev[1] and (inner is None or ev[0] > inner[0]):
                inner = ev
            if ev[1] < t and (last is None or ev[1] > last[1]):
                last = ev
        if inner is not None:
            names.append(inner[2])
        elif last is not None and t - last[1] < 0.05e6:
            names.append(f"after {last[2]}")
    return " | ".join(sorted(set(names)))[:160] or "no traced host event"


def parse(trace: dict, top: int = 10) -> Trace | None:
    """The slice's numbers, or None when the trace holds no device work."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    marks = {e["name"]: e for e in evs if e.get("cat") == "user_annotation"
             and e["name"] in ("bench.slice_start", "bench.slice_end")}
    if len(marks) != 2:
        return None
    lo = float(marks["bench.slice_start"]["ts"])
    hi = float(marks["bench.slice_end"]["ts"]) + float(marks["bench.slice_end"].get("dur", 0))
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    inside = [(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"])), e)
              for e in dev]
    inside = [(a, b, e) for a, b, e in inside if b > a]
    if not inside:
        return None
    busy = _union([(a, b) for a, b, _ in inside])
    busy_us = sum(b - a for a, b in busy)

    by_name: dict[str, float] = {}
    for a, b, e in inside:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    device_ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]

    # host events by thread, for the calls and the gaps' labels
    host: dict = {}
    for e in evs:
        if e.get("cat") in HOST_CATS and e["name"] not in marks:
            t0 = float(e["ts"])
            host.setdefault(e.get("tid"), []).append((t0, t0 + float(e.get("dur", 0)),
                                                      e["name"]))
    host = {tid: ([ev[0] for ev in sorted(v)], sorted(v)) for tid, v in host.items()}

    annots: dict = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and (m := CALL_RE.match(e["name"])):
            t0 = float(e["ts"])
            annots.setdefault(e.get("tid"), []).append((t0, t0 + float(e.get("dur", 0)),
                                                        int(m.group(1))))
    annots = {tid: sorted(v) for tid, v in annots.items()}
    launch_call: dict = {}
    for e in evs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or corr is None:
            continue
        rng = annots.get(e.get("tid"), [])
        t = float(e["ts"])
        j = bisect.bisect_right(rng, (t, float("inf"), 1 << 62)) - 1
        if j >= 0 and rng[j][0] <= t <= rng[j][1]:
            launch_call[corr] = rng[j][2]
    spans: dict[int, list[float]] = {}
    for e in dev:
        if e.get("cat") != "kernel":
            continue
        call = launch_call.get(e.get("args", {}).get("correlation"))
        if call is None:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        s = spans.setdefault(call, [a, b])
        s[0], s[1] = min(s[0], a), max(s[1], b)
    calls = {c: (b - a) * 1e-6 for c, (a, b) in spans.items() if a >= lo and b <= hi}

    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [(_host_label(host, (a + b) / 2), (b - a) * 1e-6) for a, b in gaps[:top]]
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, calls=calls,
                 device_ops=[(n, s * 1e-6) for n, s in device_ops], idle_gaps=idle)
