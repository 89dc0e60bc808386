"""95th-percentile latency (ms), timed as ``p95_ms`` times it, over the
requests scheduled before the profiler's slice (all of them in an untraced
run): the batching queue's tail in a cell whose tail swings too widely from
run to run to be held end to end. The profiler's start and stop stall the
server's threads, and the backlog they leave would read as the tail."""
import numpy as np


def read(rec):
    before = rec.sched < rec.profiled[0] if rec.profiled else np.ones(len(rec.sched), bool)
    lat = rec.done[before] - (rec.t0 + rec.sched[before])
    if lat.size == 0:
        return None
    lat = np.where(np.isnan(lat), np.inf, lat)
    return float(np.percentile(lat, 95)) * 1e3
