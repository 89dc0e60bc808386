"""95th percentile (ms) of how late the load generator submitted a request:
the start of ``submit`` minus its scheduled arrival (harness clock)."""
import numpy as np


def read(rec):
    return float(np.percentile(rec.submit - (rec.t0 + rec.sched), 95)) * 1e3
