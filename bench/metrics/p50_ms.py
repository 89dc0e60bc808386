"""Median latency (ms) over every request of the window: from its scheduled
arrival to its reply's ``completed_at``; a request with no reply counts as
missing (infinitely late)."""
import numpy as np


def read(rec):
    lat = rec.done - (rec.t0 + rec.sched)
    lat = np.where(np.isnan(lat), np.inf, lat)
    return float(np.percentile(lat, 50)) * 1e3
