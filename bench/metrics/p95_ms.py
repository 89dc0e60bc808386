"""95th-percentile latency (ms) over every request of the window, timed as
``p50_ms`` times it; a request with no reply counts as missing."""
import numpy as np


def read(rec):
    lat = rec.done - (rec.t0 + rec.sched)
    lat = np.where(np.isnan(lat), np.inf, lat)
    return float(np.percentile(lat, 95)) * 1e3
