"""Replies to the window's requests a second, over the time from the first
scheduled arrival to the last of those replies."""
import numpy as np


def read(rec):
    ok = rec.done[~np.isnan(rec.done)]
    if ok.size == 0:
        return None
    return float(ok.size / (ok.max() - (rec.t0 + rec.sched[0])))
