"""Median over the window's batches (``RetrievalServer.batch_log``) of the
time from the stager's dispatch to the completer's post (ms)."""
import numpy as np


def read(rec):
    if not rec.batch_log:
        return None
    return float(np.median([t1 - t0 for _, t0, t1 in rec.batch_log])) * 1e3
