"""Share (%) of the least time the traced search calls could take on one
H100 (``roofline.py``, for each call's live queries) in the time their
device spans took."""
from bench import roofline


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    least = span = 0.0
    for call, seconds in rec.trace.calls.items():
        if call >= len(rec.batch_log):
            continue
        B = rec.batch_log[call][0]
        least += roofline.least_seconds(B=B, **rec.shapes)[0]
        span += seconds
    return 100.0 * least / span if span > 0 else None
