"""Mean device span (ms) of a ``search_projected`` call in the traced slice:
from its first kernel's start to its last kernel's end (``devtrace.py``)."""


def read(rec):
    if rec.trace is None or not rec.trace.calls:
        return None
    spans = list(rec.trace.calls.values())
    return sum(spans) / len(spans) * 1e3
