"""A thin stand-in for the served index that names each search call in the
profiler's trace, so that no file of the program changes for the trace.

``RetrievalServer`` asks its index for ``device``, ``dim`` and
``search_projected``; everything is passed through, and each
``search_projected`` runs inside a ``record_function`` range
``bench.search#<i>``, ``i`` counting calls from the last ``reset``.
"""
from __future__ import annotations

from torch.profiler import record_function


class TracedIndex:
    def __init__(self, index):
        self._index = index
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0

    def search_projected(self, queries, components, k: int = 10, *, mean=None):
        i = self.calls
        self.calls += 1
        with record_function(f"bench.search#{i}"):
            return self._index.search_projected(queries, components, k=k, mean=mean)

    def __getattr__(self, name):
        return getattr(self._index, name)
