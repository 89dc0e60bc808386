"""Lock-sanitizer fixture: a producer/consumer handoff that deadlocks
with zero lock-order cycles — the consumer parks on the queue holding
the exact lock the producer needs to publish. Must trip exactly
``locks.handoff-deadlock``."""
from __future__ import annotations

import queue
import threading


class StalledPipeline:
    """Consumer blocks on ``_q.get()`` inside ``_lock``; the only
    producer publishes under the same ``_lock``. The acquisition graph
    is a single node (no cycle), yet the first consume wedges forever.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self.processed = 0

    def produce(self, item) -> None:
        with self._lock:
            self._q.put(item)

    def consume(self):
        with self._lock:
            item = self._q.get()        # unbounded wait, lock held
            self.processed += 1
        return item
