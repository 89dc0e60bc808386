"""Concurrency-lint fixtures: each class commits one threading sin on
purpose. Parsed by the analyzer (AST only) — never instantiated."""
from __future__ import annotations

import threading
import time

import numpy as np


class UnguardedCounter:
    """`count` is guarded in `bump` but read bare in `peek`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self) -> None:
        with self._lock:
            self.count += 1

    def peek(self) -> int:
        return self.count


class NeverLockedLog:
    """Owns a lock, but `log` is mutated and read with it never held."""

    def __init__(self):
        self._lock = threading.Lock()
        self.log: list = []

    def record(self, x) -> None:
        self.log.append(x)

    def dump(self) -> list:
        return list(self.log)


class Left:
    """Acquires its own lock, then the peer's — while Right does the
    opposite: a classic ABBA deadlock."""

    def __init__(self, peer: "Right"):
        self._lock = threading.Lock()
        self.peer = peer
        self.value = 0

    def poke(self) -> None:
        with self._lock:
            self.value += 1
            self.peer.poke_back()

    def poke_back(self) -> None:
        with self._lock:
            self.value += 1


class Right:
    def __init__(self, peer: Left):
        self._lock = threading.Lock()
        self.peer = peer
        self.value = 0

    def poke(self) -> None:
        with self._lock:
            self.value += 1
            self.peer.poke_back()

    def poke_back(self) -> None:
        with self._lock:
            self.value += 1


class SleepyWriter:
    """Blocks the device/host (asarray + sleep) while holding the lock
    every reader needs."""

    def __init__(self):
        self._lock = threading.Lock()
        self.snapshot = None

    def publish(self, device_array) -> None:
        with self._lock:
            self.snapshot = np.asarray(device_array)   # D2H under lock
            time.sleep(0.01)

    def read(self):
        with self._lock:
            return self.snapshot
