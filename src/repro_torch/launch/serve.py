"""Retrieval serving entry point: batched queries against a PCA-pruned index
(port of ``repro/launch/serve.py``: dense, sharded, segmented, paged or
cascaded, and the replicated fleet).

The paper's online path, end to end:
  1. build the offline artefacts (PCA transform W_m + pruned index D̂)
  2. batch incoming queries (micro-batching queue with a latency deadline)
  3. per batch: q̂ = W_mᵀ q, int8 scale fold, score + top-k on the card
     (``DenseIndex.search_projected``)
  4. return doc ids + scores

The worker is a two-thread pipeline (``pipeline_depth`` >= 2, the
default): a *stager* assembles a batch, launches its search on the current
CUDA stream, queues copies of the results into pinned host buffers
(``non_blocking``) and records a ``torch.cuda.Event`` behind them; a
*completer* waits on the oldest in-flight batch's event only and posts its
replies. A plain ``.cpu()`` would wait for every batch launched since.
``pipeline_depth <= 1`` is the synchronous loop. On a CPU index the search
is synchronous and the same pipeline runs without events.

``--paged`` serves through a ``PagedIndex`` (``core/paged.py``): the index
lives in ``--page-rows``-row pages behind a page table, so appends,
promotion, compaction and eviction are pointer swaps that ``swap_index``
installs under traffic. ``--page-pool P`` caps the device pool at P pages;
the overflow stays in pinned host memory and streams in waves.

``--live-append R`` serves through a ``SegmentedIndex`` (or the
``PagedIndex`` itself under ``--paged``) while an appender thread adds
synthetic documents in 64-row blocks at R rows/s through an
``IndexUpdater`` attached to the server: every append swaps a fresh
segment set in between batches, and the run ends with a compaction.
``--delta-capacity`` is the fixed capacity of each delta segment and the
row count at which a paged delta extent seals.

``--save-index DIR`` persists what was built (PCA state, pruned vectors,
int8 scale; a paged index page by page) as an ``IndexStore`` artifact.
``--load-index DIR`` serves from one instead, with no refit and no
rebuild: it opens and validates the store, loads it onto the card (paged
under ``--paged`` or when the manifest carries a ``paged`` block) and
prints the cold start, from opening the store to the first answered
query. Under ``--live-append`` the loaded index gets an
``IndexUpdater.from_store``, so every append is durable.

``--cascade M:N`` serves a ``CascadeIndex`` (``core/cascade.py``): a coarse
scan over the first M PCA dims (int8) keeps N·k candidates per query, then
one exact full-m rescore of the batch's shortlist. It builds, saves and
loads like the single index (``--paged`` pages both sides); under
``--live-append`` an appender grows both resolutions in lockstep and swaps
each new pair into the server (the reference's cascade branch: no updater,
no compaction). ``--compare-full`` then drives the same tape against the
unpruned corpus and prints the speedup.

``--fleet R`` serves through R replicas behind a load-aware router
(``serving/fleet.py``): it builds (or ``--load-index`` opens) an artifact,
drives it open loop, and prints the fleet's accounting; ``--fleet-kill S``
kills replica r1 S seconds into the drive and restarts it 2 s later.

``--sharded`` lays the pruned index over a mesh of ``--host-devices N``
slots (default 4) on the run's device (``ShardedDenseIndex``): each slot
runs its own top-k over its rows and ``--merge flat`` merges the lists in
one stage, ``--merge hierarchical`` over the squarest 2-D factoring of the
slots in two. On one card the slots are ``cuda:0`` N times, under
``--device cpu`` the CPU N times; with ``--device cuda`` on a machine with
several cards the slots go round-robin over the cards. It builds, saves,
loads (``--load-index``) and grows under ``--live-append`` (a segmented
index over the sharded base, compacted onto the same mesh); it refuses
``--paged``, ``--cascade`` and ``--fleet``, as the reference does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 50000 \\
      --dim 256 --cutoff 0.5 --queries 256 --batch 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --n-docs 8000 --dim 128 --open-loop 200
  PYTHONPATH=src python -m repro_torch.launch.serve --paged --page-rows 256 \\
      --page-pool 96            # oversubscribed: the rest streams from host
  PYTHONPATH=src python -m repro_torch.launch.serve --live-append 300 \\
      --quantize-int8           # appends swapped in under load, then compact
  PYTHONPATH=src python -m repro_torch.launch.serve --quantize-int8 \\
      --save-index build/idx    # build once, persist the artifact ...
  PYTHONPATH=src python -m repro_torch.launch.serve --load-index build/idx
                                # ... and restart from it
  PYTHONPATH=src python -m repro_torch.launch.serve --cascade 64:8 \
      --compare-full            # coarse int8 scan + exact rescore
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 3 --fleet-kill 2
  PYTHONPATH=src python -m repro_torch.launch.serve --sharded --host-devices 4 \
      --merge hierarchical      # a 2 x 2 mesh of slots, two-stage merge
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.cascade import CascadeIndex
from repro_torch.core.index import DenseIndex, SegmentedIndex, ShardedDenseIndex
from repro_torch.core.maintenance import IndexUpdater
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.store import IndexStore, save_index
from repro_torch.data.synthetic import make_dataset
from repro_torch.par.mesh import DeviceMesh, make_mesh
from repro_torch.util import default_device


class TimedOut(RuntimeError):
    """A reply's deadline expired before its batch posted. Delivered as the
    reply payload (and re-raised by ``query``): an explicit timeout, never
    a silently dropped request."""


class Reply(queue.Queue):
    """Single-slot reply future for one submitted query.

    ``completed_at`` is stamped (``perf_counter``) by the completer when the
    batch posts, before the client wakes, so latency accounting does not
    assume FIFO completion. ``deadline`` (absolute ``perf_counter`` time or
    None) lets the server expire the reply with ``TimedOut``. All delivery
    goes through ``resolve``: the first writer wins.
    """

    def __init__(self, deadline: float | None = None):
        super().__init__(maxsize=1)
        self.completed_at: float | None = None
        self.deadline = deadline
        self.done = False
        self._claim = threading.Lock()

    def resolve(self, payload, t: float | None = None) -> bool:
        """Deliver ``payload`` exactly once; False if a prior resolution
        (result, timeout or worker crash) already won."""
        with self._claim:
            if self.done:
                return False
            self.done = True
            self.completed_at = t
        self.put_nowait(payload)
        return True


class BatchingQueue:
    """Micro-batching: collect up to ``max_batch`` requests, flush at a
    latency deadline. Every wait parks on one condition variable, so an
    idle server costs no CPU.

    ``next_batch(want_full=...)``: while the predicate holds (earlier
    batches still in flight) the collector waits for a *full* batch instead
    of flushing at the deadline; ``kick()`` re-evaluates it.
    """

    def __init__(self, max_batch: int = 32, deadline_ms: float = 2.0):
        self.max_batch = max_batch
        self.deadline = deadline_ms / 1e3
        self._items: deque = deque()
        self._cv = threading.Condition()

    def submit(self, qvec: np.ndarray,
               deadline: float | None = None) -> Reply:
        reply = Reply(deadline=deadline)
        with self._cv:
            self._items.append((qvec, reply))
            self._cv.notify_all()
        return reply

    def kick(self) -> None:
        """Wake every waiter so it re-evaluates its predicate."""
        with self._cv:
            self._cv.notify_all()

    def drain(self) -> list:
        """Remove and return every pending (vec, reply) pair."""
        with self._cv:
            items = list(self._items)
            self._items.clear()
        return items

    def empty(self) -> bool:
        with self._cv:
            return not self._items

    def next_batch(self, timeout: float = 30.0,
                   stop: threading.Event | None = None,
                   want_full=None) -> tuple[np.ndarray, list] | None:
        with self._cv:
            ready = self._cv.wait_for(
                lambda: self._items or (stop is not None and stop.is_set()),
                timeout=timeout)
            if not ready or not self._items:
                return None
            flush_at = time.monotonic() + self.deadline
            while len(self._items) < self.max_batch:
                if want_full is not None and want_full():
                    # device busy: hold out for a full batch; a kick() or a
                    # new submit re-evaluates (1 s backstop)
                    self._cv.wait(timeout=1.0)
                    continue
                rem = flush_at - time.monotonic()
                if rem <= 0 or not self._cv.wait(timeout=rem):
                    break
            items = [self._items.popleft()
                     for _ in range(min(self.max_batch, len(self._items)))]
        vecs = np.stack([x[0] for x in items])
        replies = [x[1] for x in items]
        return vecs, replies


def _results_to_host(scores: torch.Tensor, ids: torch.Tensor):
    """Start the copy of one batch's results to the host; returns
    ``(scores, ids, event)`` where the host tensors are valid once
    ``event`` has completed (``event`` is None for a CPU index)."""
    if scores.device.type != "cuda":
        return scores, ids, None
    hs = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
    hi = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
    hs.copy_(scores, non_blocking=True)
    hi.copy_(ids, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return hs, hi, event


Index = DenseIndex | ShardedDenseIndex | SegmentedIndex | PagedIndex | CascadeIndex


class RetrievalServer:
    """Batched query server over a ``DenseIndex``, ``ShardedDenseIndex``,
    ``SegmentedIndex``, ``PagedIndex`` or ``CascadeIndex`` (any index with
    ``device``, ``dim`` and ``search_projected``, and ``search`` to serve
    without a pruner).

    With a pruner attached every batch runs ``search_projected``
    (projection + scale fold + top-k); without one, plain ``search``.
    ``pipeline_depth`` >= 2 (default 3) runs the stager/completer pipeline
    with that many batches in flight; <= 1 is the synchronous loop. Every
    executed batch is logged as ``(size, t_dispatch, t_done)``.

    Batches are zero-padded to ``max_batch``, or with ``bucket_batches``
    to the next bucket in {8, 16, 32, …, max_batch}: a fixed set of batch
    shapes (the reference pads so XLA never recompiles; here it keeps
    kernel shapes steady). Pad rows are sliced off before reply.

    ``swap_index`` installs a new index atomically between batches: each
    dispatch snapshots (index, projection) under a lock.
    """

    _KEEP = object()   # swap_index sentinel: leave the projection alone

    def __init__(self, index: Index, pruner: StaticPruner | None,
                 k: int = 10, max_batch: int = 32,
                 pipeline_depth: int = 3,
                 bucket_batches: bool = False):
        self.index = index
        self.pruner = pruner
        self.k = k
        self.max_batch = max_batch
        self.bucket_batches = bucket_batches
        caps, c = [], min(8, max_batch)
        while c < max_batch:
            caps.append(c)
            c *= 2
        caps.append(max_batch)
        self._buckets = tuple(caps)
        self.pipeline_depth = max(1, pipeline_depth)
        self.batcher = BatchingQueue(max_batch=max_batch)
        self.batch_log: list[tuple[int, float, float]] = []
        self._log_lock = threading.Lock()
        self._index_lock = threading.Lock()
        self.swap_count = 0
        self._proj = None if pruner is None else self._projection(pruner, index)
        self._stop = threading.Event()
        self.error: BaseException | None = None   # first worker-thread crash
        self._pending_dl: list[Reply] = []
        self._dl_lock = threading.Lock()
        if self.pipeline_depth >= 2:
            # the semaphore gates batch assembly, so while every slot is
            # busy requests accumulate into a full next batch
            self._slots = threading.Semaphore(self.pipeline_depth)
            self._inflight: queue.Queue = queue.Queue()
            self._inflight_n = 0
            self._inflight_lock = threading.Lock()
            self._threads = [
                threading.Thread(target=self._guard, args=(self._stage_loop,),
                                 daemon=True),
                threading.Thread(target=self._guard,
                                 args=(self._complete_loop,), daemon=True)]
        else:
            self._threads = [threading.Thread(target=self._guard,
                                              args=(self._loop,), daemon=True)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _projection(pruner: StaticPruner, index: Index):
        W, mean = pruner.projection()
        return (W.to(index.device),
                None if mean is None else mean.to(index.device))

    def _guard(self, loop):
        """A worker-thread crash is recorded, stops the server and fails
        every queued and in-flight request at once."""
        try:
            loop()
        except BaseException as e:   # noqa: BLE001 — survives for reporting
            import traceback
            self.error = e
            self._stop.set()
            self.batcher.kick()
            if self.pipeline_depth >= 2:
                while True:
                    try:
                        it = self._inflight.get_nowait()
                    except queue.Empty:
                        break
                    if it is not None:
                        for r in it[1]:
                            r.resolve(e)
                self._inflight.put(None)   # release a blocked completer
            for _, reply in self.batcher.drain():
                reply.resolve(e)
            traceback.print_exc()

    def _bucket_for(self, b: int) -> int:
        if not self.bucket_batches:
            return self.max_batch
        for cap in self._buckets:
            if cap >= b:
                return cap
        return self.max_batch

    def _dispatch(self, vecs: np.ndarray):
        """Launch one batch's search and the copy of its results to the
        host; returns ``(scores, ids, event)`` without waiting (see
        ``_results_to_host``)."""
        with self._index_lock:
            index, proj = self.index, self._proj
        b = len(vecs)
        cap = self._bucket_for(b)
        if b < cap:
            vecs = np.concatenate(
                [vecs, np.zeros((cap - b, vecs.shape[1]), vecs.dtype)])
        q = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(
            index.device, non_blocking=True)
        if proj is not None:
            W, mean = proj
            scores, ids = index.search_projected(q, W, k=self.k, mean=mean)
        else:
            scores, ids = index.search(q, k=self.k)
        return _results_to_host(scores, ids)

    def _post(self, pending, replies, t0):
        scores, ids, event = pending
        try:
            if event is not None:
                event.synchronize()     # this batch only (no lock held)
            scores, ids = scores.numpy(), ids.numpy()
        except BaseException as e:
            t = time.perf_counter()
            for r in replies:
                r.resolve(e, t)
            raise
        t1 = time.perf_counter()
        with self._log_lock:
            self.batch_log.append((len(replies), t0, t1))
        for i, r in enumerate(replies):
            r.resolve((scores[i], ids[i]), t1)

    # -- deadline expiry ----------------------------------------------------
    def _dl_poll(self) -> float:
        with self._dl_lock:
            pending = bool(self._pending_dl)
        return 0.05 if pending else 0.5

    def _expire_overdue(self) -> None:
        """Resolve every overdue pending reply with TimedOut, outside the
        deadline lock."""
        now = time.perf_counter()
        with self._dl_lock:
            live = [r for r in self._pending_dl if not r.done]
            due = [r for r in live if r.deadline <= now]
            self._pending_dl = [r for r in live if r.deadline > now]
        for r in due:
            r.resolve(TimedOut(
                f"reply deadline exceeded ({now - r.deadline:.3f}s overdue) "
                f"— batch never posted"), now)

    def swap_index(self, index: Index, pruner=_KEEP) -> None:
        """Atomically install a new index for future batches; in-flight
        batches finish against the old one. ``pruner`` replaces the query
        projection too; by default it is kept."""
        proj = None
        if pruner is not self._KEEP and pruner is not None:
            proj = self._projection(pruner, index)   # copies outside the lock
        with self._index_lock:
            if pruner is self._KEEP:
                proj = self._proj
            self.index = index
            self._proj = proj
            self.swap_count += 1

    def warmup(self) -> None:
        """Run every batch shape once before taking load."""
        d = self._query_dim()
        caps = self._buckets if self.bucket_batches else (self.max_batch,)
        for cap in caps:
            _, _, event = self._dispatch(np.zeros((cap, d), np.float32))
            if event is not None:
                event.synchronize()

    # -- synchronous worker (pipeline_depth <= 1) ---------------------------
    def _loop(self):
        while not (self._stop.is_set() and self.batcher.empty()):
            self._expire_overdue()
            item = self.batcher.next_batch(stop=self._stop,
                                           timeout=self._dl_poll())
            if item is None:
                continue
            vecs, replies = item
            t0 = time.perf_counter()
            pending = self._dispatch_guarded(vecs, replies)
            self._post(pending, replies, t0)

    def _dispatch_guarded(self, vecs, replies):
        """_dispatch, but a crash fails the in-hand batch's replies before
        it propagates to _guard."""
        try:
            return self._dispatch(vecs)
        except BaseException as e:
            t = time.perf_counter()
            for r in replies:
                r.resolve(e, t)
            raise

    # -- pipelined worker (stager + completer) ------------------------------
    def _busy(self) -> bool:
        return self._inflight_n > 0 and not self._stop.is_set()

    def _stage_loop(self):
        while not ((self._stop.is_set() and self.batcher.empty())
                   or self.error is not None):
            if not self._slots.acquire(timeout=0.2):
                continue
            item = self.batcher.next_batch(stop=self._stop,
                                           want_full=self._busy)
            if item is None:
                self._slots.release()
                continue
            vecs, replies = item
            t0 = time.perf_counter()
            pending = self._dispatch_guarded(vecs, replies)   # does not wait
            with self._inflight_lock:
                self._inflight_n += 1
            self._inflight.put((pending, replies, t0))
        self._inflight.put(None)                   # drain sentinel

    def _complete_loop(self):
        while True:
            try:
                item = self._inflight.get(timeout=self._dl_poll())
            except queue.Empty:
                self._expire_overdue()
                continue
            if item is None:
                return
            self._post(*item)
            self._expire_overdue()
            with self._inflight_lock:
                self._inflight_n -= 1
                idle = self._inflight_n == 0
            self._slots.release()
            if idle:
                self.batcher.kick()   # device drained: flush partial batches

    def _query_dim(self) -> int:
        with self._index_lock:
            index, proj = self.index, self._proj
        return proj[0].shape[0] if proj is not None else index.dim

    # -- client API ---------------------------------------------------------
    def submit(self, qvec: np.ndarray,
               deadline: float | None = None) -> Reply:
        """Open-loop entry: enqueue a query, return its reply queue. The
        shape is checked here; ``deadline`` (relative seconds) arms expiry."""
        qvec = np.asarray(qvec)
        if self.error is not None:
            raise RuntimeError("server worker failed") from self.error
        want = self._query_dim()
        if qvec.shape != (want,):
            raise ValueError(f"query must have shape ({want},), "
                             f"got {qvec.shape}")
        abs_dl = (None if deadline is None
                  else time.perf_counter() + deadline)
        reply = self.batcher.submit(qvec, deadline=abs_dl)
        if abs_dl is not None:
            with self._dl_lock:
                self._pending_dl.append(reply)
        if self.error is not None:
            reply.resolve(self.error)
        return reply

    def query(self, qvec: np.ndarray, timeout: float = 10.0,
              deadline: float | None = None):
        out = self.submit(qvec, deadline=deadline).get(timeout=timeout)
        if isinstance(out, TimedOut):
            raise out
        if isinstance(out, BaseException):
            raise RuntimeError("server worker failed") from out
        return out

    def reset_stats(self) -> None:
        with self._log_lock:
            self.batch_log.clear()

    def worker_stats(self) -> dict:
        """Occupancy + worker-side throughput from the executed batches."""
        with self._log_lock:
            log = list(self.batch_log)
        if not log:
            return dict(batches=0, mean_batch=0.0, occupancy=0.0,
                        worker_qps=0.0, service_qps=0.0)
        sizes = np.array([s for s, _, _ in log], dtype=np.float64)
        t0s = np.array([a for _, a, _ in log], dtype=np.float64)
        t1s = np.array([b for _, _, b in log], dtype=np.float64)
        span = float(t1s.max() - t0s.min())
        busy = float((t1s - t0s).sum())
        return dict(batches=len(log),
                    mean_batch=float(sizes.mean()),
                    occupancy=float(sizes.mean() / self.max_batch),
                    worker_qps=float(sizes.sum() / max(span, 1e-9)),
                    service_qps=float(sizes.sum() / max(busy, 1e-9)))

    def close(self):
        """Stop after draining: every submitted request is answered before
        the threads exit."""
        self._stop.set()
        self.batcher.kick()
        for t in self._threads:
            t.join(timeout=60.0)


def _drive(server: RetrievalServer, Q: np.ndarray) -> tuple[float, np.ndarray]:
    """Issue every query in array order, closed loop; (wall seconds,
    per-query latency s). One untimed warmup query first."""
    server.query(Q[0])
    server.reset_stats()
    lat = np.empty(len(Q))
    t0 = time.perf_counter()
    for i in range(len(Q)):
        t = time.perf_counter()
        server.query(Q[i])
        lat[i] = time.perf_counter() - t
    return time.perf_counter() - t0, lat


def _lat_summary(lat_s: np.ndarray) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return dict(p50_ms=float(np.percentile(ms, 50)),
                p95_ms=float(np.percentile(ms, 95)),
                p99_ms=float(np.percentile(ms, 99)),
                mean_ms=float(ms.mean()))


def _drive_open(server: RetrievalServer, Q: np.ndarray, rate: float,
                seed: int = 0, collect: bool = False,
                tolerate_errors: bool = False,
                deadline: float | None = None) -> dict:
    """Open-loop load: Poisson arrivals at ``rate`` qps, independent of
    completions. Latency runs from each query's *scheduled* arrival to its
    reply's ``completed_at`` stamp (no coordinated omission). Returns
    achieved/offered qps and p50/p95/p99, plus with ``collect`` the
    per-query (scores, ids) in submission order. ``tolerate_errors``
    counts exception payloads in ``errors`` instead of failing."""
    rng = np.random.default_rng(seed)
    server.query(Q[0])
    server.reset_stats()
    n = len(Q)
    gaps = rng.exponential(1.0 / rate, size=n)
    lat = np.full(n, np.nan)
    results: list = [None] * n if collect else None
    handoff: queue.Queue = queue.Queue()
    done = threading.Event()
    errors: list = []
    fails: list = []

    def collector():
        try:
            for _ in range(n):
                i, reply, t_arr = handoff.get()
                if isinstance(reply, BaseException):   # rejected at submit
                    fails.append((i, reply))
                    continue
                out = reply.get(timeout=120.0)
                if isinstance(out, BaseException):
                    if tolerate_errors:
                        fails.append((i, out))
                        continue
                    raise out
                t_done = getattr(reply, "completed_at", None)
                lat[i] = (t_done if t_done is not None
                          else time.perf_counter()) - t_arr
                if collect:
                    results[i] = out
        except BaseException as e:   # noqa: BLE001 — must reach _drive_open
            errors.append(e)
        finally:
            done.set()

    th = threading.Thread(target=collector, daemon=True)
    th.start()
    t_start = time.perf_counter()
    t_next = t_start
    for i in range(n):
        t_next += gaps[i]
        delay = t_next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            reply = server.submit(Q[i], deadline=deadline)
        except Exception as e:
            if not tolerate_errors:
                done.set()
                raise
            reply = e
        handoff.put((i, reply, t_next))
    done.wait()
    if errors:
        raise RuntimeError(
            "open-loop drive failed: a reply never arrived (worker thread "
            "dead?)") from errors[0]
    wall = time.perf_counter() - t_start
    ok = lat[~np.isnan(lat)]
    out = dict(offered_qps=float(rate), achieved_qps=float(n / wall),
               wall_s=float(wall), n=int(n), n_ok=int(ok.size),
               errors=len(fails),
               **_lat_summary(ok if ok.size else np.array([np.inf])))
    if collect:
        out["results"] = results
    return out


APPEND_BLOCK = 64      # rows per live append
# the cold start's first query may build the top-k kernel with nvcc (about
# a minute on a fresh checkout), so it waits longer than a served query
COLD_QUERY_TIMEOUT = 900.0


def _append_loop(updater: IndexUpdater, rate: float, dim: int,
                 device: torch.device, stop: threading.Event) -> None:
    """Append 64-row blocks of synthetic documents at ``rate`` rows/s until
    ``stop``; each append swaps into the updater's server."""
    rng = np.random.default_rng(123)
    while not stop.is_set():
        t0 = time.perf_counter()
        block = rng.standard_normal((APPEND_BLOCK, dim)).astype(np.float32)
        updater.add_documents(torch.as_tensor(block, device=device))
        delay = APPEND_BLOCK / rate - (time.perf_counter() - t0)
        if delay > 0:
            stop.wait(delay)


def _delta_units(idx) -> str:
    if isinstance(idx, PagedIndex):
        n_ext = sum(1 for e in idx.storage.extents if e.kind == "delta")
        return f"{idx.storage.delta_pages} delta page(s), {n_ext} extent(s)"
    return f"{len(idx.deltas)} delta segment(s)"


def _report_live(server: RetrievalServer, updater: IndexUpdater) -> None:
    """The reference's live-append summary, then a compaction swapped into
    the server and its line."""
    idx = updater.index
    print(f"[serve] live-append: +{updater.appended_rows} rows in "
          f"{_delta_units(idx)}, {server.swap_count} atomic swaps; index now "
          f"{idx.n} rows")
    t0 = time.perf_counter()
    updater.compact()
    dt_ms = (time.perf_counter() - t0) * 1e3
    lc = updater.last_compaction or {}
    if "pages_moved" in lc:
        print(f"[serve] compaction (paged): {lc['pages_moved']} pages "
              f"moved, {lc['pages_freed']} freed, {lc['pages_host']} "
              f"host-tier, in {dt_ms:.0f}ms — pointer swaps, no "
              f"rebuild; server swapped mid-serve "
              f"(swap #{server.swap_count})")
    else:
        print(f"[serve] compaction: base+deltas -> one fresh base "
              f"({updater.index.n} rows, fresh scale) in "
              f"{dt_ms:.0f}ms; server swapped "
              f"mid-serve (swap #{server.swap_count})")
        if isinstance(updater.index.base, ShardedDenseIndex):
            _print_sharded("compacted base", updater.index.base)


def _query_tape(ds, n: int) -> np.ndarray:
    """``n`` queries: the dataset's dl19 set, tiled."""
    Q = np.asarray(ds.queries["dl19"])
    return np.tile(Q, (max(1, n // len(Q) + 1), 1))[:n]


def _print_paged(what: str, index: PagedIndex) -> None:
    stg = index.storage
    print(f"[serve] {what}: {index.n} x {index.dim} "
          f"({index.nbytes/2**20:.1f} MiB, {stg.n_slots} pages "
          f"x {stg.page_rows} rows, {stg.n_host_pages} host-tier)")


def _print_cascade(what: str, index: CascadeIndex) -> None:
    c = index.coarse
    paged = isinstance(c, PagedIndex)
    dtype = c.storage.dtype if paged else getattr(c, "base", c).vectors.dtype
    print(f"[serve] {what}: {index.n} x {index.dim} (+ coarse "
          f"m={index.m_coarse} {str(dtype).removeprefix('torch.')}, shortlist "
          f"{index.n_factor}*k, {index.nbytes/2**20:.1f} MiB"
          f"{', paged' if paged else ''})")


def _adopt_store_dim(args, path: str) -> None:
    """Take the query width from the artifact's fit (its ``source_dim``)."""
    src_d = int(IndexStore.open(path).meta.get("source_dim", args.dim))
    if src_d != args.dim:
        print(f"[serve] store was fit at d={src_d}; overriding --dim")
        args.dim = src_d


def _serve_mesh(ndev: int, merge: str, device: torch.device) -> DeviceMesh:
    """The reference's serving mesh: 1-D ``("data",)`` for the flat merge;
    the squarest 2-D ``("row", "col")`` factoring for the hierarchical one
    (a 1-long second axis degenerates to flat anyway). The slots go over
    ``device``, or round-robin over the visible cards for a bare
    ``cuda``."""
    devices = None if device.type == "cuda" and device.index is None else device
    if merge == "hierarchical":
        a = next(d for d in range(int(ndev ** 0.5), 0, -1) if ndev % d == 0)
        if a > 1:
            return make_mesh((a, ndev // a), ("row", "col"), devices)
    return make_mesh((ndev,), ("data",), devices)


def _print_sharded(what: str, index: ShardedDenseIndex) -> None:
    mesh = index.mesh
    slots = ", ".join(sorted({str(d) for d in mesh.device_list}))
    print(f"[serve] {what}: {index.n} x {index.dim} over mesh "
          f"{dict(zip(mesh.axis_names, mesh.shape))} on {slots} "
          f"({index.nbytes/2**20:.1f} MiB, {index.dtype}, merge={index.merge})")


def _serve_from_store(args, device: torch.device, pool_pages: int | None,
                      cascade_mn: tuple[int, int] | None, mesh: DeviceMesh | None):
    """``--load-index``: the restart path. Peeks at the artifact for the
    query width, then times the cold start proper — open and validate,
    load, first answered query — and prints it. Returns ``(server,
    updater or None, query tape)``; under ``--live-append`` a single index
    comes from ``IndexUpdater.from_store``, so appends mirror to the
    artifact, and a cascade loads segmented (its appends stay in memory).
    With ``mesh`` (``--sharded``) the index, or the updater's base, loads
    over the mesh."""
    _adopt_store_dim(args, args.load_index)
    # a tiny corpus is enough to synthesise the query stream: the served
    # docs come from the artifact
    Q = _query_tape(make_dataset("tasb", n_docs=256, d=args.dim,
                                 query_sets=("dl19",)), args.queries)
    t_cold = time.perf_counter()
    store = IndexStore.open(args.load_index)
    updater = None
    if cascade_mn:
        pruner = store.load_pruner(device=device)
        index = CascadeIndex.load(store, m_coarse=cascade_mn[0], n_factor=cascade_mn[1],
                                  segmented=args.live_append > 0, paged=args.paged,
                                  page_rows=args.page_rows or None,
                                  pool_pages=pool_pages,
                                  delta_capacity=args.delta_capacity, device=device)
    elif args.live_append > 0:
        updater = IndexUpdater.from_store(
            store, mesh=mesh, merge=args.merge, delta_capacity=args.delta_capacity,
            paged=False if mesh is not None else (True if args.paged else None),
            pool_pages=pool_pages, device=device)
        index, pruner = updater.index, updater.pruner
    else:
        pruner = store.load_pruner(device=device)
        if mesh is not None:
            index = ShardedDenseIndex.load(store, mesh, merge=args.merge)
        elif args.paged or "paged" in store.manifest:
            index = PagedIndex.load(store, page_rows=args.page_rows or None,
                                    pool_pages=pool_pages, device=device)
        else:
            index = DenseIndex.load(store, device=device)
    if isinstance(index, CascadeIndex):
        _print_cascade("loaded cascade", index)
    elif isinstance(index, ShardedDenseIndex):
        _print_sharded("loaded sharded index", index)
    elif isinstance(index, PagedIndex):
        _print_paged("loaded paged index", index)
    elif isinstance(index, SegmentedIndex):
        sharded = isinstance(index.base, ShardedDenseIndex)
        print(f"[serve] loaded segmented index: {index.n} x {index.dim} "
              f"({index.nbytes/2**20:.1f} MiB, {len(index.deltas)} delta "
              f"segment(s){', sharded base' if sharded else ''})")
        if sharded:
            _print_sharded("sharded base", index.base)
    else:
        print(f"[serve] loaded index: {index.n} x {index.dim} "
              f"({index.nbytes/2**20:.1f} MiB, dtype={index.vectors.dtype})")
    server = RetrievalServer(index, pruner, k=args.k, max_batch=args.batch,
                             pipeline_depth=args.pipeline_depth,
                             bucket_batches=args.bucket_batches)
    server.query(Q[0], timeout=COLD_QUERY_TIMEOUT)   # closes the cold start
    print(f"[serve] cold start (open store -> first query): "
          f"{(time.perf_counter() - t_cold)*1e3:.1f}ms")
    server.reset_stats()
    return server, updater, Q


def _cascade_append_loop(server: RetrievalServer, pruner: StaticPruner,
                         state: dict, rate: float, dim: int,
                         device: torch.device, stop: threading.Event) -> None:
    """``--live-append`` under ``--cascade``: append 64-row blocks of
    synthetic documents at ``rate`` rows/s to both resolutions of
    ``state["index"]`` (copy-on-write) and swap each new pair into the
    server. Only this thread rebinds ``state``."""
    rng = np.random.default_rng(123)
    cas = state["index"]
    while not stop.is_set():
        t0 = time.perf_counter()
        block = rng.standard_normal((APPEND_BLOCK, dim)).astype(np.float32)
        cas = cas.append(pruner.prune_index(torch.as_tensor(block, device=device)))
        server.swap_index(cas)
        state["rows"] += APPEND_BLOCK
        state["index"] = cas
        delay = APPEND_BLOCK / rate - (time.perf_counter() - t0)
        if delay > 0:
            stop.wait(delay)


def _serve_fleet(args, device: torch.device) -> None:
    """``--fleet R``: R replicas behind a Router over one artifact (built
    here, or ``--load-index``), driven open loop; with ``--fleet-kill`` a
    kill/restart fault plan runs mid-drive and the accounting the chaos
    soak asserts is printed."""
    import tempfile

    # deferred: serving.fleet imports this module
    from repro_torch.serving.fleet import FaultEvent, FaultPlan, ReplicaSet

    ctx = None
    if args.load_index:
        store_path = args.load_index
        _adopt_store_dim(args, store_path)
    else:
        ctx = None if args.save_index else tempfile.TemporaryDirectory()
        store_path = args.save_index or (ctx.name + "/fleet-store")
        print(f"[serve] building corpus n={args.n_docs} d={args.dim} on {device}")
        ds = make_dataset("tasb", n_docs=args.n_docs, d=args.dim, query_sets=("dl19",))
        D = torch.as_tensor(ds.docs, device=device)
        pruner = StaticPruner(cutoff=args.cutoff).fit(D)
        st = save_index(store_path, pruner.build_index(D, quantize_int8=args.quantize_int8),
                        pruner=pruner)
        del D
        print(f"[serve] artifact: {store_path} ({st.nbytes/2**20:.1f} MiB, n={st.n})")
    Q = _query_tape(make_dataset("tasb", n_docs=256, d=args.dim,
                                 query_sets=("dl19",)), args.queries)
    rate = args.open_loop if args.open_loop > 0 else 200.0
    fleet = None
    try:
        fleet = ReplicaSet(store_path, replicas=args.fleet, k=args.k,
                           max_batch=args.batch, pipeline_depth=args.pipeline_depth,
                           delta_capacity=args.delta_capacity,
                           probe_queries=Q[:16], device=device)
        print(f"[serve] fleet: {args.fleet} replicas, open loop @ "
              f"{rate:.0f} qps, {len(Q)} queries")
        if args.fleet_kill > 0:
            FaultPlan([FaultEvent(args.fleet_kill, "kill", "r1"),
                       FaultEvent(args.fleet_kill + 2.0, "restart", "r1")]).start(fleet)
            print(f"[serve] fault plan: kill r1 @ {args.fleet_kill:.1f}s, "
                  f"restart @ {args.fleet_kill + 2.0:.1f}s")
        res = _drive_open(fleet, Q, rate=rate, tolerate_errors=True, deadline=2.0)
        stats = fleet.stats()
        health = fleet.health()
        print(f"[serve] fleet drive: {res['achieved_qps']:.1f} qps achieved "
              f"({res['n_ok']}/{res['n']} ok)  p50={res['p50_ms']:.2f}ms "
              f"p95={res['p95_ms']:.2f}ms p99={res['p99_ms']:.2f}ms")
        print(f"[serve] fleet accounting: accepted={stats['accepted']} "
              f"completed={stats['completed']} shed={stats['shed']} "
              f"timed_out={stats['timed_out']} failed={stats['failed']} "
              f"failovers={stats['failovers']} "
              f"lost_accepted={stats['lost_accepted']}")
        states = ", ".join(f"{name}={rep['state']}"
                           for name, rep in health["replicas"].items())
        print(f"[serve] fleet health: "
              f"{'ok' if health['ok'] else 'DEGRADED'} ({states})")
    finally:
        if fleet is not None:
            fleet.close()
        if ctx is not None:
            ctx.cleanup()


def _parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=50000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--cutoff", type=float, default=0.5)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pipeline-depth", type=int, default=3,
                    help="max batches in flight (stager/completer overlap); "
                         "<=1 runs the synchronous worker loop")
    ap.add_argument("--bucket-batches", action="store_true",
                    help="pad partial batches to the next bucket in "
                         "{8,16,...,max_batch} instead of always max_batch")
    ap.add_argument("--quantize-int8", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="serve through a PagedIndex: fixed-size pages "
                         "behind a page table; appends, promotion, "
                         "compaction and eviction are pointer swaps, and "
                         "the index may exceed the device pool (see "
                         "--page-pool)")
    ap.add_argument("--page-rows", type=int, default=0, metavar="R",
                    help="rows per page (default: 256, or the artifact's "
                         "page geometry under --load-index)")
    ap.add_argument("--page-pool", type=int, default=0, metavar="P",
                    help="cap the device page pool at P pages; overflow "
                         "pages stay in pinned host memory and stream in "
                         "waves (default: everything resident)")
    ap.add_argument("--live-append", type=float, default=0.0,
                    metavar="ROWS_PER_S",
                    help="serve through a SegmentedIndex (or the paged index "
                         "under --paged, or a segmented cascade under "
                         "--cascade) and append synthetic documents at this "
                         "rate during the drive; every append swaps a fresh "
                         "segment set into the running server (then compacts "
                         "at the end, except a cascade)")
    ap.add_argument("--delta-capacity", type=int, default=4096,
                    help="fixed capacity of each delta segment (one kernel "
                         "operand shape for live appends), and the rows at "
                         "which an appended extent of a paged index seals")
    ap.add_argument("--open-loop", type=float, default=0.0, metavar="QPS",
                    help="additionally drive Poisson arrivals at QPS and "
                         "report p50/p95/p99 under that load (the fleet's "
                         "drive rate under --fleet, default 200)")
    ap.add_argument("--compare-full", action="store_true",
                    help="after the drive, drive the same tape against the "
                         "unpruned corpus and print the speedup")
    ap.add_argument("--cascade", default=None, metavar="M:N",
                    help="serve a two-resolution cascade: a coarse scan over "
                         "the first M PCA dims (int8) keeps N*k candidates "
                         "per query, then one exact full-m rescore of the "
                         "shortlist (e.g. 64:8)")
    ap.add_argument("--fleet", type=int, default=0, metavar="R",
                    help="serve through a replicated fleet of R servers "
                         "behind a load-aware router (admission control, "
                         "retry-with-failover, health-gated maintenance) "
                         "instead of one bare server")
    ap.add_argument("--fleet-kill", type=float, default=0.0, metavar="SEC",
                    help="with --fleet: kill replica r1 SEC seconds into "
                         "the drive and restart it 2s later, then print the "
                         "accounting the chaos soak asserts")
    ap.add_argument("--sharded", action="store_true",
                    help="lay the pruned index over a mesh of --host-devices "
                         "slots on the run's device: a top-k per slot, then a "
                         "merge of the lists")
    ap.add_argument("--host-devices", type=int, default=0, metavar="N",
                    help="with --sharded: the mesh's slots (default 4), each "
                         "on the run's device (round-robin over the visible "
                         "cards for a bare --device cuda)")
    ap.add_argument("--merge", choices=("flat", "hierarchical"), default=None,
                    help="with --sharded: merge the per-slot lists in one "
                         "stage over every slot (flat, the default), or in "
                         "two over the squarest 2-D factoring of the slots")
    ap.add_argument("--device", default="cuda",
                    help="device to build and serve on (default: cuda; "
                         "raises when there is no CUDA device)")
    ap.add_argument("--save-index", default=None, metavar="DIR",
                    help="persist the built artifact (PCA state + pruned "
                         "vectors + int8 scale; a paged index page by page; "
                         "a cascade's coarse view as a resolution) to DIR "
                         "for later --load-index restarts")
    ap.add_argument("--load-index", default=None, metavar="DIR",
                    help="serve from an on-disk artifact: skips the PCA "
                         "refit and the index build (the paper's "
                         "offline/online split); under --live-append the "
                         "appends mirror durably to DIR")
    args = ap.parse_args(argv)
    if args.save_index and args.load_index:
        ap.error("--save-index and --load-index are mutually exclusive")
    if not args.sharded and (args.host_devices or args.merge):
        ap.error("--host-devices and --merge need --sharded")
    if args.host_devices < 0:
        ap.error("--host-devices must be positive")
    args.host_devices = args.host_devices or (4 if args.sharded else 0)
    args.merge = args.merge or "flat"
    if args.paged and args.sharded:
        ap.error("--paged does not compose with --sharded yet "
                 "(paged per-shard pools: see ROADMAP)")
    if args.paged and args.fleet > 0:
        ap.error("--paged does not compose with --fleet yet "
                 "(paged replicas load via the store auto-detect path)")
    cascade_mn = None
    if args.cascade:
        if args.sharded:
            ap.error("--cascade does not compose with --sharded yet "
                     "(sharded base rescore: see ROADMAP)")
        try:
            mc_s, nf_s = args.cascade.split(":")
            cascade_mn = (int(mc_s), int(nf_s))
        except ValueError:
            ap.error(f"--cascade wants M:N (e.g. 64:8), got {args.cascade!r}")
        if cascade_mn[0] < 1 or cascade_mn[1] < 1:
            ap.error("--cascade M and N must both be >= 1")
    if args.fleet > 0 and (args.sharded or args.cascade or args.live_append > 0):
        ap.error("--fleet composes with the single-node flat index only "
                 "(sharded/cascade fleet replicas: see ROADMAP)")
    return args, cascade_mn


def main(argv: list[str] | None = None) -> None:
    args, cascade_mn = _parse_args(argv)
    device = default_device(args.device)
    if args.fleet > 0:
        _serve_fleet(args, device)
        return
    pool_pages = args.page_pool or None
    mesh = _serve_mesh(args.host_devices, args.merge, device) if args.sharded else None
    updater = appender = cascade_app = None
    D = None

    if args.load_index:
        server, updater, Q = _serve_from_store(args, device, pool_pages, cascade_mn, mesh)
        pruner = server.pruner
    else:
        print(f"[serve] building corpus n={args.n_docs} d={args.dim} on {device}")
        ds = make_dataset("tasb", n_docs=args.n_docs, d=args.dim,
                          query_sets=("dl19",))
        D = torch.as_tensor(ds.docs, device=device)
        Q = _query_tape(ds, args.queries)

        pruner = StaticPruner(cutoff=args.cutoff).fit(D)
        if cascade_mn:
            index = CascadeIndex.build(pruner.prune_index(D), m_coarse=cascade_mn[0],
                                       n_factor=cascade_mn[1],
                                       quantize_int8=args.quantize_int8)
            if args.paged:
                index = index.paged(page_rows=args.page_rows or 256,
                                    pool_pages=pool_pages,
                                    seal_rows=args.delta_capacity)
            _print_cascade("cascade index", index)
        elif mesh is not None:
            index = ShardedDenseIndex.build(pruner.prune_index(D), mesh,
                                            quantize_int8=args.quantize_int8,
                                            merge=args.merge)
            _print_sharded("sharded index", index)
        else:
            index = DenseIndex.build(pruner.prune_index(D),
                                     quantize_int8=args.quantize_int8)
            print(f"[serve] pruned index: {index.n} x {index.dim} "
                  f"({index.nbytes/2**20:.1f} MiB, {index.vectors.dtype})")
            if args.paged:
                index = PagedIndex.from_index(index, page_rows=args.page_rows or 256,
                                              pool_pages=pool_pages,
                                              seal_rows=args.delta_capacity)
                _print_paged("paged index", index)
        if args.save_index:
            st = save_index(args.save_index, index, pruner=pruner)
            print(f"[serve] saved artifact: {args.save_index} "
                  f"({st.nbytes/2**20:.1f} MiB on disk, n={st.n})")
        server = RetrievalServer(index, pruner, k=args.k, max_batch=args.batch,
                                 pipeline_depth=args.pipeline_depth,
                                 bucket_batches=args.bucket_batches)
    append_stop = threading.Event()
    try:
        # every batch shape once before the drive: on a fresh checkout the
        # first search also builds the top-k kernel with nvcc (about a
        # minute), which must not count against the first query's timeout
        server.warmup()
        if args.live_append > 0 and cascade_mn:
            # copy-on-write: append grows both resolutions and swap_index
            # installs the pair at once; no updater (the reference's branch)
            index = server.index
            if isinstance(index.full, DenseIndex):
                index = index.segmented(delta_capacity=args.delta_capacity)
            server.swap_index(index)
            cascade_app = {"rows": 0, "index": index}
            appender = threading.Thread(
                target=_cascade_append_loop, daemon=True,
                args=(server, pruner, cascade_app, args.live_append, args.dim,
                      device, append_stop))
            print(f"[serve] live-append (cascade): {args.live_append:.0f} "
                  f"rows/s (blocks of {APPEND_BLOCK}, delta capacity "
                  f"{args.delta_capacity})")
            appender.start()
        elif args.live_append > 0:
            if updater is None:
                index = server.index
                if not isinstance(index, PagedIndex):
                    # a paged index appends and compacts by pointer swaps
                    index = SegmentedIndex.from_index(
                        index, delta_capacity=args.delta_capacity)
                server.swap_index(index)
                updater = IndexUpdater(pruner=server.pruner, index=index,
                                       delta_capacity=args.delta_capacity)
            updater.server = server
            appender = threading.Thread(
                target=_append_loop, daemon=True,
                args=(updater, args.live_append, args.dim, device, append_stop))
            print(f"[serve] live-append: {args.live_append:.0f} rows/s "
                  f"(blocks of {APPEND_BLOCK}, delta capacity "
                  f"{args.delta_capacity})")
            appender.start()
        wall, lat = _drive(server, Q)
        stats = server.worker_stats()
        lat_ms = lat * 1e3
        mode = "pipelined" if args.pipeline_depth >= 2 else "sync"
        print(f"[serve] pruned ({mode}): {args.queries / wall:.1f} qps  "
              f"p50={np.percentile(lat_ms, 50):.2f}ms "
              f"p99={np.percentile(lat_ms, 99):.2f}ms")
        print(f"[serve] worker: {stats['worker_qps']:.1f} qps span "
              f"({stats['service_qps']:.1f} qps service) over "
              f"{stats['batches']} batches, mean batch "
              f"{stats['mean_batch']:.1f}/{args.batch} "
              f"({stats['occupancy']*100:.0f}% occupancy)")
        if args.open_loop > 0:
            res = _drive_open(server, Q, rate=args.open_loop)
            ostats = server.worker_stats()
            print(f"[serve] open-loop @ {args.open_loop:.0f} qps offered: "
                  f"{res['achieved_qps']:.1f} qps achieved  "
                  f"p50={res['p50_ms']:.2f}ms p95={res['p95_ms']:.2f}ms "
                  f"p99={res['p99_ms']:.2f}ms  "
                  f"worker={ostats['worker_qps']:.1f} qps "
                  f"({ostats['occupancy']*100:.0f}% occupancy)")
        if cascade_app is not None:
            append_stop.set()
            appender.join(timeout=30.0)
            cas = cascade_app["index"]
            print(f"[serve] live-append (cascade): +{cascade_app['rows']} rows "
                  f"in {_delta_units(cas.full)} per resolution, "
                  f"{server.swap_count} atomic swaps; index now {cas.n} rows "
                  f"(both resolutions)")
        elif updater is not None:
            append_stop.set()
            appender.join(timeout=30.0)
            _report_live(server, updater)
    finally:
        append_stop.set()
        server.close()

    if args.compare_full and args.load_index:
        print("[serve] --compare-full needs the raw corpus; skipped under "
              "--load-index")
    elif args.compare_full:
        server2 = RetrievalServer(DenseIndex.build(D), None, k=args.k,
                                  max_batch=args.batch,
                                  pipeline_depth=args.pipeline_depth)
        try:
            server2.warmup()
            wall_full, _ = _drive(server2, Q)   # the same query order and batching
        finally:
            server2.close()
        print(f"[serve] full:   {args.queries / wall_full:.1f} qps  "
              f"speedup={wall_full / wall:.2f}x "
              f"(O(d/m) predicts {args.dim / pruner.kept_dims:.2f}x)")


if __name__ == "__main__":
    main()
