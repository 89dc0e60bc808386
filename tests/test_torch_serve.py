"""The port's serving pipeline on the CPU: the same replies as ``repro``'s
server on the same query tape (synchronous and pipelined), reply/request
integrity under concurrency, drain on close, deadlines, index swaps, and
the entry point's device default."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DenseIndex as JaxIndex, StaticPruner as JaxPruner
from repro.launch.serve import RetrievalServer as JaxServer
from repro_torch import convert
from repro_torch.core.index import DenseIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.launch import serve
from repro_torch.launch.serve import (
    BatchingQueue,
    RetrievalServer,
    TimedOut,
    _drive,
    _drive_open,
    _lat_summary,
)


def _unit_corpus(n=96, d=64, seed=7):
    """Rows ~unit-norm and well separated: query = row i retrieves id i."""
    D = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return D / np.linalg.norm(D, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def served():
    """The reference's fitted pruner and int8 index, carried into the port."""
    D = _unit_corpus()
    jp = JaxPruner(cutoff=0.25).fit(jnp.asarray(D))
    jindex = JaxIndex.build(jp.prune_index(jnp.asarray(D)), quantize_int8=True)
    s = jp.state
    tp = StaticPruner(cutoff=0.25)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    tindex = convert.dense_index_from_numpy(np.asarray(jindex.vectors),
                                            np.asarray(jindex.scale), device="cpu")
    return D, jp, jindex, tp, tindex


def _replies(server, tape):
    out = [server.submit(q) for q in tape]
    return [r.get(timeout=30) for r in out]


@pytest.mark.parametrize("depth", [1, 3])
def test_replies_equal_reference_server_on_same_tape(served, depth):
    D, jp, jindex, tp, tindex = served
    rng = np.random.default_rng(depth)
    tape = (D[rng.integers(0, len(D), 40)]
            + 0.05 * rng.standard_normal((40, D.shape[1]))).astype(np.float32)
    jserver = JaxServer(jindex, jp, k=5, max_batch=8, pipeline_depth=depth)
    tserver = RetrievalServer(tindex, tp, k=5, max_batch=8, pipeline_depth=depth)
    try:
        want = _replies(jserver, tape)
        got = _replies(tserver, tape)
    finally:
        jserver.close()
        tserver.close()
    for (s1, i1), (s2, i2) in zip(want, got):
        np.testing.assert_array_equal(i2, np.asarray(i1))
        np.testing.assert_allclose(s2, np.asarray(s1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 3])
def test_replies_map_to_requests_under_concurrent_pressure(served, depth):
    D, _, _, tp, tindex = served
    server = RetrievalServer(tindex, tp, k=1, max_batch=8, pipeline_depth=depth)
    got = {}

    def client(ids):
        for i in ids:
            got[i] = int(server.query(D[i], timeout=30)[1][0])

    order = np.random.default_rng(depth).permutation(len(D))
    threads = [threading.Thread(target=client, args=(order[j::6],))
               for j in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
    assert got == {i: i for i in range(len(D))}


def test_close_drains_inflight_without_dropping(served):
    D, _, _, tp, tindex = served
    server = RetrievalServer(tindex, tp, k=1, max_batch=8, pipeline_depth=3)
    replies = [server.submit(D[i]) for i in range(len(D))]
    server.close()
    assert all(not t.is_alive() for t in server._threads)
    assert [int(r.get(timeout=1)[1][0]) for r in replies] == list(range(len(D)))


def test_sync_pipelined_and_bucketed_agree(served):
    D, _, _, tp, tindex = served
    outs = []
    for depth, bucket in [(1, False), (3, False), (3, True)]:
        server = RetrievalServer(tindex, tp, k=5, max_batch=32,
                                 pipeline_depth=depth, bucket_batches=bucket)
        try:
            server.warmup()
            res = _drive_open(server, D[:40], rate=2000.0, collect=True)
        finally:
            server.close()
        outs.append(res["results"])
    for other in outs[1:]:
        for (s1, i1), (s2, i2) in zip(outs[0], other):
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(s1, s2)


def test_load_drives_and_worker_stats(served):
    D, _, _, tp, tindex = served
    server = RetrievalServer(tindex, tp, k=3, max_batch=8)
    try:
        wall, lat = _drive(server, D[:16])
        assert wall > 0 and lat.shape == (16,) and (lat > 0).all()
        res = _drive_open(server, D[:32], rate=500.0)
        assert res["n"] == res["n_ok"] == 32 and res["errors"] == 0
        assert res["p50_ms"] <= res["p99_ms"]
        st = server.worker_stats()
        assert st["batches"] >= 1 and 0 < st["occupancy"] <= 1
        assert st["worker_qps"] > 0 and st["service_qps"] > 0
        server.reset_stats()
        assert server.worker_stats()["batches"] == 0
    finally:
        server.close()
    summ = _lat_summary(np.array([0.001, 0.002, 0.003]))
    assert summ["p50_ms"] == pytest.approx(2.0)


def test_worker_stats_batches_grow_monotonically(served):
    """Reading stats while the completer appends never sees a shrinking
    batch count (the reference's own test of this currently fails)."""
    D, _, _, tp, tindex = served
    server = RetrievalServer(tindex, tp, k=1, max_batch=4, pipeline_depth=3)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(server.worker_stats()["batches"])

    th = threading.Thread(target=reader)
    th.start()
    try:
        for r in [server.submit(D[i % len(D)]) for i in range(200)]:
            r.get(timeout=30)
    finally:
        stop.set()
        th.join(timeout=10)
        server.close()
    assert not th.is_alive() and seen
    assert all(a <= b for a, b in zip(seen, seen[1:]))


def test_submit_validation_and_index_swap(served):
    D, _, _, tp, tindex = served
    server = RetrievalServer(tindex, tp, k=1, max_batch=4)
    try:
        with pytest.raises(ValueError, match="shape"):
            server.submit(np.zeros(3, np.float32))
        assert int(server.query(D[5])[1][0]) == 5
        # swap in an index over the same rows in reverse order
        flipped = DenseIndex(vectors=tindex.vectors.flip(0).contiguous(),
                             scale=tindex.scale)
        server.swap_index(flipped)
        assert server.swap_count == 1
        assert int(server.query(D[5])[1][0]) == len(D) - 1 - 5
        # without a projection the server searches raw m-dim queries
        server.swap_index(tindex, pruner=None)
        with pytest.raises(ValueError, match="shape"):
            server.submit(D[0])
        q = tp.transform_queries(torch.from_numpy(D[7])).numpy()
        assert int(server.query(q)[1][0]) == 7
    finally:
        server.close()


class _Hung:
    """An index whose search blocks until released."""

    def __init__(self, index):
        self.index, self.release = index, threading.Event()
        self.dim, self.device = index.dim, index.device

    def search_projected(self, *a, **kw):
        self.release.wait(timeout=10)
        return self.index.search_projected(*a, **kw)


def test_deadline_expires_work_behind_hung_dispatch(served):
    D, _, _, tp, tindex = served
    hung = _Hung(tindex)
    server = RetrievalServer(hung, tp, k=1, max_batch=4, pipeline_depth=3)
    try:
        first = server.submit(D[0])
        time.sleep(0.1)                   # the stager is now parked in search
        late = [server.submit(D[i], deadline=0.2) for i in range(1, 9)]
        for r in late:
            out = r.get(timeout=5)
            assert isinstance(out, TimedOut)
        with pytest.raises(TimedOut):
            server.query(D[9], deadline=0.05, timeout=5)
        hung.release.set()
        assert int(first.get(timeout=10)[1][0]) == 0
    finally:
        hung.release.set()
        server.close()


def test_batching_queue_coalesces_and_flushes():
    bq = BatchingQueue(max_batch=4, deadline_ms=20.0)
    replies = [bq.submit(np.full((3,), float(i), np.float32)) for i in range(6)]
    vecs, reps = bq.next_batch(timeout=1.0)
    assert vecs.shape == (4, 3) and reps == replies[:4]
    vecs, reps = bq.next_batch(timeout=1.0)
    assert (vecs[:, 0] == [4.0, 5.0]).all()
    assert bq.empty() and bq.drain() == []
    r = serve.Reply()
    assert r.resolve("a") and not r.resolve("b") and r.get_nowait() == "a"


def test_serve_main_runs_on_cpu_when_asked(capsys):
    serve.main(["--device", "cpu", "--n-docs", "600", "--dim", "32",
                "--queries", "24", "--batch", "8", "--quantize-int8",
                "--open-loop", "300"])
    out = capsys.readouterr().out
    assert "pruned index: 600 x 16" in out and "open-loop" in out


def test_serve_main_warms_up_before_the_first_timed_query(monkeypatch, capsys):
    """The entry point runs every batch shape once before its drive, with
    or without bucketing: on a fresh checkout that first search builds the
    card's top-k kernel, which must not eat the first query's timeout."""
    warmed = []
    warmup = serve.RetrievalServer.warmup
    monkeypatch.setattr(serve.RetrievalServer, "warmup",
                        lambda self: warmed.append(self.swap_count) or warmup(self))
    serve.main(["--device", "cpu", "--n-docs", "600", "--dim", "32",
                "--queries", "8", "--batch", "8", "--live-append", "500"])
    assert warmed == [0]                      # before the live index swapped in
    assert "live-append" in capsys.readouterr().out


def test_serve_main_defaults_to_cuda():
    """Without --device the entry point serves on the card; with no card it
    raises and names the device instead of quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="'cuda'"):
        serve.main(["--n-docs", "64", "--dim", "16", "--queries", "4"])
