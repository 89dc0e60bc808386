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


@pytest.mark.parametrize("mode", ["plain", "paged", "live_append"])
def test_serve_cli_save_then_load_index(tmp_path, monkeypatch, capsys, mode):
    """``--save-index`` then a restart with ``--load-index``: the restart
    prints the cold start, and its server answers as the one that built the
    artifact (plain, paged, or durable appends through
    ``IndexUpdater.from_store``, which then grow the artifact)."""
    import re

    from repro_torch.core.store import IndexStore
    from test_torch_paged import _assert_close
    Qfix = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    answers = []
    warmup = serve.RetrievalServer.warmup

    def spy(self):
        warmup(self)
        answers.append([self.query(q) for q in Qfix])

    monkeypatch.setattr(serve.RetrievalServer, "warmup", spy)
    path = str(tmp_path / "idx")
    common = ["--device", "cpu", "--queries", "16", "--batch", "8", "--k", "10"]
    serve.main([*common, "--n-docs", "2000", "--dim", "64", "--quantize-int8",
                "--save-index", path])
    out = capsys.readouterr().out
    assert f"saved artifact: {path}" in out
    extra = {"plain": [], "paged": ["--paged", "--page-rows", "32", "--page-pool", "40"],
             "live_append": ["--live-append", "2000", "--delta-capacity", "128"]}[mode]
    serve.main([*common, "--load-index", path, *extra])
    out = capsys.readouterr().out
    assert re.search(r"cold start \(open store -> first query\): [0-9.]+ms", out)
    assert "building corpus" not in out
    if mode == "paged":
        assert "loaded paged index: 2000 x 32" in out and "63 pages x 32 rows, 23 host-tier" in out
    for (ws, wi), (gs, gi) in zip(*answers):
        _assert_close((ws[None], wi[None]), (gs[None], gi[None]), mode)
    if mode == "live_append":
        assert "loaded segmented index: 2000 x 32" in out
        assert "compaction: base+deltas" in out
        grown = IndexStore.open(path)
        assert grown.n > 2000 and grown.meta["compactions"] == 1


def test_serve_cli_save_and_load_are_exclusive(tmp_path):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--save-index", str(tmp_path / "a"),
                    "--load-index", str(tmp_path / "b")])


# -- the cascade, the fleet and --compare-full ---------------------------------


def _spy_answers(monkeypatch, Qfix):
    """Record, right after each server's warmup, its replies to ``Qfix``
    beside the direct ``search_projected`` of the index it serves, each
    query in a batch padded with zero rows as the server pads it (a
    cascade's shortlist is shared by the batch)."""
    answers = []
    warmup = serve.RetrievalServer.warmup

    def spy(self):
        warmup(self)
        W, mean = self._proj
        pad = np.zeros((self.max_batch - 1, Qfix.shape[1]), np.float32)
        direct = [self.index.search_projected(np.vstack([q[None], pad]), W,
                                              k=self.k, mean=mean)
                  for q in Qfix]
        answers.append(([self.query(q) for q in Qfix],
                        [(s[0].numpy(), i[0].numpy()) for s, i in direct]))

    monkeypatch.setattr(serve.RetrievalServer, "warmup", spy)
    return answers


@pytest.mark.parametrize("mode", ["plain", "live", "paged_live"])
def test_serve_cli_cascade(monkeypatch, capsys, mode):
    """``--cascade 16:4`` serves a CascadeIndex whose replies are its own
    direct search; under ``--live-append`` both resolutions grow in
    lockstep through swaps (paged under ``--paged``)."""
    Qfix = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    answers = _spy_answers(monkeypatch, Qfix)
    extra = {"plain": [],
             "live": ["--live-append", "3000", "--delta-capacity", "128"],
             "paged_live": ["--paged", "--page-rows", "32", "--live-append", "3000",
                            "--delta-capacity", "128"]}[mode]
    serve.main(["--device", "cpu", "--n-docs", "1500", "--dim", "64", "--queries", "24",
                "--batch", "8", "--quantize-int8", "--cascade", "16:4", *extra])
    out = capsys.readouterr().out
    assert "cascade index: 1500 x 32 (+ coarse m=16 int8, shortlist 4*k" in out
    assert ("paged)" in out) == (mode == "paged_live")
    replies, direct = answers[0]
    for (s, i), (ws, wi) in zip(replies, direct):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(s, ws)
    if mode != "plain":
        line = [x for x in out.splitlines() if "live-append (cascade): +" in x][0]
        assert "per resolution" in line and "(both resolutions)" in line
        if mode == "paged_live":
            assert "delta page(s)" in line


def test_serve_cli_cascade_save_then_load(tmp_path, monkeypatch, capsys):
    """A cascade saved with ``--save-index`` restarts from the artifact
    with ``--load-index --cascade``: the coarse view comes back from the
    store's resolution and the restart answers as the build did, also
    segmented under ``--live-append`` and paged under ``--paged``."""
    import re

    from repro_torch.core.store import IndexStore
    Qfix = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    answers = _spy_answers(monkeypatch, Qfix)
    path = str(tmp_path / "cas")
    common = ["--device", "cpu", "--queries", "16", "--batch", "8", "--cascade", "16:4"]
    serve.main([*common, "--n-docs", "1500", "--dim", "64", "--quantize-int8",
                "--save-index", path])
    assert [r["m"] for r in IndexStore.open(path).manifest["resolutions"]] == [16]
    for extra in ([], ["--live-append", "3000", "--delta-capacity", "128"], ["--paged"]):
        serve.main([*common, "--load-index", path, *extra])
        out = capsys.readouterr().out
        assert "loaded cascade: 1500 x 32 (+ coarse m=16 int8" in out
        assert re.search(r"cold start \(open store -> first query\): [0-9.]+ms", out)
    first = answers[0][0]
    for replies, _ in answers[1:]:
        for (ws, wi), (gs, gi) in zip(first, replies):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)


def test_serve_cli_compare_full(tmp_path, capsys):
    """``--compare-full`` drives the unpruned corpus after the pruned
    drive and prints the speedup; under ``--load-index`` there is no raw
    corpus, and it says so."""
    path = str(tmp_path / "idx")
    serve.main(["--device", "cpu", "--n-docs", "1200", "--dim", "64", "--queries", "16",
                "--batch", "8", "--cascade", "16:4", "--compare-full", "--save-index", path])
    out = capsys.readouterr().out
    assert "[serve] full:" in out and "speedup=" in out and "predicts 2.00x" in out
    serve.main(["--device", "cpu", "--queries", "16", "--batch", "8", "--compare-full",
                "--load-index", path])
    assert "needs the raw corpus; skipped" in capsys.readouterr().out


def test_serve_cli_fleet_with_kill(capsys):
    """``--fleet 2 --fleet-kill``: two replicas behind the router, r1 killed
    mid-drive and restarted before the drive ends (3.2 s of arrivals);
    every accepted reply is accounted for."""
    serve.main(["--device", "cpu", "--n-docs", "1200", "--dim", "64", "--queries", "640",
                "--batch", "8", "--fleet", "2", "--fleet-kill", "0.2",
                "--open-loop", "200", "--quantize-int8"])
    out = capsys.readouterr().out
    assert "fleet: 2 replicas, open loop @ 200 qps, 640 queries" in out
    assert "fault plan: kill r1 @ 0.2s, restart @ 2.2s" in out
    assert "lost_accepted=0" in out and "fleet health:" in out


@pytest.mark.parametrize("flags", [
    ["--cascade", "64"], ["--cascade", "0:8"], ["--cascade", "a:b"],
    ["--fleet", "2", "--paged"], ["--fleet", "2", "--cascade", "16:4"],
    ["--fleet", "2", "--live-append", "100"], ["--sharded"]])
def test_serve_cli_flag_errors(flags):
    """The reference's flag errors: a malformed ``--cascade``, ``--fleet``
    with ``--paged``, ``--cascade`` or ``--live-append``; ``--sharded`` is
    refused until it is ported."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", *flags])
