"""The port's segmented live index on the CPU against ``repro``'s.

``SegmentedIndex`` appends (rollover, int8 widening) are held to the
reference's op stream, stored bytes, scales and staging exactly, and its
searches to the reference's at rtol = atol = 1e-5 with ids equal up to
near-ties; ``PagedIndex.from_segmented`` to the reference's paged state;
the mixed-scale f32 oracle, global ids after rollover, widening without
clipping, the delta search's fixed operand shape; the port server under
live appends and a compaction swap; and segmented stores written by
either package loaded by the other (per-delta bytes, scales and
capacities exact), with the store's crash windows. Inputs are made with
numpy from a seed. Bitwise segmented = monolithic is a property of the card's fixed
sum order and is held there (``tests/test_torch_cuda.py``).
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    DenseIndex as JaxIndex,
    IndexStore as JaxStore,
    SegmentedIndex as JaxSegmented,
    save_index as jax_save_index,
)
from repro.core.paged import PagedIndex as JaxPaged
from repro_torch.core import (
    IndexStore,
    IndexStoreError,
    IndexUpdater,
    SegmentedIndex,
    merge_segment_topk,
    save_index,
)
from repro_torch.core.index import DenseIndex
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels import _build, ops
from repro_torch.launch.serve import RetrievalServer
from test_torch_paged import _assert_close, _assert_same_state
from test_torch_store import _assert_same_files, _bits

RNG = np.random.default_rng(17)


def _corpus(n=1003, d=48, seed=3, domain_seed=None):
    D, _ = make_corpus("tasb", n_docs=n, d=d, seed=seed, domain_seed=domain_seed)
    return D


def _queries(d=48, nq=7):
    return torch.from_numpy(RNG.standard_normal((nq, d)).astype(np.float32))


def _both(rng, n=300, m=24, quant=False, capacity=64):
    X = rng.standard_normal((n, m)).astype(np.float32)
    jseg = JaxSegmented.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=quant),
                                   delta_capacity=capacity)
    tseg = SegmentedIndex.from_index(DenseIndex.build(torch.from_numpy(X),
                                                      quantize_int8=quant),
                                     delta_capacity=capacity)
    return jseg, tseg


def _blocks(rng, m=24):
    """Open a delta, fill it across a rollover, widen the open one (x9),
    then fill it and open a third."""
    return [rng.standard_normal((37, m)).astype(np.float32),
            rng.standard_normal((50, m)).astype(np.float32),
            (rng.standard_normal((20, m)) * 9.0).astype(np.float32),
            rng.standard_normal((70, m)).astype(np.float32)]


def _assert_same_deltas(jseg, tseg):
    assert tseg.n == jseg.n and tseg.delta_rows == jseg.delta_rows
    assert len(tseg.deltas) == len(jseg.deltas)
    for td, jd in zip(tseg.deltas, jseg.deltas):
        assert td.n_real == jd.n_real and td.capacity == jd.capacity
        np.testing.assert_array_equal(td.vectors.numpy(), np.asarray(jd.vectors))
        np.testing.assert_array_equal(td.raw, jd.raw)
        assert (td.scale is None) == (jd.scale is None)
        if td.scale is not None:
            np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_segmented_appends_match_reference(quant):
    rng = np.random.default_rng(11)
    d, m, B = 48, 24, 6
    jseg, tseg = _both(rng, m=m, quant=quant)
    W = (rng.standard_normal((d, m)) * 0.2).astype(np.float32)
    mean = (rng.standard_normal(d) * 0.1).astype(np.float32)
    Qraw = rng.standard_normal((B, d)).astype(np.float32)
    Qm = rng.standard_normal((B, m)).astype(np.float32)
    kinds = []
    for i, bl in enumerate(_blocks(rng, m)):
        jseg, jops = jseg.append_with_ops(bl)
        tseg, tops = tseg.append_with_ops(bl)
        assert [o[:2] for o in tops] == [o[:2] for o in jops], i
        for to, jo in zip(tops, jops):
            np.testing.assert_array_equal(to[2], np.asarray(jo[2]))
            if to[0] != "extend":
                assert (to[3] is None) == (jo[3] is None)
                if to[3] is not None:
                    np.testing.assert_array_equal(to[3], np.asarray(jo[3]))
        kinds += [o[0] for o in tops]
        _assert_same_deltas(jseg, tseg)
        for k in (9, 100):
            _assert_close(jseg.search(jnp.asarray(Qm), k), tseg.search(Qm, k),
                          f"append {i} k={k}")
            _assert_close(
                jseg.search_projected(jnp.asarray(Qraw), jnp.asarray(W), k,
                                      mean=jnp.asarray(mean)),
                tseg.search_projected(Qraw, W, k, mean=mean),
                f"append {i} projected k={k}")
    assert [dl.n_real for dl in tseg.deltas] == [64, 64, 49]
    assert ("widen" in kinds) == quant


def test_merge_segment_topk_keeps_first_occurrence():
    """Equal scores across segments go to the earlier segment (lower ids)."""
    s = torch.tensor([[3.0, 1.0]])
    merged = merge_segment_topk([(s, torch.tensor([[0, 1]], dtype=torch.int32)),
                                 (s, torch.tensor([[5, 6]], dtype=torch.int32))], 3)
    assert merged[1].tolist() == [[0, 5, 1]]
    one = (s, torch.tensor([[0, 1]], dtype=torch.int32))
    assert merge_segment_topk([one], 2) is one


def test_mixed_scale_ids_match_f32_oracle():
    """Per-segment scales (an OOD append widened the delta's): ids and order
    match exact f32 search over the per-segment DEQUANTISED vectors."""
    D = _corpus(600, 32)
    base = DenseIndex.build(torch.from_numpy(D), quantize_int8=True)
    seg = SegmentedIndex.from_index(base, delta_capacity=128)
    ood = np.concatenate([_corpus(80, 32, seed=9) * 12.0, _corpus(40, 32, seed=11)])
    seg = seg.append(ood)
    assert len(seg.deltas) == 1
    assert not torch.equal(seg.deltas[0].scale, base.scale)
    dq = [base.vectors.float() * base.scale[None, :]]
    dq += [d.vectors[:d.n_real].float() * d.scale[None, :] for d in seg.deltas]
    oracle = DenseIndex.build(torch.cat(dq))
    Q = _queries(32)
    _assert_close(oracle.search(Q, k=10), seg.search(Q, k=10))


def test_append_rollover_and_global_ids():
    D = _corpus(500, 24)
    seg = SegmentedIndex.from_index(DenseIndex.build(torch.from_numpy(D)),
                                    delta_capacity=100)
    extra = _corpus(750, 24, seed=5)[500:]
    seg = seg.append(extra)
    assert seg.n == 750
    assert [d.n_real for d in seg.deltas] == [100, 100, 50]
    for gid in (500, 601, 749):
        _, ids = seg.search(torch.from_numpy(extra[gid - 500][None, :]), k=5)
        assert gid in ids[0].tolist()


def test_ood_append_widens_scale_never_clips():
    """A 50x OOD append lands with a widened per-delta scale; every stored
    value round-trips within half an LSB of its f32 source."""
    D = _corpus(400, 24)
    up = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5, quantize_int8=True,
                            delta_capacity=256)
    in_dom = torch.from_numpy(_corpus(500, 24, domain_seed=5)[400:480])
    up.add_documents(in_dom)
    scale0 = up.index.deltas[0].scale.numpy()
    up.add_documents(50.0 * in_dom[:40])
    d = up.index.deltas[0]
    scale1 = d.scale.numpy()
    assert (scale1 >= scale0).all() and (scale1 > scale0).any()
    stored = d.vectors[:d.n_real].float().numpy()
    err = np.abs(stored * scale1[None, :] - d.raw)
    assert (err <= scale1[None, :] / 2 + 1e-7).all(), \
        "a stored value clipped instead of the scale widening"
    assert up.clip_fraction == 0.0
    assert up.scale_divergence() > 4.0
    assert up.needs_refit(in_dom)                 # the scale policy trips
    assert up.drift_score(50.0 * in_dom[:40]) > 0.8


def test_delta_search_keeps_one_operand_shape(monkeypatch):
    """Appends never change what the delta search hands the kernel: every
    call sees the (capacity, m) int8 buffer, whatever ``n_valid``; and no
    kernel module is built or loaded along the way."""
    D = _corpus(300, 24)
    pruner = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    seg = SegmentedIndex.from_index(
        pruner.build_index(torch.from_numpy(D), quantize_int8=True),
        delta_capacity=512)
    W, mean = pruner.projection()
    calls = []
    topk = ops.topk_score

    def spy(Dx, Q, *, k, n_valid=None, row_ids=None):
        calls.append((tuple(Dx.shape), Dx.dtype, n_valid))
        return topk(Dx, Q, k=k, n_valid=n_valid, row_ids=row_ids)

    def no_build(*a, **kw):
        raise AssertionError("an append built a kernel module")

    monkeypatch.setattr(ops, "topk_score", spy)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    for i in range(6):
        block = pruner.prune_index(torch.from_numpy(_corpus(15 + 7 * i, 24, seed=20 + i)))
        seg = seg.append(block.numpy())
        seg.search_projected(_queries(24, 4), W, k=5, mean=mean)
    assert _build._libs == libs
    assert {c[:2] for c in calls} == {((512, pruner.kept_dims), torch.int8)}
    assert len({c[2] for c in calls}) == 6                # n_valid grew


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_from_segmented_matches_reference(quant):
    rng = np.random.default_rng(23)
    m = 24
    jseg, tseg = _both(rng, n=200, m=m, quant=quant)
    for bl in _blocks(rng, m):
        jseg, tseg = jseg.append(bl), tseg.append(bl)
    jpg = JaxPaged.from_segmented(jseg, page_rows=16)
    tpg = PagedIndex.from_segmented(tseg, page_rows=16)
    _assert_same_state(jpg.storage, tpg.storage, quant)
    assert tpg.storage.seal_rows == 64 and tpg.delta_pages == jpg.delta_pages
    Qm = rng.standard_normal((5, m)).astype(np.float32)
    for k in (9, 100):
        _assert_close(jpg.search(jnp.asarray(Qm), k), tpg.search(Qm, k), f"k={k}")
        _assert_close(tseg.search(Qm, k), tpg.search(Qm, k), f"vs segmented k={k}")
    # the paged index keeps evolving as the reference's does (open extent,
    # widen, seal)
    bl = (rng.standard_normal((30, m)) * 3).astype(np.float32)
    jpg, tpg = jpg.append(bl), tpg.append(bl)
    _assert_same_state(jpg.storage, tpg.storage, quant)
    _assert_close(jpg.search(jnp.asarray(Qm), 9), tpg.search(Qm, 9), "appended")


# ---------------------------------------------------------------------------
# serving: atomic swap under live traffic
# ---------------------------------------------------------------------------


def _unit_corpus(n, d=64, seed=77):
    D = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return D / np.linalg.norm(D, axis=1, keepdims=True)


def test_swap_under_load_soak():
    """Live appends + swaps while concurrent clients hammer the server:
    every reply answers its own query (a dropped reply would hang its
    client, a half-swapped segment set would misroute ids)."""
    D = _unit_corpus(96)
    extra = _unit_corpus(200, seed=78)
    pruner = StaticPruner(cutoff=0.25).fit(torch.from_numpy(D))
    seg = SegmentedIndex.from_index(
        DenseIndex.build(pruner.prune_index(torch.from_numpy(D))), delta_capacity=64)
    server = RetrievalServer(seg, pruner, k=1, max_batch=8, pipeline_depth=3)
    up = IndexUpdater(pruner=pruner, index=seg, server=server, delta_capacity=64)
    try:
        up.add_documents(torch.from_numpy(extra[:8]))
        server.query(D[0])
        swaps0 = server.swap_count
        n_known = 96 + 8
        stop = threading.Event()
        failures: list = []

        def appender():
            i = 8
            while not stop.is_set() and i + 8 <= len(extra):
                up.add_documents(torch.from_numpy(extra[i:i + 8]))
                i += 8
                stop.wait(0.002)

        def client(cid):
            rng = np.random.default_rng(cid)
            try:
                for _ in range(40):
                    doc = int(rng.integers(0, n_known))
                    q = D[doc] if doc < 96 else extra[doc - 96]
                    _, ids = server.query(q, timeout=30.0)
                    if int(ids[0]) != doc:
                        failures.append((cid, doc, int(ids[0])))
            except Exception as e:       # noqa: BLE001 — reported below
                failures.append((cid, "exception", repr(e)))

        app = threading.Thread(target=appender, daemon=True)
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(8)]
        app.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120.0)
        stop.set()
        app.join(timeout=30.0)
        assert not any(t.is_alive() for t in clients + [app])
        assert not failures, f"misrouted/dropped replies: {failures[:5]}"
        assert server.swap_count > swaps0, "appends never swapped the index"
        assert len(up.index.deltas) >= 2                  # rolled over
        for gid in (100, up.index.n - 1):
            _, ids = server.query(extra[gid - 96])
            assert int(ids[0]) == gid
        # close() drains: zero dropped replies at shutdown too
        replies = [server.submit(D[i % 96]) for i in range(50)]
        server.close()
        for i, r in enumerate(replies):
            _, ids = r.get(timeout=5.0)
            assert int(ids[0]) == i % 96
    finally:
        server.close()


def test_swap_during_compaction_under_traffic():
    """A background compaction finishes and swaps mid-serve; queries before,
    during and after all self-retrieve."""
    D = _unit_corpus(96)
    extra = _unit_corpus(64, seed=79)
    pruner = StaticPruner(cutoff=0.25).fit(torch.from_numpy(D))
    base = DenseIndex.build(pruner.prune_index(torch.from_numpy(D)), quantize_int8=True)
    seg = SegmentedIndex.from_index(base, delta_capacity=1024)
    server = RetrievalServer(seg, pruner, k=1, max_batch=8, pipeline_depth=3)
    up = IndexUpdater(pruner=pruner, index=seg, server=server, delta_capacity=1024)
    try:
        up.add_documents(torch.from_numpy(extra))
        swaps_before = server.swap_count
        th = up.compact_async()
        while th.is_alive():
            doc = int(RNG.integers(0, 160))
            q = D[doc] if doc < 96 else extra[doc - 96]
            _, ids = server.query(q, timeout=30.0)
            assert int(ids[0]) == doc
        th.join(timeout=60.0)
        assert not th.is_alive()
        assert server.swap_count == swaps_before + 1
        assert len(up.index.deltas) == 0 and up.health()["ok"]
        for doc in (0, 95, 96, 159):
            q = D[doc] if doc < 96 else extra[doc - 96]
            _, ids = server.query(q, timeout=30.0)
            assert int(ids[0]) == doc
    finally:
        server.close()


# ---------------------------------------------------------------------------
# segmented stores: cross-package round trips and crash windows
# ---------------------------------------------------------------------------


def _both_kind(rng, kind, n=300, m=24, capacity=64):
    """The same base as a reference and a port segmented index: f32, int8
    or bf16 storage."""
    X = rng.standard_normal((n, m)).astype(np.float32)
    if kind == "bf16":
        jb = JaxIndex.build(jnp.asarray(X), dtype=jnp.bfloat16)
        tb = DenseIndex.build(torch.from_numpy(X), dtype=torch.bfloat16)
    else:
        jb = JaxIndex.build(jnp.asarray(X), quantize_int8=kind == "int8")
        tb = DenseIndex.build(torch.from_numpy(X), quantize_int8=kind == "int8")
    return (JaxSegmented.from_index(jb, delta_capacity=capacity),
            SegmentedIndex.from_index(tb, delta_capacity=capacity))


def _assert_same_segments(jseg, tseg):
    """Base and every delta: bytes, row counts, capacities, scales and
    staging equal."""
    np.testing.assert_array_equal(_bits(tseg.base.vectors), _bits(jseg.base.vectors))
    assert [(d.n_real, d.capacity) for d in tseg.deltas] == \
        [(d.n_real, d.capacity) for d in jseg.deltas]
    for td, jd in zip(tseg.deltas, jseg.deltas):
        np.testing.assert_array_equal(_bits(td.vectors), _bits(jd.vectors))
        np.testing.assert_array_equal(td.raw, np.asarray(jd.raw, np.float32))
        assert (td.scale is None) == (jd.scale is None)
        if td.scale is not None:
            np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_segmented_store_cross_package_round_trip(tmp_path, writer, kind):
    """A segmented store (three deltas; int8 ones with mixed scales after a
    widen) written by either package: the same manifest and blobs, and the
    other package's ``SegmentedIndex.load`` rehydrates the same segments
    and answers the same."""
    rng = np.random.default_rng(31)
    jseg, tseg = _both_kind(rng, kind)
    for bl in _blocks(rng):
        jseg, tseg = jseg.append(bl), tseg.append(bl)
    js = jax_save_index(str(tmp_path / "ref"), jseg, chunk_rows=128)
    ts = save_index(str(tmp_path / "port"), tseg, chunk_rows=128)
    assert ts.manifest == js.manifest
    assert ts.is_segmented and [v.kind for v in ts.segments()] == \
        ["base", "delta", "delta", "delta"]
    _assert_same_files(js.path, ts.path)
    if kind == "int8":
        assert not ts.flat_loadable                # mixed per-delta scales
    path = js.path if writer == "repro" else ts.path
    jl = JaxSegmented.load(JaxStore.open(path), delta_capacity=64)
    tl = SegmentedIndex.load(path, delta_capacity=64, device="cpu")
    # both rehydrate the stored bytes, scales and dequantised staging
    _assert_same_segments(jl, tl)
    np.testing.assert_array_equal(_bits(tl.base.vectors), _bits(tseg.base.vectors))
    for a, b in zip(tl.deltas, tseg.deltas):
        np.testing.assert_array_equal(_bits(a.vectors), _bits(b.vectors))
    Qm = rng.standard_normal((5, 24)).astype(np.float32)
    for k in (9, 100):
        _assert_close(jseg.search(jnp.asarray(Qm), k), tl.search(Qm, k),
                      f"{writer} {kind} k={k}")
    # a reload keeps growing as the reference's reload does
    bl = (rng.standard_normal((30, 24)) * 3).astype(np.float32)
    _assert_same_segments(jl.append(bl), tl.append(bl))


def test_segmented_load_is_bitwise_the_saved_index(tmp_path):
    """Within the port: save, reload and search give the saved index's
    bytes and results exactly (the same code on the same device)."""
    rng = np.random.default_rng(32)
    _, tseg = _both_kind(rng, "int8")
    for bl in _blocks(rng):
        tseg = tseg.append(bl)
    loaded = SegmentedIndex.load(save_index(str(tmp_path / "st"), tseg),
                                 delta_capacity=64, device="cpu")
    Qm = torch.from_numpy(rng.standard_normal((5, 24)).astype(np.float32))
    for k in (9, 100):
        for a, b in zip(tseg.search(Qm, k), loaded.search(Qm, k)):
            assert torch.equal(a, b)


def test_pre_segment_artifact_opens_as_single_base(tmp_path):
    """An artifact written before segments existed reads as one base
    segment, and ``SegmentedIndex.load`` serves it like the flat loader."""
    rng = np.random.default_rng(33)
    X = rng.standard_normal((500, 32)).astype(np.float32)
    store = jax_save_index(str(tmp_path / "st"),
                           JaxIndex.build(jnp.asarray(X), quantize_int8=True))
    st = IndexStore.open(store.path)
    assert not st.is_segmented
    views = st.segments()
    assert len(views) == 1 and views[0].kind == "base"
    assert views[0].n == st.n and views[0].offset == 0
    seg = SegmentedIndex.load(st, device="cpu")
    flat = DenseIndex.load(st, device="cpu")
    Q = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    for a, b in zip(flat.search(Q, 10), seg.search(Q, 10)):
        assert torch.equal(a, b)


def test_mixed_scale_store_refuses_flat_load(tmp_path):
    """A flat load would dequantise delta rows with the base's scale: a
    store with per-delta scales must load as a SegmentedIndex."""
    D = _corpus(300, 24)
    up = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5, quantize_int8=True,
                            store_path=str(tmp_path / "st"), delta_capacity=128)
    up.add_documents(torch.from_numpy(9.0 * _corpus(40, 24, seed=5)))
    st = IndexStore.open(str(tmp_path / "st"))
    assert not st.flat_loadable
    with pytest.raises(IndexStoreError, match="SegmentedIndex.load"):
        DenseIndex.load(st, device="cpu")


def test_replace_segment_crash_orphans_ignored(tmp_path):
    """Orphan blobs of a crashed replace (blob written, manifest not
    swapped) leave a valid store; a completed replace swaps the rows and
    deletes the old blobs."""
    st = save_index(str(tmp_path / "st"),
                    DenseIndex.build(torch.from_numpy(_corpus(200, 16))))
    name = st.add_delta(capacity=64)
    st.append(np.ones((4, 16), np.float32), segment=name)
    old = [c["file"] for c in st.segments()[1].entry["chunks"]]
    np.save(os.path.join(st.path, "vectors_999998.npy"), np.zeros((2, 16), np.float32))
    assert IndexStore.open(st.path).n == 204
    st.replace_segment(name, [torch.full((6, 16), 2.0)])
    re = IndexStore.open(st.path)
    assert re.n == 206
    assert torch.equal(re.segments()[1].read_rows(0, 6, device="cpu"), torch.full((6, 16), 2.0))
    assert not any(os.path.exists(os.path.join(st.path, f)) for f in old)
