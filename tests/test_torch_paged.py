"""The port's paged index on the CPU against ``repro``'s.

The plain paged top-k (``ops.topk_score_paged`` on CPU tensors) is held
against ``topk_score_paged_pallas`` in interpret mode and against the
reference's jnp page walk ``_paged_core``; ``PagedIndex`` against the
reference ``PagedIndex(backend="jnp")`` through a whole lifecycle, with
host metadata and int8 page bytes equal exactly; and the port server over
a paged index under append and eviction swaps. Inputs are made with numpy
from a seed; scores agree at rtol = atol = 1e-5, ids up to near-ties.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DenseIndex as JaxIndex, StaticPruner as JaxPruner
from repro.core.index import _scan_topk as jax_scan_topk
from repro.core.paged import PagedIndex as JaxPaged, _paged_core
from repro.kernels.topk_score import topk_score_paged_pallas
from repro_torch import convert
from repro_torch.core.index import DenseIndex
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.kernels import ops
from repro_torch.kernels.topk_score import topk_score_paged_cuda
from repro_torch.launch.serve import RetrievalServer
from test_torch_kernels import _assert_ids_equal_up_to_near_ties

TOL = dict(rtol=1e-5, atol=1e-5)


def _assert_close(want, got, msg=""):
    ws, wi = (np.asarray(x) for x in want)
    gs, gi = (np.asarray(x) for x in got)
    np.testing.assert_allclose(gs, ws, err_msg=msg, **TOL)
    _assert_ids_equal_up_to_near_ties(ws, wi, gs, gi)


def _two_tier(dtype=np.float32, seed=0):
    """A corpus over a scrambled pool + tail page layout with a partial last
    page (``tests/test_paged.py``'s fixture)."""
    rng = np.random.default_rng(seed)
    R, m, B, k = 8, 32, 5, 7
    npages, n_last = 11, 3
    n = (npages - 1) * R + n_last
    D = rng.standard_normal((n, m)).astype(np.float32)
    Q = rng.standard_normal((B, m)).astype(np.float32)
    pool_pages, tail_pages, table_cap = 7, 6, 16
    pt = np.full(table_cap, -1, np.int32)
    pt[:npages] = rng.permutation(npages)
    nv = np.zeros(table_cap, np.int32)
    nv[:npages] = R
    nv[npages - 1] = n_last
    off = np.zeros(table_cap, np.int32)
    off[:npages] = np.arange(npages) * R
    scale = np.zeros((table_cap, m), np.float32)
    pool = np.zeros((pool_pages, R, m), dtype)
    tail = np.zeros((tail_pages, R, m), dtype)
    for j in range(npages):
        rows = D[j * R:j * R + nv[j]]
        if dtype == np.int8:
            scale[j] = np.abs(rows).max(axis=0).clip(1e-12) / 127.0
            rows = np.clip(np.round(rows / scale[j]), -127, 127).astype(np.int8)
        buf, idx = (pool, pt[j]) if pt[j] < pool_pages else (tail, pt[j] - pool_pages)
        buf[idx, :nv[j]] = rows
    return dict(pool=pool, tail=tail, pt=pt, nv=nv, off=off, Q=Q, k=k,
                npages=npages, R=R, scale=scale if dtype == np.int8 else None)


def _both_paged(f, lo, hi, k, *, carry=None, finalize=True, ids_pool=None,
                with_scale=False):
    """The same paged call through the port (CPU) and the Pallas kernel in
    interpret mode."""
    sc = f["scale"] if with_scale else None
    got = ops.topk_score_paged(
        torch.from_numpy(f["pool"]), torch.from_numpy(f["pt"]),
        torch.from_numpy(f["nv"]), torch.from_numpy(f["off"]), lo, hi,
        torch.from_numpy(f["Q"]), k=k, tail=torch.from_numpy(f["tail"]),
        page_scale=None if sc is None else torch.from_numpy(sc),
        ids_pool=None if ids_pool is None else torch.from_numpy(ids_pool),
        carry=None if carry is None else tuple(torch.from_numpy(np.asarray(c))
                                               for c in carry[0]),
        finalize=finalize)
    want = topk_score_paged_pallas(
        jnp.asarray(f["pool"]), jnp.asarray(f["pt"]), jnp.asarray(f["nv"]),
        jnp.asarray(f["off"]), jnp.int32(lo), jnp.int32(hi), jnp.asarray(f["Q"]),
        k=k, tail=jnp.asarray(f["tail"]),
        page_scale=None if sc is None else jnp.asarray(sc),
        ids_pool=None if ids_pool is None else jnp.asarray(ids_pool),
        carry=None if carry is None else carry[1], finalize=finalize,
        interpret=True)
    return want, got


@pytest.mark.parametrize("k", [1, 7, 90])
def test_paged_plain_two_tier_partial_last_page(k):
    f = _two_tier()
    want, got = _both_paged(f, 0, f["npages"], k)
    _assert_close(want, got, f"k={k}")


def test_paged_plain_int8_per_page_scale():
    f = _two_tier(np.int8, seed=2)
    want, got = _both_paged(f, 0, f["npages"], f["k"], with_scale=True)
    _assert_close(want, got, "int8 page scale")


def test_paged_plain_ids_pool_rescore_mode():
    f = _two_tier(seed=3)
    rng = np.random.default_rng(3)
    table_cap, R = f["pt"].shape[0], f["R"]
    ids_pool = np.full((table_cap, R), -1, np.int32)
    ids = rng.permutation(200).astype(np.int32)[:f["npages"] * R] + 7
    for j in range(f["npages"]):
        ids_pool[j, :f["nv"][j]] = ids[j * R:j * R + f["nv"][j]]
    ids_pool[2, 3] = -1                       # masked row inside a page
    want, got = _both_paged(f, 0, f["npages"], f["k"], ids_pool=ids_pool)
    _assert_close(want, got, "ids_pool")


@pytest.mark.parametrize("k", [7, 60])
def test_paged_plain_carry_split_and_pad_ids(k):
    """A run split at slot 4 and chained through the carry gives the single
    pass's result; the un-finalized pad ids equal the reference page walk's
    exactly (slot j after c finite slots: -(j - c + 2))."""
    f = _two_tier(seed=1)
    n_slots = f["npages"]
    args = [torch.from_numpy(f[x]) for x in ("pool", "pt", "nv", "off")]
    Q, tail = torch.from_numpy(f["Q"]), torch.from_numpy(f["tail"])
    part = ops.topk_score_paged(*args, 0, 4, Q, k=k, tail=tail, finalize=False)
    jargs = [jnp.asarray(f["pool"]), jnp.asarray(f["tail"]),
             jnp.asarray(f["pt"]), None, jnp.asarray(f["nv"]),
             jnp.asarray(f["off"])]
    jQ = jnp.asarray(f["Q"])
    jpart = _paged_core(*jargs, 0, 4, jQ, k, "row", None, False)
    np.testing.assert_allclose(part[0].numpy(), np.asarray(jpart[0]), **TOL)
    pads = ~np.isfinite(np.asarray(jpart[0]))
    assert pads.any() == (k > 4 * f["R"])
    np.testing.assert_array_equal(part[1].numpy()[pads], np.asarray(jpart[1])[pads])
    got = ops.topk_score_paged(*args, 4, n_slots, Q, k=k, tail=tail, carry=part)
    want = _paged_core(*jargs, 4, n_slots, jQ, k, "row", jpart, True)
    _assert_close(want, got, "carry chain vs jnp walk")
    single, _ = _both_paged(f, 0, n_slots, k)
    _assert_close(single, got, "carry chain vs single Pallas pass")
    # the chain's last link unfinalized keeps numbering pads by rank
    tail_part = ops.topk_score_paged(*args, 4, n_slots, Q, k=k, tail=tail,
                                     carry=part, finalize=False)
    s, i = tail_part[0].numpy(), tail_part[1].numpy()
    for b in range(s.shape[0]):
        c = int(np.isfinite(s[b]).sum())
        np.testing.assert_array_equal(i[b, c:], -(np.arange(c, k) - c + 2))


def test_paged_cuda_wrapper_refuses_cpu_tensors():
    f = _two_tier()
    with pytest.raises(ValueError, match="one CUDA device"):
        topk_score_paged_cuda(*(torch.from_numpy(f[x]) for x in
                                ("pool", "pt", "nv", "off")), 0, 3,
                              torch.from_numpy(f["Q"]), k=3)
    with pytest.raises(ValueError, match="must all be on the CPU"):
        ops.topk_score_paged(torch.from_numpy(f["pool"]), torch.from_numpy(f["pt"]),
                             torch.from_numpy(f["nv"]), torch.from_numpy(f["off"]),
                             0, 3, torch.empty((2, 32), device="meta"), k=3)


def _big_two_tier(dtype, seed, R=64, npages=40):
    """_two_tier's layout at more rows than the old k cap (2,531 rows in
    40 pages of 64 over a scrambled pool + tail, a partial last page,
    per-page int8 scales)."""
    rng = np.random.default_rng(seed)
    m, B, n_last = 32, 4, 35
    n = (npages - 1) * R + n_last
    D = rng.standard_normal((n, m)).astype(np.float32) / np.sqrt(m)
    Q = rng.standard_normal((B, m)).astype(np.float32)
    pool_pages, tail_pages = 23, 20
    pt = rng.permutation(pool_pages + tail_pages)[:npages].astype(np.int32)
    nv = np.full(npages, R, np.int32)
    nv[-1] = n_last
    off = (np.arange(npages) * R).astype(np.int32)
    scale = np.zeros((npages, m), np.float32)
    pool = np.zeros((pool_pages, R, m), dtype)
    tail = np.zeros((tail_pages, R, m), dtype)
    for j in range(npages):
        rows = D[j * R:j * R + nv[j]]
        if dtype == np.int8:
            scale[j] = np.abs(rows).max(axis=0).clip(1e-12) / 127.0
            rows = np.clip(np.round(rows / scale[j]), -127, 127).astype(np.int8)
        buf, idx = (pool, pt[j]) if pt[j] < pool_pages else (tail, pt[j] - pool_pages)
        buf[idx, :nv[j]] = rows
    return dict(pool=pool, tail=tail, pt=pt, nv=nv, off=off, Q=Q, npages=npages, R=R,
                scale=scale if dtype == np.int8 else None)


def _port_paged(f, lo, hi, k, **kw):
    t = {x: torch.from_numpy(f[x]) for x in ("pool", "pt", "nv", "off", "Q", "tail")}
    if f["scale"] is not None:
        kw["page_scale"] = torch.from_numpy(f["scale"])
    return ops.topk_score_paged(t["pool"], t["pt"], t["nv"], t["off"], lo, hi, t["Q"], k=k,
                                tail=t["tail"], **kw)


def _jax_paged(f, lo, hi, k, carry, finalize):
    return _paged_core(jnp.asarray(f["pool"]), jnp.asarray(f["tail"]), jnp.asarray(f["pt"]),
                       None if f["scale"] is None else jnp.asarray(f["scale"]),
                       jnp.asarray(f["nv"]), jnp.asarray(f["off"]), lo, hi,
                       jnp.asarray(f["Q"]), k, "row", carry, finalize)


@pytest.mark.parametrize("k", [1100, 2600])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_plain_large_k_tail_scale_carry(quant, k):
    """k above the old 1024 cap (and past the rows: pads) against the
    reference's jnp page walk: pool and tail tiers, per-page int8 scale
    rows, a run split and chained through the carry, its un-finalized
    head's pad ids equal exactly, and an un-finalized last link."""
    f = _big_two_tier(np.int8 if quant else np.float32, seed=7 + quant)
    npages, split = f["npages"], 17
    want = _jax_paged(f, 0, npages, k, None, True)
    _assert_close(want, _port_paged(f, 0, npages, k), "single pass")
    jhead = _jax_paged(f, 0, split, k, None, False)
    head = _port_paged(f, 0, split, k, finalize=False)
    np.testing.assert_allclose(head[0].numpy(), np.asarray(jhead[0]), **TOL)
    pads = np.isneginf(np.asarray(jhead[0]))
    assert pads.any() == (k > split * f["R"])
    np.testing.assert_array_equal(head[1].numpy()[pads], np.asarray(jhead[1])[pads])
    for fin in (True, False):
        got = _port_paged(f, split, npages, k, carry=head, finalize=fin)
        ref_ = _jax_paged(f, split, npages, k, jhead, fin)
        _assert_close(ref_, got, f"carry chain finalize={fin}")
        pads = np.isneginf(np.asarray(ref_[0]))
        np.testing.assert_array_equal(got[1].numpy()[pads], np.asarray(ref_[1])[pads])


@pytest.mark.parametrize("k", [1100, 2600])
def test_paged_plain_large_k_ids_pool(k):
    """ids_pool at k above the old cap: the reference's jnp scan over the
    live rows sorted by id (the lowest id wins a tie), against the port's
    paged walk in ids_pool mode."""
    f = _big_two_tier(np.float32, seed=9)
    rng = np.random.default_rng(9)
    npages, R = f["npages"], f["R"]
    ids_pool = rng.permutation(npages * R).astype(np.int32).reshape(npages, R) + 3
    ids_pool[rng.random((npages, R)) < 0.1] = -1
    got = _port_paged(f, 0, npages, k, ids_pool=torch.from_numpy(ids_pool))
    rows = np.concatenate([f["pool"], f["tail"]])[f["pt"]].reshape(npages * R, -1)
    ids = ids_pool.reshape(-1)
    order = np.argsort(np.where(ids < 0, np.iinfo(np.int32).max, ids), kind="stable")
    order = order[ids[order] >= 0]
    s, p = jax_scan_topk(jnp.asarray(rows[order]), jnp.asarray(f["Q"]), k, block=1024)
    p = np.asarray(p)
    want = (np.asarray(s), np.where(p >= 0, ids[order][np.clip(p, 0, None)], -1))
    _assert_close(want, got, "ids_pool")


# ---------------------------------------------------------------------------
# PagedIndex against the reference's, through the lifecycle
# ---------------------------------------------------------------------------

def _pages(st, reference: bool):
    """Every logical slot's page bytes, read off whichever tier holds it."""
    pool = np.asarray(st.pool)
    tail = np.asarray(st.tail_host) if reference else st.tail.numpy()
    out = []
    for slot in range(st.n_slots):
        phys = int(st.pt_host[slot])
        if phys < 0:
            page = np.asarray(st.host_pages[slot])
        elif phys >= pool.shape[0]:
            page = tail[phys - pool.shape[0]]
        else:
            page = pool[phys]
        out.append(np.asarray(page)[:int(st.nvalid_host[slot])])
    return out


def _assert_same_state(jst, tst, quant):
    np.testing.assert_array_equal(tst.pt_host, jst.pt_host)
    np.testing.assert_array_equal(tst.nvalid_host, jst.nvalid_host)
    np.testing.assert_array_equal(tst.offset_host, jst.offset_host)
    if quant:
        np.testing.assert_array_equal(tst.scale_host, jst.scale_host)
    else:
        assert tst.scale_host is None and jst.scale_host is None
    assert tst.free_pool == jst.free_pool and tst.free_tail == jst.free_tail
    assert sorted(tst.host_pages) == sorted(jst.host_pages)
    assert len(tst.extents) == len(jst.extents)
    for te, je in zip(tst.extents, jst.extents):
        assert tuple(te[:6]) == tuple(je[:6])
        for a, b in ((te.scale, je.scale), (te.raw, je.raw)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
    for tp, jp in zip(_pages(tst, False), _pages(jst, True)):
        if quant:
            np.testing.assert_array_equal(tp, jp)      # int8 bytes exactly
        else:
            np.testing.assert_array_equal(tp, np.asarray(jp, np.float32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_lifecycle_matches_reference(quant):
    rng = np.random.default_rng(1)
    n, d, m, B, k = 500, 48, 24, 6, 9
    X = rng.standard_normal((n, m)).astype(np.float32)
    W = rng.standard_normal((d, m)).astype(np.float32) * 0.2
    mean = rng.standard_normal(d).astype(np.float32) * 0.1
    Qraw = rng.standard_normal((B, d)).astype(np.float32)
    Qm = rng.standard_normal((B, m)).astype(np.float32)
    jpg = JaxPaged.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=quant),
                              page_rows=32, seal_rows=96, backend="jnp")
    tpg = PagedIndex.from_index(DenseIndex.build(torch.from_numpy(X),
                                                 quantize_int8=quant),
                                page_rows=32, seal_rows=96)

    def check(step):
        _assert_same_state(jpg.storage, tpg.storage, quant)
        _assert_close(jpg.search(jnp.asarray(Qm), k), tpg.search(Qm, k), step)
        _assert_close(
            jpg.search_projected(jnp.asarray(Qraw), jnp.asarray(W), k,
                                 mean=jnp.asarray(mean)),
            tpg.search_projected(Qraw, W, k, mean=mean), step + " projected")

    check("base")
    blocks = [rng.standard_normal((37, m)).astype(np.float32),
              (rng.standard_normal((20, m)) * 9.0).astype(np.float32),  # widens
              rng.standard_normal((150, m)).astype(np.float32)]
    for i, bl in enumerate(blocks):
        jpg, tpg = jpg.append(bl), tpg.append(bl)
        check(f"append {i}")
    before = tpg.search(Qm, k)
    (jpg, jn), (tpg, tn) = jpg.promote(), tpg.promote()
    assert jn == tn
    check("promote")
    (jpg, js), (tpg, ts) = jpg.compact_pages(), tpg.compact_pages()
    assert js == ts and tpg.delta_pages == 0
    check("compact")
    (jpg, je), (tpg, te) = jpg.evict(7), tpg.evict(7)
    assert je == te == 7 and tpg.storage.n_host_pages >= 7
    check("evict")
    after = tpg.search(Qm, k)
    # promote, compact and evict move pointers, never results
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    jpg, tpg = jpg.append(blocks[0]), tpg.append(blocks[0])
    check("append while oversubscribed")


def test_paged_construction_oversubscription():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((500, 24)).astype(np.float32)
    Qm = rng.standard_normal((5, 24)).astype(np.float32)
    jpg = JaxPaged.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=True),
                              page_rows=32, pool_pages=6, seal_rows=96)
    tpg = PagedIndex.from_index(DenseIndex.build(torch.from_numpy(X),
                                                 quantize_int8=True),
                                page_rows=32, pool_pages=6, seal_rows=96,
                                wave_pages=3)
    assert tpg.storage.n_host_pages == jpg.storage.n_host_pages > 0
    _assert_same_state(jpg.storage, tpg.storage, True)
    _assert_close(jpg.search(jnp.asarray(Qm), 8), tpg.search(Qm, 8))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_k_exceeding_n_clamps(quant):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((5, 24)).astype(np.float32)
    Qm = rng.standard_normal((3, 24)).astype(np.float32)
    want = JaxPaged.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=quant),
                               page_rows=32).search(jnp.asarray(Qm), 50)
    got = PagedIndex.from_index(DenseIndex.build(torch.from_numpy(X),
                                                 quantize_int8=quant),
                                page_rows=32).search(Qm, 50)
    assert tuple(got[1].shape) == (3, 5)
    _assert_close(want, got)


def test_convert_carries_reference_paged_index_across():
    rng = np.random.default_rng(30)
    X = rng.standard_normal((400, 24)).astype(np.float32)
    Qm = rng.standard_normal((5, 24)).astype(np.float32)
    jpg = JaxPaged.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=True),
                              page_rows=32, seal_rows=96)
    jpg = jpg.append(rng.standard_normal((50, 24)).astype(np.float32))
    jpg = jpg.append((rng.standard_normal((60, 24)) * 6).astype(np.float32))
    jpg, _ = jpg.evict(4)
    st = jpg.storage
    tpg = convert.paged_index_from_numpy(
        np.asarray(st.pool), np.asarray(st.tail), dict(st.host_pages),
        st.pt_host, st.nvalid_host, st.offset_host, st.scale_host,
        [tuple(e) for e in st.extents], st.free_pool, st.free_tail,
        page_rows=st.page_rows, seal_rows=st.seal_rows, device="cpu")
    _assert_same_state(st, tpg.storage, True)
    _assert_close(jpg.search(jnp.asarray(Qm), 8), tpg.search(Qm, 8))
    # the carried index keeps evolving as the reference does
    bl = rng.standard_normal((30, 24)).astype(np.float32) * 3
    jpg, tpg = jpg.append(bl), tpg.append(bl)
    _assert_same_state(jpg.storage, tpg.storage, True)
    _assert_close(jpg.search(jnp.asarray(Qm), 8), tpg.search(Qm, 8))


# ---------------------------------------------------------------------------
# serving: append and eviction swaps under live traffic
# ---------------------------------------------------------------------------

def _unit_corpus(n, d=64, seed=77):
    D = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return D / np.linalg.norm(D, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def paged_served():
    """The reference's pruner carried into the port, and a paged index of
    the port's own build over the pruned corpus."""
    D = _unit_corpus(192)
    extra = _unit_corpus(200, seed=78)
    jp = JaxPruner(cutoff=0.25).fit(jnp.asarray(D))
    s = jp.state
    tp = StaticPruner(cutoff=0.25)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    base = DenseIndex.build(tp.prune_index(torch.from_numpy(D)))
    extra_pruned = tp.prune_index(torch.from_numpy(extra)).numpy()
    return D, (extra, extra_pruned), tp, PagedIndex.from_index(
        base, page_rows=32, seal_rows=64, wave_pages=2)


def _soak(server, queries, failures, n_clients=6, per_client=30):
    """Clients self-retrieve: query i must answer id i."""
    def client(cid):
        rng = np.random.default_rng(cid)
        try:
            for _ in range(per_client):
                doc, q = queries(rng)
                _, ids = server.query(q, timeout=30.0)
                if int(ids[0]) != doc:
                    failures.append((cid, doc, int(ids[0])))
        except Exception as e:    # noqa: BLE001 — reported by the assert
            failures.append((cid, "exception", repr(e)))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    return threads


@pytest.mark.parametrize("depth", [1, 3])
def test_paged_server_append_and_compact_swaps(paged_served, depth):
    D, (extra, extra_pruned), tp, pg = paged_served
    server = RetrievalServer(pg, tp, k=1, max_batch=8, pipeline_depth=depth)
    try:
        cur = pg.append(extra_pruned[:8])
        server.swap_index(cur)
        n0 = len(D) + 8
        stop = threading.Event()
        failures: list = []
        swaps = []

        def appender():
            nonlocal cur
            i = 8
            while not stop.is_set() and i + 8 <= len(extra):
                cur = cur.append(extra_pruned[i:i + 8])
                if i == 96:
                    cur, _ = cur.compact_pages()
                server.swap_index(cur)
                swaps.append(i)
                i += 8
                stop.wait(0.002)

        def pick(rng):
            doc = int(rng.integers(0, n0))
            return doc, (D[doc] if doc < len(D) else extra[doc - len(D)])

        app = threading.Thread(target=appender, daemon=True)
        app.start()
        clients = _soak(server, pick, failures)
        for t in clients:
            t.join(timeout=120.0)
        stop.set()
        app.join(timeout=60.0)
        assert not any(t.is_alive() for t in clients + [app])
        assert not failures, f"misrouted or dropped replies: {failures[:5]}"
        assert swaps, "no append was swapped in"
        for gid in (len(D) + 8, cur.n - 1):
            _, ids = server.query(extra[gid - len(D)])
            assert int(ids[0]) == gid
    finally:
        server.close()


def test_paged_server_eviction_swaps(paged_served):
    D, _, tp, resident = paged_served
    evicted, nev = resident.evict(3)
    assert nev == 3 and evicted.storage.n_host_pages == 3
    server = RetrievalServer(resident, tp, k=1, max_batch=8, pipeline_depth=3)
    try:
        stop = threading.Event()
        failures: list = []

        def flipper():
            flip = 0
            while not stop.is_set():
                server.swap_index((evicted, resident)[flip % 2])
                flip += 1
                stop.wait(0.001)

        def pick(rng):
            doc = int(rng.integers(0, len(D)))
            return doc, D[doc]

        fl = threading.Thread(target=flipper, daemon=True)
        fl.start()
        clients = _soak(server, pick, failures, per_client=40)
        for t in clients:
            t.join(timeout=120.0)
        stop.set()
        fl.join(timeout=30.0)
        assert not any(t.is_alive() for t in clients + [fl])
        assert not failures, f"misrouted or dropped replies: {failures[:5]}"
    finally:
        server.close()


def test_serve_cli_paged_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--n-docs", "2000", "--dim", "64",
                "--queries", "16", "--batch", "8", "--paged", "--page-rows",
                "64", "--page-pool", "12", "--delta-capacity", "512"])
    out = capsys.readouterr().out
    assert "paged index: 2000 x 32" in out and "host-tier" in out
    assert "pipelined" in out
