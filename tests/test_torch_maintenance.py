"""The port's ``IndexUpdater`` on the CPU against ``repro``'s (the mesh-
free tests of ``tests/test_maintenance.py``, ``tests/test_segments.py``
and the updater cases of ``tests/test_store.py`` and
``tests/test_paged.py``).

The reference's fitted PCA state and base bytes are carried into the port,
so drift and energy agree within 1e-5, the telemetry exactly (scale
ratios at 1e-5), and a compaction's int8 bytes exactly. Also: racing
appends reconciled by a background compaction, a failed one surfacing in
``health()``, the paged updater's pointer-swap compaction, and
``--live-append`` through the port's CLI. With a store attached: every
append mirrors durably and bit for bit (segmented and paged), a cold start
through ``from_store`` serves the same results in either package, the
store-backed compaction writes the reference's artifact and the same base
as the store-less one, and a refit rewrites the artifact.
"""
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SegmentedIndex as JaxSegmented, save_index as jax_save_index
from repro.core.maintenance import (
    IndexUpdater as JaxUpdater,
    captured_energy as jax_captured_energy,
)
from repro.core.pruning import StaticPruner as JaxPruner
from repro_torch import convert
from repro_torch.core import IndexStore, IndexUpdater, SegmentedIndex, save_index
from repro_torch.core.index import DenseIndex
from repro_torch.core.maintenance import captured_energy
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.data.synthetic import make_corpus
from test_torch_paged import _assert_close

TOL = dict(rtol=1e-5, atol=1e-5)


def _corpus(seed=0, n=2000, domain_seed=None):
    D, _ = make_corpus("tasb", n_docs=n, d=96, seed=seed, domain_seed=domain_seed)
    return D


def _carried(jp: JaxPruner) -> StaticPruner:
    s = jp.state
    tp = StaticPruner(cutoff=jp.cutoff, center=jp.center)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    return tp


def _pair(D, *, quant=False, delta_capacity=4096, center=False, energy=True):
    """The reference's updater (fit + build on D) and the port's over the
    same fitted state and base bytes."""
    jp = JaxPruner(cutoff=0.5, center=center).fit(jnp.asarray(D))
    jbase = jp.build_index(jnp.asarray(D), quantize_int8=quant)
    jup = JaxUpdater(pruner=jp, index=jbase, delta_capacity=delta_capacity,
                     fit_energy=(jax_captured_energy(jnp.asarray(D), jp)
                                 if energy else None))
    tp = _carried(jp)
    base = convert.dense_index_from_numpy(
        np.asarray(jbase.vectors), None if jbase.scale is None else np.asarray(jbase.scale),
        device="cpu")
    tup = IndexUpdater(pruner=tp, index=base, delta_capacity=delta_capacity,
                       fit_energy=(captured_energy(torch.from_numpy(D), tp)
                                   if energy else None))
    return jup, tup


def _both(fn, jup, tup, X):
    return fn(jup, jnp.asarray(X)), fn(tup, torch.from_numpy(np.asarray(X)))


def test_add_documents_searchable():
    D = _corpus()
    jup, tup = _pair(D)
    n0 = tup.index.n
    new = _corpus(seed=0, n=200, domain_seed=1)[:100]
    jup.add_documents(jnp.asarray(new))
    assert tup.add_documents(torch.from_numpy(new)) == 100
    assert tup.index.n == jup.index.n == n0 + 100
    np.testing.assert_allclose(tup.index.deltas[0].raw, jup.index.deltas[0].raw, **TOL)
    got = tup.search(torch.from_numpy(new[3][None, :]), k=5)
    assert n0 + 3 in got[1][0].tolist()
    _assert_close(jup.search(jnp.asarray(new[:8]), k=10),
                  tup.search(torch.from_numpy(new[:8]), k=10))


def test_add_documents_int8_path():
    D = _corpus()
    jup, tup = _pair(D, quant=True)
    new = _corpus(seed=0, n=120, domain_seed=2)[:50]
    jup.add_documents(jnp.asarray(new))
    tup.add_documents(torch.from_numpy(new))
    assert tup.index.base.vectors.dtype == torch.int8
    assert tup.index.deltas[0].vectors.dtype == torch.int8
    assert tup.index.deltas[0].scale is not None          # its OWN scale
    np.testing.assert_allclose(tup.index.deltas[0].scale.numpy(),
                               np.asarray(jup.index.deltas[0].scale), **TOL)
    s, ids = tup.search(torch.from_numpy(D[:2]), k=5)
    assert torch.isfinite(s).all()
    _assert_close(jup.search(jnp.asarray(D[:6]), k=10), tup.search(torch.from_numpy(D[:6]), k=10))


def test_drift_low_in_domain_high_out_of_domain():
    D = _corpus()
    jup, tup = _pair(D)
    assert abs(tup.fit_energy - jup.fit_energy) < 1e-5
    in_dom = _corpus(seed=0, n=500, domain_seed=3)
    ood, _ = make_corpus("tasb", n_docs=500, d=96, seed=99)
    for X in (in_dom, ood):
        j, t = _both(lambda u, x: u.drift_score(x), jup, tup, X)
        assert abs(t - j) < 1e-5
    assert tup.drift_score(torch.from_numpy(in_dom)) > 0.85
    assert tup.drift_score(torch.from_numpy(ood)) < tup.drift_score(torch.from_numpy(in_dom))


def test_refit_restores_energy():
    D = _corpus()
    up = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5)
    shifted = torch.from_numpy(make_corpus("tasb", n_docs=2000, d=96, seed=99)[0])
    before = up.drift_score(shifted)
    up.refit(shifted)
    after = up.drift_score(shifted)
    assert after > before
    assert abs(after - 1.0) < 0.05
    jup = JaxUpdater.build(jnp.asarray(D), cutoff=0.5)
    jup.refit(jnp.asarray(shifted.numpy()))
    # two fits of the same corpus keep the same subspace's energy
    assert abs(jup.fit_energy - up.fit_energy) < 1e-5


def test_drift_score_without_fit_energy():
    """A directly-constructed updater derives its reference energy from the
    eigenvalues, equal to the reference's and to the corpus-measured one."""
    D = _corpus()
    jup, tup = _pair(D, energy=False)
    assert tup.fit_energy is None
    score = tup.drift_score(torch.from_numpy(D[:500]))
    assert 0.5 < score < 1.5
    assert abs(score - jup.drift_score(jnp.asarray(D[:500]))) < 1e-5
    measured = captured_energy(torch.from_numpy(D), tup.pruner)
    assert abs(tup._reference_energy() - measured) < 2e-3
    assert abs(tup._reference_energy() - jup._reference_energy()) < 1e-5


def test_drift_reference_centered_fit():
    D = _corpus() + 3.0                    # nonzero mean: centering matters
    jup, tup = _pair(D, center=True, energy=False)
    measured = captured_energy(torch.from_numpy(D), tup.pruner)
    assert abs(tup._reference_energy() - measured) < 2e-3
    assert abs(tup._reference_energy() - jup._reference_energy()) < 1e-5
    assert abs(tup.drift_score(torch.from_numpy(D)) - 1.0) < 5e-3


def test_ood_append_scale_policy_trips_refit():
    """Per-delta scales widen instead of clipping; the policy signal is the
    scale divergence between delta and base, which drift cannot see."""
    D = _corpus()
    jup, tup = _pair(D, quant=True)
    in_dom = _corpus(seed=0, n=200, domain_seed=4)[:100]
    for X in (in_dom, 50.0 * in_dom):
        _both(lambda u, x: u.add_documents(x), jup, tup, X)
        assert tup.clip_fraction == jup.clip_fraction == 0.0
        np.testing.assert_allclose(tup.scale_divergence(), jup.scale_divergence(), **TOL)
        assert _both(lambda u, x: u.needs_refit(x), jup, tup, X) in ((True, True),
                                                                     (False, False))
    assert tup.scale_divergence() > 4.0
    assert tup.drift_score(torch.from_numpy(50.0 * in_dom)) > 0.9
    assert tup.needs_refit(torch.from_numpy(50.0 * in_dom))
    assert not _pair(D, quant=True)[1].needs_refit(torch.from_numpy(in_dom))


def test_clip_fraction_zero_on_float_index():
    up = IndexUpdater.build(torch.from_numpy(_corpus()), cutoff=0.5)
    up.add_documents(1e6 * torch.from_numpy(_corpus(seed=0, n=120, domain_seed=5)[:40]))
    assert up.clip_fraction == 0.0
    assert up.scale_divergence() == 1.0             # unquantised: no scales


def test_delta_fraction_trips_refit():
    """Once the deltas hold most of the corpus the policy asks for a
    compaction even with zero drift."""
    D = _corpus(n=400)
    jup, tup = _pair(D)
    in_dom = _corpus(seed=0, n=900, domain_seed=7)[400:]
    _both(lambda u, x: u.add_documents(x), jup, tup, in_dom)
    assert tup.delta_fraction == jup.delta_fraction > 0.5
    assert tup.needs_refit(torch.from_numpy(in_dom[:100]), threshold=0.0)
    tup.compact()
    assert tup.delta_fraction == 0.0
    assert not tup.needs_refit(torch.from_numpy(in_dom[:100]), threshold=0.0)


def test_refit_resets_segments_and_telemetry():
    D = torch.from_numpy(_corpus())
    up = IndexUpdater.build(D, cutoff=0.5, quantize_int8=True)
    up.add_documents(50.0 * torch.from_numpy(_corpus(seed=0, n=120, domain_seed=6)[:40]))
    assert up.scale_divergence() > 1.0
    assert len(up.index.deltas) == 1
    up.refit(D)
    assert up.scale_divergence() == 1.0
    assert len(up.index.deltas) == 0
    assert up.appended_rows == 0


def test_captured_energy_bounds():
    D = _corpus()
    jup, tup = _pair(D)
    e = captured_energy(torch.from_numpy(D), tup.pruner)
    assert 0.0 < e <= 1.0
    assert abs(e - jax_captured_energy(jnp.asarray(D), jup.pruner)) < 1e-5


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_compact_bytes_match_reference(quant):
    """Compaction over the same segments (one widened) gives the
    reference's fresh base byte for byte: one corpus-wide scale."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    jup, tup = _pair(_corpus(n=400), quant=quant, delta_capacity=64)
    jseg = JaxSegmented.from_index(jup.index.base.__class__.build(
        jnp.asarray(X), quantize_int8=quant), delta_capacity=64)
    tseg = SegmentedIndex.from_index(DenseIndex.build(torch.from_numpy(X),
                                                      quantize_int8=quant),
                                     delta_capacity=64)
    for bl in (rng.standard_normal((90, 24)), 7 * rng.standard_normal((20, 24))):
        bl = bl.astype(np.float32)
        jseg, tseg = jseg.append(bl), tseg.append(bl)
    jup.index, tup.index = jseg, tseg
    jup.compact(block_rows=64)
    tup.compact(block_rows=64)
    assert len(tup.index.deltas) == 0 and tup.index.n == 410
    assert tup.last_compaction == jup.last_compaction == {"rows_rebuilt": 410}
    jb, tb = jup.index.base, tup.index.base
    np.testing.assert_array_equal(tb.vectors.numpy(), np.asarray(jb.vectors))
    assert (tb.scale is None) == (jb.scale is None) == (not quant)
    if quant:
        np.testing.assert_array_equal(tb.scale.numpy(), np.asarray(jb.scale))


def test_compact_reconciles_racing_appends():
    """Appends that land while a compaction streams survive the swap: the
    tail rows re-append onto the fresh base."""
    D = _corpus(n=400)[:, :24]
    up = IndexUpdater.build(torch.from_numpy(np.ascontiguousarray(D)), cutoff=0.5,
                            delta_capacity=256)
    up.add_documents(torch.from_numpy(np.ascontiguousarray(_corpus(seed=5, n=50)[:, :24])))
    racing = np.ascontiguousarray(_corpus(seed=6, n=30)[:, :24])
    orig_iter = up._iter_dequant_rows
    started = threading.Event()

    def slow_iter(index, block_rows):
        for blk in orig_iter(index, block_rows):
            started.set()
            time.sleep(0.02)                 # hold the stream open
            yield blk

    up._iter_dequant_rows = slow_iter
    try:
        th = up.compact_async(block_rows=40)
        assert started.wait(30.0)
        up.add_documents(torch.from_numpy(racing))   # lands mid-stream
        th.join(timeout=60.0)
        assert not th.is_alive()
    finally:
        up._iter_dequant_rows = orig_iter
    assert up.index.n == 480 and up.compactions == 1
    assert len(up.index.deltas) == 1 and up.index.deltas[0].n_real == 30
    # the racing rows are the new delta's, at ids 450..479: its staging is
    # their projection, and a search over every row scores racing[7] at id
    # 457 as its projection's product with itself
    proj = up.pruner.prune_index(torch.from_numpy(racing)).float()
    np.testing.assert_array_equal(up.index.deltas[0].raw, proj.numpy())
    s, ids = up.search(torch.from_numpy(racing[7][None, :]), k=480)
    at = ids[0].tolist().index(450 + 7)
    np.testing.assert_allclose(float(s[0, at]), float(proj[7] @ proj[7]), **TOL)


def test_telemetry_safe_under_concurrent_appends():
    """Telemetry and search snapshot (index, pruner) under the lock:
    hammering them while another thread appends never raises."""
    D = torch.from_numpy(_corpus(n=600))
    up = IndexUpdater.build(D, cutoff=0.5, quantize_int8=True, delta_capacity=64)
    probe = torch.from_numpy(_corpus(seed=2, n=64, domain_seed=3))
    errs = []
    done = threading.Event()

    def appender():
        try:
            for i in range(30):
                up.add_documents(torch.from_numpy(_corpus(seed=i + 10, n=40,
                                                          domain_seed=4)[:37]))
        finally:
            done.set()

    th = threading.Thread(target=appender)
    th.start()
    try:
        while not done.is_set():
            try:
                assert 0.0 <= up.delta_fraction <= 1.0
                assert up.scale_divergence() >= 1.0
                assert up.drift_score(probe) > 0.0
                up.needs_refit(probe)
                up.search(probe[:2], k=3)
            except BaseException as e:  # noqa: BLE001 — must fail the test
                errs.append(e)
                break
    finally:
        th.join(timeout=60.0)
    assert not th.is_alive() and not errs
    assert up.appended_rows == 30 * 37
    assert abs(up.delta_fraction - 30 * 37 / up.index.n) < 1e-9


def test_reference_energy_cached_once_and_refit_coherent():
    D = torch.from_numpy(_corpus(n=400))
    pruner = StaticPruner(cutoff=0.5).fit(D)
    up = IndexUpdater(pruner=pruner, index=pruner.build_index(D))
    assert up.fit_energy is None
    ref = up._reference_energy()
    assert up.fit_energy == ref                  # cached under the lock
    assert ref == up._reference_energy()
    D2 = torch.from_numpy(_corpus(seed=9, n=400, domain_seed=7))
    up.refit(D2)
    assert up.fit_energy is not None and up.fit_energy != ref
    assert abs(up.drift_score(D2) - captured_energy(D2, up.pruner) / up.fit_energy) < 1e-9


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_background_compaction_failure_surfaces_in_health(monkeypatch):
    """A compact_async thread that dies is RECORDED: health() flips to
    not-ok and carries the error; serving-path reads still work."""
    D = torch.from_numpy(_corpus(n=400))
    up = IndexUpdater.build(D, cutoff=0.5)
    up.add_documents(torch.from_numpy(_corpus(seed=3, n=80, domain_seed=4)[:40]))
    assert up.health()["ok"]

    def boom(**kw):
        raise RuntimeError("disk full mid-compaction")

    monkeypatch.setattr(up, "compact", boom)
    th = up.compact_async()
    th.join(timeout=60.0)
    assert not th.is_alive()
    health = up.health()
    assert not health["ok"]
    assert health["background_errors"][0]["op"] == "compact"
    assert "disk full" in health["background_errors"][0]["error"]
    _, ids = up.search(D[:2], k=3)
    assert tuple(ids.shape) == (2, 3)


def test_paged_updater_matches_reference():
    """``build(paged=True)``: appends land in delta extents (one widens),
    ``delta_fraction`` counts pages, and ``compact`` is pointer swaps with
    the reference's receipt."""
    D = _corpus(n=600)
    jup = JaxUpdater.build(jnp.asarray(D), cutoff=0.5, quantize_int8=True, paged=True,
                           page_rows=32, delta_capacity=96)
    tup = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5, quantize_int8=True,
                             paged=True, page_rows=32, delta_capacity=96)
    assert isinstance(tup.index, PagedIndex)
    new = _corpus(seed=3, n=200, domain_seed=4)
    for X in (new[:70], 9.0 * new[70:90], new[90:200]):
        _both(lambda u, x: u.add_documents(x), jup, tup, X)
        assert tup.delta_fraction == jup.delta_fraction > 0
    assert tup.scale_divergence() > 1.0
    tup.compact()
    jup.compact()
    assert tup.last_compaction == jup.last_compaction
    assert tup.delta_fraction == 0.0 and tup.compactions == 1
    _, ids = tup.search(torch.from_numpy(new[75:76]), k=5)     # the x9 block
    assert 675 in ids[0].tolist()


def test_store_waits_for_its_port(tmp_path):
    """The store is ported: ``store=`` opens a path and ``store_path=``
    persists the built artifact, and either attaches it for durable
    appends."""
    D = torch.from_numpy(_corpus(n=300))
    up = IndexUpdater.build(D, store_path=str(tmp_path / "a"))
    assert isinstance(up.store, IndexStore) and up.store.n == 300
    pruner = StaticPruner(cutoff=0.5).fit(D)
    save_index(str(tmp_path / "b"), pruner.build_index(D), pruner=pruner)
    up2 = IndexUpdater(pruner=pruner, index=pruner.build_index(D),
                       store=str(tmp_path / "b"))
    assert isinstance(up2.store, IndexStore)
    for u in (up, up2):
        u.add_documents(D[:10])
        assert IndexStore.open(u.store.path).n == 310


def _stored_deltas_equal_served(store_path, index):
    st = IndexStore.open(store_path)
    views = st.segments()
    assert len(views) == 1 + len(index.deltas)
    for v, d in zip(views[1:], index.deltas):
        assert torch.equal(v.read_rows(0, v.n, device="cpu"), d.vectors[:d.n_real])
        assert v.capacity == d.capacity
        if d.scale is not None:
            np.testing.assert_array_equal(v.scale(), d.scale.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_updater_store_mirror_is_bit_identical(tmp_path, quant):
    """Disk and memory never diverge: after appends (a rollover and a
    widening rewrite included), the stored delta bytes and scales are the
    served ones; a cold start from the store answers bitwise the same, and
    the reference's cold start from the port's store under the parity
    contract."""
    D = _corpus(n=400)[:, :48]
    sp = str(tmp_path / "st")
    up = IndexUpdater.build(torch.from_numpy(np.ascontiguousarray(D)), cutoff=0.5,
                            quantize_int8=quant, store_path=sp, delta_capacity=64)
    for X in (_corpus(seed=5, n=60)[:, :48], 30.0 * _corpus(seed=6, n=30)[:, :48],
              _corpus(seed=7, n=20)[:, :48]):
        up.add_documents(torch.from_numpy(np.ascontiguousarray(X)))
    assert len(up.index.deltas) == 2 and IndexStore.open(sp).n == 510
    _stored_deltas_equal_served(sp, up.index)
    Q = torch.from_numpy(np.random.default_rng(8).standard_normal((6, 48)).astype(np.float32))
    up2 = IndexUpdater.from_store(sp, delta_capacity=64, device="cpu")
    assert up2.index.n == 510 and up2.fit_energy is None
    for a, b in zip(up.search(Q, k=10), up2.search(Q, k=10)):
        assert torch.equal(a, b)
    jup = JaxUpdater.from_store(sp, delta_capacity=64)
    _assert_close(jup.search(jnp.asarray(Q.numpy()), k=10), up.search(Q, k=10))
    # a freshly appended doc is findable after the reload
    _, ids = up2.search(torch.from_numpy(np.ascontiguousarray(
        30.0 * _corpus(seed=6, n=30)[3:4, :48])), k=5)
    assert 463 in ids[0].tolist()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_from_store_of_a_reference_mirrored_store(tmp_path, quant):
    """The reference's updater mirrors its appends; the port's cold start
    from that store rehydrates the reference's segments byte for byte and
    answers the same."""
    D = _corpus(n=500)[:, :48]
    sp = str(tmp_path / "st")
    jup = JaxUpdater.build(jnp.asarray(D), cutoff=0.5, quantize_int8=quant,
                           store_path=sp, delta_capacity=64)
    for X in (_corpus(seed=5, n=90)[:, :48], 9.0 * _corpus(seed=6, n=20)[:, :48]):
        jup.add_documents(jnp.asarray(X))
    tup = IndexUpdater.from_store(sp, delta_capacity=64, device="cpu")
    jre = JaxUpdater.from_store(sp, delta_capacity=64)
    assert tup.index.n == jup.index.n == 610
    for td, jd in zip(tup.index.deltas, jre.index.deltas):
        np.testing.assert_array_equal(td.vectors.numpy(), np.asarray(jd.vectors))
        np.testing.assert_array_equal(td.raw, jd.raw)
    Q = np.random.default_rng(9).standard_normal((6, 48)).astype(np.float32)
    _assert_close(jup.search(jnp.asarray(Q), k=10), tup.search(torch.from_numpy(Q), k=10))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_updater_store_mirror(tmp_path, quant):
    """A paged updater mirrors page-granularly: ``from_store`` auto-detects
    the paged block and reloads to the same bits, before and after the
    pointer-swap compaction (one lifecycle-block swap on disk)."""
    rng = np.random.default_rng(40)
    n, d = 600, 48
    corpus = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    Q = torch.from_numpy(rng.standard_normal((4, d)).astype(np.float32))
    sp = str(tmp_path / "store")
    u = IndexUpdater.build(corpus, cutoff=0.5, quantize_int8=quant, store_path=sp,
                           delta_capacity=96, paged=True, page_rows=32)
    assert "paged" in u.store.manifest

    def same(a, b):
        for x, y in zip(a.search(Q, k=6), b.search(Q, k=6)):
            assert torch.equal(x, y)

    u.add_documents(torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32)))
    u.add_documents(torch.from_numpy((rng.standard_normal((70, d)) * 5).astype(np.float32)))
    u2 = IndexUpdater.from_store(sp, device="cpu")
    assert isinstance(u2.index, PagedIndex)
    same(u, u2)
    jre = JaxUpdater.from_store(sp)
    _assert_close(jre.search(jnp.asarray(Q.numpy()), k=6), u.search(Q, k=6))
    u.compact()
    assert set(u.last_compaction) == {"pages_moved", "pages_freed", "pages_host"}
    kinds = [e["kind"] for e in IndexStore.open(sp).manifest["paged"]["extents"]]
    assert kinds == ["base"] * len(kinds)
    u.add_documents(torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32)))
    same(u, IndexUpdater.from_store(sp, device="cpu"))
    u.refit(corpus)
    assert isinstance(u.index, PagedIndex) and IndexStore.open(sp).n == n


def _compaction_pair(tmp_path, quant, with_store):
    """The reference's updater and the port's over the same base bytes and
    fitted state, the base saved as a store by each package when
    ``with_store``; then the same rows appended (one block widens)."""
    rng = np.random.default_rng(4)
    jup, tup = _pair(_corpus(n=400), quant=quant, delta_capacity=64)
    if with_store:
        jup.store = jax_save_index(str(tmp_path / "ref"), jup.index.base, pruner=jup.pruner)
        tup.store = save_index(str(tmp_path / "port"), tup.index.base, pruner=tup.pruner)
    for bl in (rng.standard_normal((90, 48)), 7 * rng.standard_normal((20, 48))):
        bl = bl.astype(np.float32)
        jup.index, tup.index = jup.index.append(bl), tup.index.append(bl)
    return jup, tup


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_store_backed_compact_matches_reference(tmp_path, quant):
    """The store-backed compaction (sidecar build from the stored base and
    the deltas' staging, then ``commit_dir``) writes the reference's
    artifact: the same manifest, meta and blobs; the served base is the
    artifact's; the sidecar is gone."""
    from test_torch_store import _assert_same_files
    jup, tup = _compaction_pair(tmp_path, quant, with_store=True)
    jup.compact(block_rows=64)
    tup.compact(block_rows=64)
    assert tup.last_compaction == jup.last_compaction == {"rows_rebuilt": 510}
    assert tup.store.manifest == jup.store.manifest
    assert tup.store.meta["compactions"] == 1
    _assert_same_files(jup.store.path, tup.store.path)
    assert not os.path.exists(tup.store.path + ".compact")
    served = tup.index.base
    np.testing.assert_array_equal(served.vectors.numpy(), np.asarray(jup.index.base.vectors))
    assert torch.equal(DenseIndex.load(tup.store, device="cpu").vectors, served.vectors)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_store_backed_compact_equals_storeless(tmp_path, quant):
    """The same segment set compacted with and without a store gives the
    same base bytes and scale; later appends land on the compacted store."""
    _, with_store = _compaction_pair(tmp_path, quant, with_store=True)
    _, without = _compaction_pair(tmp_path / "b", quant, with_store=False)
    with_store.compact(block_rows=64)
    without.compact(block_rows=64)
    a, b = with_store.index.base, without.index.base
    assert torch.equal(a.vectors, b.vectors)
    assert (a.scale is None) == (b.scale is None) == (not quant)
    if quant:
        assert torch.equal(a.scale, b.scale)
    assert len(IndexStore.open(with_store.store.path).segments()) == 1
    with_store.add_documents(torch.from_numpy(_corpus(seed=9, n=30)))
    assert IndexStore.open(with_store.store.path).n == 540
    _stored_deltas_equal_served(with_store.store.path, with_store.index)


def test_store_backed_compact_reconciles_racing_appends(tmp_path):
    """Appends that land while the sidecar builds mirror to the live store,
    then re-append onto the fresh base and mirror to the new artifact."""
    D = np.ascontiguousarray(_corpus(n=400)[:, :24])
    sp = str(tmp_path / "st")
    up = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5, delta_capacity=256,
                            quantize_int8=True, store_path=sp)
    up.add_documents(torch.from_numpy(np.ascontiguousarray(_corpus(seed=5, n=50)[:, :24])))
    racing = np.ascontiguousarray(_corpus(seed=6, n=30)[:, :24])
    orig_iter = up._iter_dequant_rows
    started = threading.Event()

    def slow_iter(index, block_rows, store=None):
        for blk in orig_iter(index, block_rows, store):
            started.set()
            time.sleep(0.02)                 # hold the stream open
            yield blk

    up._iter_dequant_rows = slow_iter
    try:
        th = up.compact_async(block_rows=40)
        assert started.wait(30.0)
        up.add_documents(torch.from_numpy(racing))   # lands mid-stream
        th.join(timeout=60.0)
        assert not th.is_alive()
    finally:
        up._iter_dequant_rows = orig_iter
    assert up.health()["ok"] and up.compactions == 1
    st = IndexStore.open(sp)
    assert st.n == up.index.n == 480
    assert [v.n for v in st.segments()] == [450, 30]
    _stored_deltas_equal_served(sp, up.index)
    up2 = IndexUpdater.from_store(sp, delta_capacity=256, device="cpu")
    Q = torch.from_numpy(racing[:4])
    for a, b in zip(up.search(Q, k=5), up2.search(Q, k=5)):
        assert torch.equal(a, b)


def test_refit_rewrites_the_store(tmp_path):
    """A refit replaces the artifact at the same path under the new
    rotation: the store holds the refit corpus and the new PCA state."""
    sp = str(tmp_path / "st")
    up = IndexUpdater.build(torch.from_numpy(_corpus(n=300)), cutoff=0.5, store_path=sp)
    up.add_documents(torch.from_numpy(_corpus(seed=5, n=40)))
    shifted = torch.from_numpy(_corpus(seed=9, n=350, domain_seed=3))
    up.refit(shifted)
    st = IndexStore.open(sp)
    assert st.n == 350 and not st.is_segmented
    np.testing.assert_array_equal(st.load_pca(device="cpu").components.numpy(),
                                  up.pruner.state.components.numpy())
    assert not os.path.exists(sp + ".old") and not os.path.exists(sp + ".tmp")


@pytest.mark.parametrize("paged", [False, True], ids=["segmented", "paged"])
def test_serve_cli_live_append_on_cpu(capsys, paged):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--n-docs", "2000", "--dim", "64",
                "--queries", "48", "--batch", "8", "--live-append", "2000",
                "--delta-capacity", "128", "--quantize-int8",
                *(["--paged", "--page-rows", "32"] if paged else [])])
    out = capsys.readouterr().out
    assert "live-append: 2000 rows/s (blocks of 64, delta capacity 128)" in out
    assert "atomic swaps; index now" in out
    assert ("compaction (paged)" if paged else "compaction: base+deltas") in out
