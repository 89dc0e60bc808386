"""The port's ``IndexUpdater`` on the CPU against ``repro``'s (the store-
and mesh-free tests of ``tests/test_maintenance.py`` and
``tests/test_segments.py``).

The reference's fitted PCA state and base bytes are carried into the port,
so drift and energy agree within 1e-5, the telemetry exactly (scale
ratios at 1e-5), and a compaction's int8 bytes exactly. Also: racing
appends reconciled by a background compaction, a failed one surfacing in
``health()``, the paged updater's pointer-swap compaction, the store
waiting for its port, and ``--live-append`` through the port's CLI.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SegmentedIndex as JaxSegmented
from repro.core.maintenance import (
    IndexUpdater as JaxUpdater,
    captured_energy as jax_captured_energy,
)
from repro.core.pruning import StaticPruner as JaxPruner
from repro_torch import convert
from repro_torch.core import IndexUpdater, SegmentedIndex
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
    _, ids = up.search(torch.from_numpy(racing[7][None, :]), k=5)
    assert (450 + 7) in ids[0].tolist()


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


def test_store_waits_for_its_port():
    D = torch.from_numpy(_corpus(n=300))
    pruner = StaticPruner(cutoff=0.5).fit(D)
    for call in (lambda: IndexUpdater.build(D, store_path="unused"),
                 lambda: IndexUpdater(pruner=pruner, index=pruner.build_index(D),
                                      store="unused")):
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            call()


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
