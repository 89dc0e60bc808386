"""The port's cascade (``repro_torch.core.cascade``) on the CPU against
``repro``'s, case by case after ``tests/test_cascade.py``.

The same numpy inputs (a corpus drawn from ``np.random.default_rng``, the
reference's fitted projection) go through ``repro``'s ``CascadeIndex``
(jnp, and Pallas in interpret mode at the reference's own small n) and the
port's. The port is held to the reference at rtol = atol = 1e-5 with ids
equal up to near-ties, and to its own full-m search where the shortlist
covers the corpus: on the card that anchor is bitwise
(``tests/test_torch_cuda.py``), here the CPU matmul moves by an ULP across
shapes, so it is held to the same bar. Stores cross between the packages
both ways, their ``resolutions`` entries byte for byte.

``test_cascade_append_zero_steady_state_recompiles`` pins a JAX jit cache
and has no counterpart here: the port compiles no program per shape (a
delta's search has one operand shape, held by
``test_torch_segments.py``).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    CascadeIndex as JaxCascade,
    DenseIndex as JaxIndex,
    StaticPruner as JaxPruner,
    save_index as jax_save_index,
)
from repro_torch import convert
from repro_torch.core import CascadeIndex, IndexStore, IndexStoreError, save_index
from repro_torch.core.cascade import _shortlist
from repro_torch.core.index import DenseIndex
from repro_torch.core.paged import PagedIndex
from test_torch_paged import _assert_close
from test_torch_store import _assert_same_files

RNG = np.random.default_rng(17)


def _fixture(n=500, d=64, nq=5, seed=3):
    """A corpus with a decaying spectrum, the reference's fitted projection
    and its pruned rows, and queries, all as numpy."""
    rng = np.random.default_rng(seed)
    D = (rng.standard_normal((n, d)) * np.geomspace(3.0, 0.05, d)).astype(np.float32)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    pruned = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    W, mean = jp.projection()
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    return pruned, np.asarray(W), None if mean is None else np.asarray(mean), Q


def _full_nf(n, k):
    """n_factor making the shortlist cover the corpus: N·k >= n."""
    return -(-n // k)


def _jax_search(index, W, mean, Q, k):
    s, i = index.search_projected(jnp.asarray(Q), jnp.asarray(W), k=k,
                                  mean=None if mean is None else jnp.asarray(mean))
    return np.asarray(s), np.asarray(i)


def _search(index, W, mean, Q, k):
    s, i = index.search_projected(Q, W, k=k, mean=mean)
    return s.numpy(), i.numpy()


def _rows(n, m, seed):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(np.float32)


# ---------------------------------------------------------------------------
# the anchor: a shortlist covering the corpus == the full-m exact search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("backend,n", [("jnp", 500), ("pallas", 64)])
def test_cascade_bitwise_oracle_parity_dense(quant, backend, n):
    """N·k >= n: the port's cascade equals the reference's cascade and the
    port's own full-m search (coarse bytes exact); the reference's cascade
    carried across by ``convert`` answers as the port's own build."""
    k = 8
    pruned, W, mean, Q = _fixture(n=n)
    mc = max(2, pruned.shape[1] // 2)
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=mc, n_factor=_full_nf(n, k),
                          quantize_int8=quant, backend=backend)
    cas = CascadeIndex.build(pruned, m_coarse=mc, n_factor=_full_nf(n, k),
                             quantize_int8=quant, device="cpu")
    np.testing.assert_array_equal(cas.coarse.vectors.numpy(), np.asarray(jc.coarse.vectors))
    np.testing.assert_array_equal(cas.coarse.scale.numpy(), np.asarray(jc.coarse.scale))
    got = _search(cas, W, mean, Q, k)
    _assert_close(_jax_search(jc, W, mean, Q, k), got, "vs the reference's cascade")
    _assert_close(_search(cas.full, W, mean, Q, k), got, "vs the port's full search")
    # the reference's cascade carried across byte for byte answers the same
    carried = convert.cascade_index_from_numpy(
        np.asarray(jc.coarse.vectors), np.asarray(jc.coarse.scale),
        np.asarray(jc.full.vectors),
        None if jc.full.scale is None else np.asarray(jc.full.scale),
        n_factor=jc.n_factor, device="cpu")
    again = _search(carried, W, mean, Q, k)
    np.testing.assert_array_equal(again[1], got[1])
    np.testing.assert_array_equal(again[0], got[0])


@pytest.mark.parametrize("quant", [False, True])
def test_cascade_bitwise_oracle_parity_segmented(quant):
    """Segmented cascade (base + live deltas in both resolutions) against
    the reference's and the port's segmented full-m search; paged both
    sides and the result does not move at all."""
    k, n = 8, 400
    pruned, W, mean, Q = _fixture(n=n)
    extra = _rows(90, pruned.shape[1], 5)
    mc = max(2, pruned.shape[1] // 2)
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=mc, n_factor=_full_nf(n + 90, k),
                          quantize_int8=quant).segmented(delta_capacity=64).append(extra)
    cas = CascadeIndex.build(pruned, m_coarse=mc, n_factor=_full_nf(n + 90, k),
                             quantize_int8=quant, device="cpu"
                             ).segmented(delta_capacity=64).append(extra)
    assert cas.n == n + 90 and cas.coarse.n == cas.full.n
    for mine, ref in zip(cas.coarse.deltas, jc.coarse.deltas):
        np.testing.assert_array_equal(mine.vectors.numpy(), np.asarray(ref.vectors))
    got = _search(cas, W, mean, Q, k)
    _assert_close(_jax_search(jc, W, mean, Q, k), got, "vs the reference's cascade")
    _assert_close(_search(cas.full, W, mean, Q, k), got, "vs the port's full search")
    paged = _search(cas.paged(page_rows=16), W, mean, Q, k)
    np.testing.assert_array_equal(paged[1], got[1])
    np.testing.assert_array_equal(paged[0], got[0])


def test_cascade_recall_monotone_in_shortlist_depth():
    """recall@10 against the full-m search is non-decreasing in N and
    reaches 1.0 at N·k >= n, and each depth's answer is the reference's."""
    k, n = 10, 1200
    pruned, W, mean, Q = _fixture(n=n, nq=8)
    oracle = DenseIndex.build(torch.from_numpy(pruned))
    joracle = JaxIndex.build(jnp.asarray(pruned))
    _, i0 = _search(oracle, W, mean, Q, k)
    recalls = []
    for nf in (1, 2, 4, 8, 16, _full_nf(n, k)):
        cas = CascadeIndex.from_index(oracle, m_coarse=pruned.shape[1] // 4, n_factor=nf)
        jc = JaxCascade.from_index(joracle, m_coarse=pruned.shape[1] // 4, n_factor=nf)
        got = _search(cas, W, mean, Q, k)
        _assert_close(_jax_search(jc, W, mean, Q, k), got, f"n_factor {nf}")
        recalls.append(np.mean([len(set(i0[q]) & set(got[1][q])) / k
                                for q in range(len(i0))]))
    assert all(b >= a for a, b in zip(recalls, recalls[1:])), recalls
    assert recalls[-1] == 1.0


def test_cascade_from_int8_index_requantises_like_the_reference():
    """``from_index`` on an int8 full index dequantises with an f32
    multiply, then quantises the leading columns with their own scale (a
    true division): the coarse bytes and scale equal the reference's."""
    pruned, W, mean, Q = _fixture(n=300)
    joracle = JaxIndex.build(jnp.asarray(pruned), quantize_int8=True)
    full = convert.dense_index_from_numpy(np.asarray(joracle.vectors),
                                          np.asarray(joracle.scale), device="cpu")
    jc = JaxCascade.from_index(joracle, m_coarse=8, n_factor=3)
    cas = CascadeIndex.from_index(full, m_coarse=8, n_factor=3)
    np.testing.assert_array_equal(cas.coarse.vectors.numpy(), np.asarray(jc.coarse.vectors))
    np.testing.assert_array_equal(cas.coarse.scale.numpy(), np.asarray(jc.coarse.scale))
    _assert_close(_jax_search(jc, W, mean, Q, 8), _search(cas, W, mean, Q, 8))


def test_shortlist_and_k_clamping():
    """The shortlist is sorted ascending with duplicates (and pads) -1, so
    the pads lead; k and N·k clamp to n as the reference's do."""
    cids = torch.tensor([[5, 2, -1], [2, 7, 5]], dtype=torch.int32)
    assert _shortlist(cids).tolist() == [-1, 2, -1, 5, -1, 7]
    pruned, W, mean, Q = _fixture(n=12)
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=4, n_factor=8, quantize_int8=True)
    cas = CascadeIndex.build(pruned, m_coarse=4, n_factor=8, quantize_int8=True, device="cpu")
    want, got = _jax_search(jc, W, mean, Q, 20), _search(cas, W, mean, Q, 20)
    assert got[1].shape == (len(Q), 12)
    _assert_close(want, got)


# ---------------------------------------------------------------------------
# construction-time validation
# ---------------------------------------------------------------------------


def test_cascade_rejects_row_count_mismatch():
    pruned, _, _, _ = _fixture(n=120)
    full = DenseIndex.build(torch.from_numpy(pruned))
    coarse = DenseIndex.build(torch.from_numpy(pruned[:100, :4]), quantize_int8=True)
    with pytest.raises(ValueError, match="disagree on row count"):
        CascadeIndex(coarse=coarse, full=full)


def test_cascade_rejects_non_nested_m():
    pruned, _, _, _ = _fixture(n=120)
    full = DenseIndex.build(torch.from_numpy(pruned))
    with pytest.raises(ValueError, match="does not nest"):
        CascadeIndex(coarse=DenseIndex.build(torch.from_numpy(pruned)), full=full)
    with pytest.raises(ValueError, match="n_factor"):
        CascadeIndex.build(pruned, m_coarse=4, n_factor=0, device="cpu")


def test_cascade_append_requires_segmented_resolutions():
    pruned, _, _, _ = _fixture(n=120)
    cas = CascadeIndex.build(pruned, m_coarse=4, device="cpu")
    with pytest.raises(TypeError, match="segmented"):
        cas.append(np.zeros((3, pruned.shape[1]), np.float32))


def test_cascade_appends_grow_both_sides_like_the_reference():
    """Fixed-size appends (a widening one, then shrinking ones) grow both
    resolutions in lockstep; every delta's bytes and scale equal the
    reference's, segmented and paged, and each search agrees."""
    k, n = 5, 300
    pruned, W, mean, Q = _fixture(n=n)
    mc = pruned.shape[1] // 2
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=mc, n_factor=2,
                          quantize_int8=True).segmented(delta_capacity=128)
    cas = CascadeIndex.build(pruned, m_coarse=mc, n_factor=2, quantize_int8=True,
                             device="cpu").segmented(delta_capacity=128)
    paged = cas.paged(page_rows=32)
    block = _rows(8, pruned.shape[1], 9)
    for frac in (1.0, 0.5, 0.4, 0.3, 0.2):
        jc, cas, paged = (x.append(frac * block) for x in (jc, cas, paged))
        want = _jax_search(jc, W, mean, Q, k)
        _assert_close(want, _search(cas, W, mean, Q, k), f"segmented x{frac}")
        _assert_close(want, _search(paged, W, mean, Q, k), f"paged x{frac}")
    assert cas.coarse.n == cas.full.n == paged.n == n + 5 * 8
    for side in ("coarse", "full"):
        for mine, ref in zip(getattr(cas, side).deltas, getattr(jc, side).deltas):
            np.testing.assert_array_equal(mine.vectors.numpy(), np.asarray(ref.vectors))
            np.testing.assert_array_equal(mine.scale.numpy(), np.asarray(ref.scale))


def test_paged_rescore_over_host_tier_equals_segmented():
    """``PagedIndex.rescore`` gathers shortlist rows off the pool, the tail
    and the host pages: with both sides oversubscribed the paged cascade's
    answer is the segmented one's, exactly."""
    k, n = 8, 400
    pruned, W, mean, Q = _fixture(n=n)
    seg = CascadeIndex.build(pruned, m_coarse=16, n_factor=4, quantize_int8=True,
                             device="cpu").segmented(delta_capacity=64)
    seg = seg.append(_rows(100, pruned.shape[1], 4))
    paged = seg.paged(page_rows=16, pool_pages=9, coarse_pool_pages=6, wave_pages=3)
    assert isinstance(paged.full, PagedIndex) and paged.full.storage.n_host_pages > 0
    want = _search(seg, W, mean, Q, k)
    got = _search(paged, W, mean, Q, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_rescore_gathers_host_rows(quant):
    """The rescore alone, on shortlists that reach host pages: the rows
    ``PagedIndex`` gathers are the stored rows byte for byte, and its
    top-k is the segmented rescore's exactly, f32 and int8."""
    k, n = 8, 400
    pruned, W, mean, Q = _fixture(n=n)
    seg = CascadeIndex.build(pruned, m_coarse=16, n_factor=4, quantize_int8=quant,
                             device="cpu").segmented(delta_capacity=64).full
    seg = seg.append(_rows(100, pruned.shape[1], 5))
    paged = PagedIndex.from_segmented(seg, page_rows=16, pool_pages=9)
    assert paged.storage.n_host_pages > 0
    stored = torch.cat([seg.base.vectors] + [d.vectors[:d.n_real] for d in seg.deltas])
    qf = torch.from_numpy((Q - (0 if mean is None else mean)) @ W)
    rng = np.random.default_rng(6)
    for ids in (np.arange(seg.n), rng.choice(seg.n, 60, replace=False), np.arange(5)):
        cids = torch.from_numpy(np.concatenate([ids, ids[:3], [-1, -1]]).astype(np.int32))
        uids = _shortlist(cids[None, :])
        rows, _ = paged._shortlist_rows(uids)
        live = uids >= 0
        assert torch.equal(rows[live], stored[uids[live].long()])
        want, got = seg.rescore(qf, uids, k), paged.rescore(qf, uids, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---------------------------------------------------------------------------
# multi-resolution store: round trips, crossings and rejections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_cascade_store_roundtrip_dense(tmp_path, quant):
    """``save_index`` of a cascade writes the coarse view as a manifest
    resolution; the load searches identically, and both packages write the
    same files."""
    k, n = 8, 300
    pruned, W, mean, Q = _fixture(n=n)
    mc = pruned.shape[1] // 2
    cas = CascadeIndex.build(pruned, m_coarse=mc, n_factor=3, quantize_int8=quant,
                             device="cpu")
    store = save_index(str(tmp_path / "st"), cas)
    loaded = CascadeIndex.load(store, m_coarse=cas.m_coarse, n_factor=3, device="cpu")
    assert (loaded.n, loaded.m_coarse) == (cas.n, cas.m_coarse)
    want, got = _search(cas, W, mean, Q, k), _search(loaded, W, mean, Q, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=mc, n_factor=3, quantize_int8=quant)
    jax_save_index(str(tmp_path / "ref"), jc)
    _assert_same_files(str(tmp_path / "st"), str(tmp_path / "ref"))


def test_cascade_store_roundtrip_segmented(tmp_path):
    """A grown cascade persists through the store: the resolution covers
    the base rows, the coarse deltas reload from their persisted bytes, the
    pair stays row-aligned, and at covering depth the loaded cascade
    answers as its full resolution (and as the in-memory cascade)."""
    k, n = 8, 300
    pruned, W, mean, Q = _fixture(n=n)
    cas = CascadeIndex.build(pruned, m_coarse=pruned.shape[1] // 2,
                             n_factor=_full_nf(n + 40, k), quantize_int8=True,
                             device="cpu").segmented(delta_capacity=64)
    cas = cas.append(_rows(40, pruned.shape[1], 6))
    store = save_index(str(tmp_path / "st"), cas)
    loaded = CascadeIndex.load(store, m_coarse=cas.m_coarse, n_factor=cas.n_factor,
                               segmented=True, delta_capacity=64, device="cpu")
    assert loaded.n == cas.n and loaded.coarse.n == loaded.full.n
    got = _search(loaded, W, mean, Q, k)
    _assert_close(_search(loaded.full, W, mean, Q, k), got)
    want = _search(cas, W, mean, Q, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    paged = CascadeIndex.load(store, m_coarse=cas.m_coarse, n_factor=cas.n_factor,
                              paged=True, page_rows=16, delta_capacity=64, device="cpu")
    assert isinstance(paged.coarse, PagedIndex)
    got = _search(paged, W, mean, Q, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("kind", ["dense", "segmented", "paged"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_cascade_store_crosses_packages(tmp_path, writer, kind):
    """A cascade artifact one package writes loads in the other: the
    same resolution bytes and scales (coarse deltas too), and answers
    within the parity bar; both packages write the same files."""
    k, n = 8, 260
    pruned, W, mean, Q = _fixture(n=n)
    mc = pruned.shape[1] // 2
    extra = [_rows(30, pruned.shape[1], 7), _rows(50, pruned.shape[1], 8)]
    jc = JaxCascade.build(jnp.asarray(pruned), m_coarse=mc, n_factor=4, quantize_int8=True)
    cas = CascadeIndex.build(pruned, m_coarse=mc, n_factor=4, quantize_int8=True,
                             device="cpu")
    if kind != "dense":
        jc, cas = jc.segmented(delta_capacity=64), cas.segmented(delta_capacity=64)
        for rows in extra:
            jc, cas = jc.append(rows), cas.append(rows)
    if kind == "paged":
        jc, cas = jc.paged(page_rows=16, seal_rows=64), cas.paged(page_rows=16, seal_rows=64)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    (jax_save_index if writer == "repro" else save_index)(a, jc if writer == "repro" else cas)
    (save_index if writer == "repro" else jax_save_index)(b, cas if writer == "repro" else jc)
    _assert_same_files(a, b)
    seg = kind != "dense"
    if writer == "repro":
        loaded = CascadeIndex.load(a, m_coarse=mc, n_factor=4, segmented=seg,
                                   delta_capacity=64, device="cpu")
        ref_coarse = jc.coarse if kind != "paged" else None
        got = _search(loaded, W, mean, Q, k)
        _assert_close(_jax_search(jc, W, mean, Q, k), got)
    else:
        loaded = JaxCascade.load(a, m_coarse=mc, n_factor=4, segmented=seg,
                                 delta_capacity=64)
        ref_coarse = cas.coarse if kind != "paged" else None
        _assert_close(_jax_search(loaded, W, mean, Q, k), _search(cas, W, mean, Q, k))
    if ref_coarse is not None:
        lb, rb = (getattr(x, "base", x) for x in (loaded.coarse, ref_coarse))
        np.testing.assert_array_equal(np.asarray(lb.vectors), np.asarray(rb.vectors))
        np.testing.assert_array_equal(np.asarray(lb.scale), np.asarray(rb.scale))
        for ld, rd in zip(getattr(loaded.coarse, "deltas", ()),
                          getattr(ref_coarse, "deltas", ())):
            np.testing.assert_array_equal(np.asarray(ld.vectors)[:ld.n_real],
                                          np.asarray(rd.vectors)[:rd.n_real])
            np.testing.assert_array_equal(np.asarray(ld.scale), np.asarray(rd.scale))


def _cascade_store(tmp_path, n=200):
    pruned, W, mean, Q = _fixture(n=n)
    cas = CascadeIndex.build(pruned, m_coarse=pruned.shape[1] // 2, n_factor=2,
                             quantize_int8=True, device="cpu")
    return save_index(str(tmp_path / "st"), cas), pruned


def _edit(path, fn):
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    fn(m)
    with open(mpath, "w") as f:
        json.dump(m, f)


def test_store_rejects_resolution_row_mismatch(tmp_path):
    store, pruned = _cascade_store(tmp_path)
    with pytest.raises(IndexStoreError, match="rows"):
        store.add_resolution(np.zeros((5, 3), np.float32))
    _edit(store.path, lambda m: m["resolutions"][0]["chunks"][0].update(
        rows=m["resolutions"][0]["chunks"][0]["rows"] - 1))
    with pytest.raises(IndexStoreError, match="shape|same corpus"):
        IndexStore.open(store.path)


def test_store_rejects_non_nested_resolution_m(tmp_path):
    store, pruned = _cascade_store(tmp_path)
    n, m = pruned.shape
    with pytest.raises(IndexStoreError, match="nest"):
        store.add_resolution(np.zeros((n, m), np.float32))
    _edit(store.path, lambda man: man["resolutions"][0].update(m=man["dim"] + 4))
    with pytest.raises(IndexStoreError, match="does not nest"):
        IndexStore.open(store.path)


def test_store_rejects_duplicate_resolution_m(tmp_path):
    store, pruned = _cascade_store(tmp_path)
    mc = int(store.manifest["resolutions"][0]["m"])
    with pytest.raises(IndexStoreError, match="already present"):
        store.add_resolution(np.asarray(pruned[:, :mc], np.float32))


def test_store_rejects_missing_resolution_blob(tmp_path):
    store, _ = _cascade_store(tmp_path)
    entry = store.manifest["resolutions"][0]
    os.remove(os.path.join(store.path, entry["chunks"][0]["file"]))
    with pytest.raises(IndexStoreError, match="missing chunk"):
        IndexStore.open(store.path)


def test_store_rejects_missing_resolution_scale(tmp_path):
    store, _ = _cascade_store(tmp_path)
    entry = store.manifest["resolutions"][0]
    assert entry["scale_file"] is not None   # an int8 coarse side has its scale
    os.remove(os.path.join(store.path, entry["scale_file"]))
    with pytest.raises(IndexStoreError, match="scale"):
        IndexStore.open(store.path)


def test_cascade_load_requires_matching_resolution(tmp_path):
    pruned, W, mean, Q = _fixture(n=150)
    plain = save_index(str(tmp_path / "plain"), DenseIndex.build(torch.from_numpy(pruned)))
    with pytest.raises(IndexStoreError, match="no coarse resolutions"):
        CascadeIndex.load(plain, device="cpu")
    store, _ = _cascade_store(tmp_path)
    with pytest.raises(IndexStoreError, match="no m="):
        CascadeIndex.load(store, m_coarse=3, device="cpu")


def test_cascade_store_persists_coarse_deltas_bit_parity(tmp_path):
    """A segmented cascade's coarse deltas persist as their exact bytes and
    scales, and a segmented load serves those bytes, with no
    requantisation from the full deltas."""
    k, n = 8, 300
    pruned, W, mean, Q = _fixture(n=n)
    cas = CascadeIndex.build(pruned, m_coarse=pruned.shape[1] // 2,
                             n_factor=_full_nf(n + 48, k), quantize_int8=True,
                             device="cpu").segmented(delta_capacity=64)
    for seed in (1, 2):
        cas = cas.append(_rows(24, pruned.shape[1], seed))
    store = save_index(str(tmp_path / "st"), cas)
    name = store.manifest["resolutions"][0]["name"]
    dviews = store.resolution_deltas(name)
    assert dviews, "a segmented save must persist the coarse delta segments"
    assert [v.n for v in dviews] == [d.n_real for d in cas.coarse.deltas]
    loaded = CascadeIndex.load(store, m_coarse=cas.m_coarse, n_factor=cas.n_factor,
                               segmented=True, delta_capacity=64, device="cpu")
    for mem, got in zip(cas.coarse.deltas, loaded.coarse.deltas):
        assert torch.equal(mem.vectors[:mem.n_real], got.vectors[:got.n_real])
        assert (mem.scale is None) == (got.scale is None)
        if mem.scale is not None:
            assert torch.equal(mem.scale, got.scale)
    want, got = _search(cas, W, mean, Q, k), _search(loaded, W, mean, Q, k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_store_rejects_misaligned_resolution_deltas(tmp_path):
    """Coarse delta rows must mirror the main delta segments one for one,
    or the two views would describe different docs."""
    pruned, W, mean, Q = _fixture(n=200)
    cas = CascadeIndex.build(pruned, m_coarse=pruned.shape[1] // 2, n_factor=2,
                             quantize_int8=True, device="cpu").segmented(delta_capacity=64)
    cas = cas.append(_rows(16, pruned.shape[1], 3))
    store = save_index(str(tmp_path / "full-only"), cas.full)
    mc = cas.m_coarse
    base = cas.coarse.base
    with pytest.raises(IndexStoreError, match="mirror"):
        store.add_resolution(base.vectors[:base.n], scale=base.scale, deltas=[
            {"rows": np.zeros((3, mc), np.int8), "scale": None, "capacity": 64}])
    with pytest.raises(IndexStoreError, match="no resolution"):
        store.resolution_deltas("m999")
