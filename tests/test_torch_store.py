"""The port's on-disk artifact store on the CPU against ``repro``'s.

A store written by either package opens, validates and loads in the other:
the manifests are equal as JSON objects, the blobs byte for byte, loaded
vectors bitwise, and searches agree under the parity contract (scores at
rtol = atol = 1e-5, ids up to near-ties). The streaming offline build is
held to the reference's bytes and ``meta`` exactly when the blocks are
already projected, and to ±1 on at most 0.1 % of int8 entries when the
projection runs inside. Tampered directories are refused by both packages
with the same message. Inputs are made with numpy from a seed, at 2,000 ×
64 and cutoff 0.5. Segmented, paged and updater stores are held in
``test_torch_segments.py``, ``test_torch_paged.py`` and
``test_torch_maintenance.py``.
"""
import json
import os
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    DenseIndex as JaxIndex,
    IndexStore as JaxStore,
    IndexStoreError as JaxStoreError,
    StaticPruner as JaxPruner,
    save_index as jax_save_index,
)
from repro.core.store import IndexStoreWriter as JaxWriter
from repro_torch import convert
from repro_torch.checkpoint.fsio import commit_dir
from repro_torch.core import IndexStore, IndexStoreError, save_index
from repro_torch.core.index import DenseIndex
from repro_torch.core.paged import PagedIndex
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.store import IndexStoreWriter
from repro_torch.data.synthetic import make_corpus
from test_torch_paged import _assert_close

N, D_IN = 2000, 64
RNG = np.random.default_rng(23)


def _corpus(n=N, d=D_IN, seed=3):
    D, _ = make_corpus("tasb", n_docs=n, d=d, seed=seed)
    return D


def _queries(d=D_IN, nq=6):
    return RNG.standard_normal((nq, d)).astype(np.float32)


def _carried(jp: JaxPruner) -> StaticPruner:
    """The port's pruner over the reference's fitted state."""
    s = jp.state
    tp = StaticPruner(cutoff=jp.cutoff, center=jp.center)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    return tp


def _build_both(P, kind):
    """The same pruned rows as a reference and a port ``DenseIndex``."""
    if kind == "int8":
        return (JaxIndex.build(jnp.asarray(P), quantize_int8=True),
                DenseIndex.build(torch.from_numpy(P), quantize_int8=True))
    if kind == "bf16":
        return (JaxIndex.build(jnp.asarray(P), dtype=jnp.bfloat16),
                DenseIndex.build(torch.from_numpy(P), dtype=torch.bfloat16))
    return JaxIndex.build(jnp.asarray(P)), DenseIndex.build(torch.from_numpy(P))


def _bits(x) -> np.ndarray:
    """Stored bytes of a vector array (bf16 by its bit pattern)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _blob_names(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".npy"))


def _assert_same_files(a, b):
    """Two store directories hold the same blobs, byte for byte, and PCA
    states with equal arrays."""
    assert _blob_names(a) == _blob_names(b)
    for f in _blob_names(a):
        np.testing.assert_array_equal(np.load(os.path.join(a, f)),
                                      np.load(os.path.join(b, f)), err_msg=f)
    if os.path.exists(os.path.join(a, "pca.npz")):
        za, zb = np.load(os.path.join(a, "pca.npz")), np.load(os.path.join(b, "pca.npz"))
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key])


@pytest.fixture(scope="module")
def fitted():
    D = _corpus()
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    return D, jp, _carried(jp), np.array(jp.prune_index(jnp.asarray(D)), np.float32)


# ---------------------------------------------------------------------------
# cross-package round trips of a pre-segment (dense) store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_dense_store_cross_package_round_trip(tmp_path, fitted, writer, kind):
    """Both packages write the same artifact from the same index; the one
    ``writer`` wrote loads in the other package to the same bytes and the
    same search results."""
    D, jp, tp, P = fitted
    ji, ti = _build_both(P, kind)
    np.testing.assert_array_equal(_bits(ti.vectors), _bits(ji.vectors))
    js = jax_save_index(str(tmp_path / "ref"), ji, pruner=jp, chunk_rows=700)
    ts = save_index(str(tmp_path / "port"), ti, pruner=tp, chunk_rows=700)
    assert ts.manifest == js.manifest
    assert json.load(open(tmp_path / "port" / "manifest.json")) == \
        json.load(open(tmp_path / "ref" / "manifest.json"))
    _assert_same_files(str(tmp_path / "ref"), str(tmp_path / "port"))

    Q = _queries()
    if writer == "repro":
        store = IndexStore.open(str(tmp_path / "ref"))
        assert store.dtype == ti.vectors.dtype and store.n == N
        loaded = DenseIndex.load(store, device="cpu")
        np.testing.assert_array_equal(_bits(loaded.vectors), _bits(ji.vectors))
        qh = store.load_pruner(device="cpu").transform_queries(torch.from_numpy(Q))
        want = ji.search(jp.transform_queries(jnp.asarray(Q)), k=10)
        got = loaded.search(qh, k=10)
    else:
        loaded = JaxIndex.load(JaxStore.open(str(tmp_path / "port")))
        np.testing.assert_array_equal(_bits(loaded.vectors), _bits(ti.vectors))
        qh = JaxStore.open(str(tmp_path / "port")).load_pruner().transform_queries(
            jnp.asarray(Q))
        want = loaded.search(qh, k=10)
        got = ti.search(tp.transform_queries(torch.from_numpy(Q)), k=10)
    _assert_close(want, got, f"{writer} {kind}")


def test_bf16_chunks_are_uint16_views(tmp_path, fitted):
    """bf16 has no .npy encoding: the chunks hold the uint16 bit pattern,
    the manifest the logical dtype, and reads give bf16 back."""
    _, _, _, P = fitted
    idx = DenseIndex.build(torch.from_numpy(P), dtype=torch.bfloat16)
    store = save_index(str(tmp_path / "st"), idx)
    assert store.manifest["dtype"] == "bfloat16" and store.dtype == torch.bfloat16
    raw = np.load(os.path.join(store.path, store.manifest["chunks"][0]["file"]))
    assert raw.dtype == np.uint16
    rows = store.read_rows(10, 20, device="cpu")
    assert rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(rows), _bits(idx.vectors[10:20]))


def test_multi_chunk_read_rows(tmp_path):
    """read_rows assembles across chunk boundaries."""
    writer = IndexStore.create(str(tmp_path / "st"))
    parts = [RNG.standard_normal((r, 8)).astype(np.float32) for r in (10, 7, 13)]
    for p in parts:
        writer.append(p)
    store = writer.commit()
    full = np.concatenate(parts)
    np.testing.assert_array_equal(store.read_rows(5, 25, device="cpu").numpy(), full[5:25])
    np.testing.assert_array_equal(store.read_rows(0, 30, device="cpu").numpy(), full)
    with pytest.raises(ValueError):
        store.read_rows(0, 31, device="cpu")


def test_reads_default_to_the_card(tmp_path):
    """Entry points run on the card unless asked otherwise: without a card
    a default read raises instead of falling back to the CPU."""
    store = save_index(str(tmp_path / "st"), DenseIndex.build(torch.ones(4, 8)))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only machine")
    for call in (lambda: store.read_rows(0, 4), lambda: DenseIndex.load(store)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_writer_rejects_mismatched_chunks(tmp_path):
    w = IndexStoreWriter(str(tmp_path / "st"))
    w.append(torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="chunk mismatch"):
        w.append(np.zeros((4, 9), np.float32))
    with pytest.raises(ValueError, match="chunk mismatch"):
        w.append(torch.zeros((4, 8), dtype=torch.int8))
    w.abort()
    assert not os.path.exists(str(tmp_path / "st.tmp"))


def test_store_replacement_at_same_path(tmp_path):
    """Re-committing to an existing path swaps via rename-aside: the new
    store wins and no .tmp/.old residue is left, even with a leftover .old
    from a crashed replacement."""
    path = str(tmp_path / "st")
    save_index(path, DenseIndex.build(torch.from_numpy(_corpus(300, 16))))
    os.makedirs(path + ".old", exist_ok=True)
    save_index(path, DenseIndex.build(torch.from_numpy(_corpus(421, 16))))
    assert IndexStore.open(path).n == 421
    assert not os.path.exists(path + ".tmp") and not os.path.exists(path + ".old")


def test_commit_dir_keeps_a_committed_artifact_on_disk(tmp_path, monkeypatch):
    """``commit_dir`` renames the old artifact aside before the new one
    moves in: a crash between the two renames leaves the old artifact at
    ``.old`` and the new one still complete at ``.tmp``, never neither."""
    path, tmp = str(tmp_path / "st"), str(tmp_path / "st.tmp")
    os.makedirs(path)
    open(os.path.join(path, "a"), "w").write("old")
    os.makedirs(tmp)
    open(os.path.join(tmp, "a"), "w").write("new")
    real = os.rename

    def crash_on_second(src, dst):
        if src == tmp:
            raise OSError("crash")
        real(src, dst)

    monkeypatch.setattr(os, "rename", crash_on_second)
    with pytest.raises(OSError, match="crash"):
        commit_dir(tmp, path)
    assert open(path + ".old/a").read() == "old" and open(tmp + "/a").read() == "new"
    monkeypatch.setattr(os, "rename", real)
    commit_dir(tmp, path)
    assert open(path + "/a").read() == "new"
    assert not os.path.exists(path + ".old") and not os.path.exists(tmp)


def test_append_migrating_widens_a_delta_scale(tmp_path, fitted):
    """Store-level scale migration: an append that would clip widens the
    segment scale and requantises its chunks, within half an old LSB of
    exact; the base is untouched. The same calls on a reference store
    write the same bytes."""
    _, jp, tp, P = fitted
    paths = {}
    for pkg, save, idx in (("repro", jax_save_index, JaxIndex.build(
            jnp.asarray(P), quantize_int8=True)),
            ("repro_torch", save_index, DenseIndex.build(torch.from_numpy(P),
                                                         quantize_int8=True))):
        st = save(str(tmp_path / pkg), idx)
        st.add_delta(scale=np.full((32,), 0.01, np.float32), capacity=4096)
        st.append_migrating(np.full((4, 32), 0.5, np.float32))       # fits
        assert st.append_migrating(np.full((3, 32), 7.0, np.float32))
        paths[pkg] = st.path
    _assert_same_files(paths["repro"], paths["repro_torch"])
    re = IndexStore.open(paths["repro_torch"])
    v = re.segments()[1]
    assert v.n == 7
    vals = v.read_rows(0, 7, device="cpu").float().numpy() * v.scale()[None, :]
    np.testing.assert_allclose(vals[:4], 0.5, atol=float(v.scale().max()))
    np.testing.assert_allclose(vals[4:], 7.0, atol=float(v.scale().max()) / 2)


def test_append_migrating_base_segment_keeps_scale_pointer(tmp_path, fitted):
    """Widening the BASE segment's scale keeps the top-level scale_file in
    sync with the base entry, so the store stays openable."""
    D, _, tp, P = fitted
    idx = DenseIndex.build(torch.from_numpy(P[:300]), quantize_int8=True)
    st = save_index(str(tmp_path / "st"), idx, pruner=tp)
    assert st.append_migrating(50.0 * P[:5])
    re = IndexStore.open(st.path)
    assert re.n == 305
    base = re.segments()[0]
    assert (base.scale() >= idx.scale.numpy()).all()
    np.testing.assert_array_equal(
        np.load(os.path.join(re.path, re.manifest["scale_file"])), base.scale())


# ---------------------------------------------------------------------------
# rejections: both packages refuse the same tampered directories
# ---------------------------------------------------------------------------


def _edit_manifest(path, fn):
    mpath = os.path.join(path, "manifest.json")
    m = json.load(open(mpath))
    fn(m)
    json.dump(m, open(mpath, "w"))


def _saved(path, paged=False):
    """A reference-written store: dense f32, or a grown paged int8 index."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((300, 16)).astype(np.float32)
    if not paged:
        return jax_save_index(path, JaxIndex.build(jnp.asarray(X)))
    from repro.core.paged import PagedIndex as JaxPaged
    pg = JaxPaged.from_index(JaxIndex.build(jnp.asarray(X), quantize_int8=True),
                             page_rows=32, seal_rows=96)
    pg = pg.append(rng.standard_normal((50, 16)).astype(np.float32))
    return jax_save_index(path, pg)


def _uncommitted(path):
    w = JaxWriter(path)
    w.append(np.zeros((4, 8), np.float32))          # no commit: the crash


def _missing_chunk(path):
    st = _saved(path)
    os.remove(os.path.join(path, st.manifest["chunks"][0]["file"]))


def _wrong_shape(path):
    st = _saved(path)
    np.save(os.path.join(path, st.manifest["chunks"][0]["file"]),
            np.zeros((7, 16), np.float32))


def _row_count(path):
    _saved(path)
    _edit_manifest(path, lambda m: m.update(n=9999))


def _version(path):
    _saved(path)
    _edit_manifest(path, lambda m: m.update(format_version=99))


def _truncated(path):
    st = _saved(path)
    f = os.path.join(path, st.manifest["chunks"][0]["file"])
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)


def _leading_paged(path):
    _saved(path, paged=True)

    def lead(m):
        m["paged"]["extents"][0]["n"] += 1
    _edit_manifest(path, lead)


def _non_nesting_resolution(path):
    _saved(path)
    _edit_manifest(path, lambda m: m.setdefault("resolutions", []).append(
        {"name": "m16", "m": 16, "dtype": "int8", "chunks": []}))


REJECTIONS = {
    "uncommitted_tmp": (_uncommitted, "not a committed"),
    "missing_chunk": (_missing_chunk, "missing chunk"),
    "wrong_shape": (_wrong_shape, "has shape"),
    "row_count_mismatch": (_row_count, "manifest n"),
    "unsupported_version": (_version, "format_version"),
    "truncated_chunk": (_truncated, "truncated"),
    "leading_paged_block": (_leading_paged, "claims"),
    "non_nesting_resolution": (_non_nesting_resolution, "does not nest"),
}
PACKAGES = {"repro": (JaxStore, JaxStoreError),
            "repro_torch": (IndexStore, IndexStoreError)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_tampered_store_rejected(tmp_path, case, pkg):
    tamper, pattern = REJECTIONS[case]
    path = str(tmp_path / "st")
    tamper(path)
    store_cls, err = PACKAGES[pkg]
    with pytest.raises(err, match=pattern):
        store_cls.open(path)


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_tampered_store_same_message_in_both_packages(tmp_path, case):
    tamper, _ = REJECTIONS[case]
    path = str(tmp_path / "st")
    tamper(path)
    msgs = []
    for store_cls, err in PACKAGES.values():
        with pytest.raises(err) as info:
            store_cls.open(path)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lagging_paged_block_accepted(tmp_path, pkg):
    """A paged block missing the newest extent is the append mirror's
    crash window (data committed, metadata not yet): both packages open
    it, and the port's load serves what the reference's does."""
    from repro.core.paged import PagedIndex as JaxPaged
    path = str(tmp_path / "st")
    _saved(path, paged=True)
    _edit_manifest(path, lambda m: m["paged"].update(extents=m["paged"]["extents"][:-1]))
    store_cls, _ = PACKAGES[pkg]
    store = store_cls.open(path)
    Q = np.random.default_rng(6).standard_normal((4, 16)).astype(np.float32)
    want = JaxPaged.load(JaxStore.open(path)).search(jnp.asarray(Q), 8)
    if pkg == "repro_torch":
        got = PagedIndex.load(store, device="cpu").search(torch.from_numpy(Q), 8)
    else:
        got = JaxPaged.load(store).search(jnp.asarray(Q), 8)
    _assert_close(want, got, pkg)


def test_append_crash_window_leaves_valid_store(tmp_path):
    """An orphan chunk blob without a manifest swap (a crash between the two
    append steps) does not invalidate the store."""
    st = save_index(str(tmp_path / "st"),
                    DenseIndex.build(torch.from_numpy(_corpus(300, 16))))
    np.save(os.path.join(st.path, "vectors_999999.npy"), np.zeros((5, 16), np.float32))
    assert IndexStore.open(st.path).n == 300


# ---------------------------------------------------------------------------
# the streaming offline build
# ---------------------------------------------------------------------------


def _batches(D, rows=250):
    D = np.asarray(D)

    def gen():
        for i in range(0, len(D), rows):
            yield D[i:i + rows]
    return gen


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streaming_build_matches_in_memory(tmp_path, quant):
    """The streaming build (fit over blocks, then project and write) gives
    the in-memory build's eigenvalues, and under its own fitted state the
    in-memory build's rows (int8 ±1 on at most 0.1 %, where a projection
    over a block and over the whole corpus straddle a rounding boundary)
    and answers."""
    D, Q = _corpus(), torch.from_numpy(_queries())
    st = StaticPruner(cutoff=0.5).build_index_to(
        str(tmp_path / "st"), _batches(D), quantize_int8=quant, device="cpu")
    assert st.n == D.shape[0] and st.meta["kept_dims"] == st.dim
    assert st.dtype == (torch.int8 if quant else torch.float32)
    fitted = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    state = st.load_pca(device="cpu")
    np.testing.assert_allclose(state.eigenvalues.numpy(), fitted.state.eigenvalues.numpy(),
                               rtol=1e-4, atol=1e-4 * float(state.eigenvalues[0]))
    mem = StaticPruner(cutoff=0.5)
    mem.state = state
    idx = mem.build_index(torch.from_numpy(D), quantize_int8=quant)
    loaded = DenseIndex.load(st, device="cpu")
    if quant:
        diff = (loaded.vectors.int() - idx.vectors.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    else:
        torch.testing.assert_close(loaded.vectors, idx.vectors, rtol=1e-5, atol=1e-5)
    qh = st.load_pruner(device="cpu").transform_queries(Q)
    _assert_close(idx.search(qh, k=10), loaded.search(qh, k=10), f"quant={quant}")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streaming_build_already_projected_equals_reference(tmp_path, fitted, quant):
    """Blocks already in the pruned space (the compaction path): the
    artifact's bytes and ``meta`` are the reference's exactly, int8 spill
    statistics included."""
    _, jp, tp, P = fitted
    blocks = [P[i:i + 300] for i in range(0, N, 300)]
    js = jp.build_index_to(str(tmp_path / "ref"), blocks, quantize_int8=quant,
                           already_projected=True, meta={"compactions": 1})
    ts = tp.build_index_to(str(tmp_path / "port"), blocks, quantize_int8=quant,
                           already_projected=True, meta={"compactions": 1})
    assert ts.manifest == js.manifest
    if quant:
        assert ts.meta["requant_blocks"] > 0 and ts.meta["spill_bytes"] == P.size
    _assert_same_files(str(tmp_path / "ref"), str(tmp_path / "port"))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streaming_build_projected_inside_matches_reference(tmp_path, fitted, quant):
    """With the projection inside the build (the reference's PCA state
    carried across): f32 rows within 1e-5, int8 bytes equal except ±1 on
    at most 0.1 % of entries where two projections straddle a rounding
    boundary, the scale within 1e-5."""
    D, jp, tp, _ = fitted
    blocks = [D[i:i + 300] for i in range(0, N, 300)]
    js = jp.build_index_to(str(tmp_path / "ref"), blocks, quantize_int8=quant)
    ts = tp.build_index_to(str(tmp_path / "port"), blocks, quantize_int8=quant)
    assert {k: v for k, v in ts.meta.items() if k != "requant_blocks"} == \
        {k: v for k, v in js.meta.items() if k != "requant_blocks"}
    got = ts.read_rows(0, N, device="cpu").numpy()
    want = np.concatenate([np.asarray(c) for c in js.iter_chunks()])
    if quant:
        np.testing.assert_allclose(ts.scale(), js.scale(), rtol=1e-5)
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_streaming_build_fit_inside_matches_reference(tmp_path):
    """An unfitted pruner fits inside the build (``fit_streaming``):
    components equal the reference's up to a per-column sign, and the
    int8 rows, signs aligned, agree within one step on ≤ 0.1 %."""
    from test_torch_pca import _assert_same_up_to_sign, _corpus as _spread
    D = _spread(n=N, d=D_IN, seed=4)
    blocks = [D[i:i + 400] for i in range(0, N, 400)]
    js = JaxPruner(cutoff=0.5).build_index_to(str(tmp_path / "ref"), blocks,
                                              quantize_int8=True)
    ts = StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "port"), blocks,
                                                 quantize_int8=True, device="cpu")
    m = ts.dim
    Wj = np.asarray(js.load_pca().components)[:, :m]
    Wt = ts.load_pca(device="cpu").components.numpy()[:, :m]
    _assert_same_up_to_sign(Wt, Wj, atol=1e-4)
    signs = np.sign(np.sum(Wt * Wj, axis=0)).astype(np.int32)
    got = ts.read_rows(0, N, device="cpu").numpy().astype(np.int32) * signs[None, :]
    want = np.concatenate([np.asarray(c) for c in js.iter_chunks()]).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_streaming_int8_build_two_corpus_passes(tmp_path):
    """When the scale stabilises in the first block the int8 build reads
    the corpus exactly twice (Gram fit, then project + write); an already
    fitted pruner reads it once, and both artifacts are identical."""
    D = _corpus(900, 48)
    blocks = [3.0 * D[:300], D[300:600], D[600:]]
    calls = {"n": 0}

    def gen():
        calls["n"] += 1
        yield from blocks

    st = StaticPruner(cutoff=0.5).build_index_to(
        str(tmp_path / "st"), gen, quantize_int8=True, device="cpu")
    assert calls["n"] == 2
    assert st.n == 900 and st.dtype == torch.int8
    assert st.meta["requant_blocks"] == 0
    pre = StaticPruner(cutoff=0.5)
    pre.fit_streaming(blocks, device="cpu")
    calls["n"] = 0
    st2 = pre.build_index_to(str(tmp_path / "st2"), gen, quantize_int8=True)
    assert calls["n"] == 1
    np.testing.assert_array_equal(st.scale(), st2.scale())
    assert torch.equal(st.read_rows(0, 900, device="cpu"),
                       st2.read_rows(0, 900, device="cpu"))


def test_streaming_int8_spill_is_int8_and_bit_identical(tmp_path):
    """The spill is int8, stale blocks are re-projected in one bounded
    re-read pass, and the artifact equals quantising exact f32 projections
    under the final corpus-wide scale, byte for byte."""
    from repro_torch.core import pca as _pca
    D = _corpus(900, 48)
    blocks = [D[i:i + 300] for i in range(0, 900, 300)]
    calls = {"n": 0}

    def gen():
        calls["n"] += 1
        yield from blocks

    st = StaticPruner(cutoff=0.5).build_index_to(
        str(tmp_path / "st"), gen, quantize_int8=True, device="cpu")
    assert calls["n"] <= 3
    m = st.meta["kept_dims"]
    assert st.meta["spill_dtype"] == "int8" and st.meta["spill_bytes"] == 900 * m
    assert 0 <= st.meta["requant_blocks"] <= len(blocks)
    pre = StaticPruner(cutoff=0.5)
    pre.fit_streaming(blocks, device="cpu")
    proj = np.concatenate([_pca.transform(torch.from_numpy(b), pre.state, m).numpy()
                           for b in blocks])
    scale = (np.maximum(np.abs(proj).max(axis=0), 1e-12) / 127.0).astype(np.float32)
    want = np.clip(np.round(proj / scale[None, :]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(st.scale(), scale)
    np.testing.assert_array_equal(st.read_rows(0, 900, device="cpu").numpy(), want)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_streaming_build_peak_memory_is_o_block(tmp_path, quant):
    """A 30,000 × 128 corpus (15 MiB f32) from 1,000-row blocks made on the
    fly: the host peak stays far below the corpus. tracemalloc sees numpy's
    allocations (the blocks, the spill and chunk arrays), not the tensors
    in between, so this bounds every host array the build keeps."""
    n, d, rows = 30000, 128, 1000

    def gen():
        rng = np.random.default_rng(0)    # fresh per pass: identical blocks
        for _ in range(n // rows):
            yield rng.standard_normal((rows, d)).astype(np.float32)

    tracemalloc.start()
    tracemalloc.reset_peak()
    st = StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "st"), gen,
                                                 quantize_int8=quant, device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert st.n == n
    assert peak < n * d * 4 / 4, f"peak host memory {peak} bytes is not O(block)"


def test_streaming_build_rejects_one_shot_generator(tmp_path):
    D = _corpus(400, 16)
    with pytest.raises(TypeError, match="multiple passes"):
        StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "st"),
                                                iter([D[:200], D[200:]]))


def test_streaming_build_spills_next_to_the_target(tmp_path, monkeypatch):
    """The int8 spill lives beside the target directory, never in the
    system temp dir (often RAM-backed), and is gone after the build."""
    import tempfile
    seen = []
    real = tempfile.mkdtemp

    def spy(*a, **kw):
        seen.append(kw.get("dir"))
        return real(*a, **kw)

    monkeypatch.setattr(tempfile, "mkdtemp", spy)
    os.makedirs(tmp_path / "out")
    StaticPruner(cutoff=0.5).build_index_to(str(tmp_path / "out" / "st"),
                                            _batches(_corpus(600, 32), 200),
                                            quantize_int8=True, device="cpu")
    assert seen == [str(tmp_path / "out")]
    assert sorted(os.listdir(tmp_path / "out")) == ["st"]
