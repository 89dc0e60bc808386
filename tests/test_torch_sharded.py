"""The port's sharded index on the CPU against ``repro``'s.

The same numpy inputs, made from a seed, go to ``repro`` (its meshes over
the 4 host devices ``tests/conftest.py`` forces) and to ``repro_torch`` (a
``DeviceMesh`` of the same shape whose slots all sit on the CPU), on 1-, 4-
and 2x2-slot meshes. Mirrored: every case of ``tests/test_sharded_parity.py``,
the sharded cases of ``tests/test_store.py``, the three of
``tests/test_multihost_load.py`` and the sharded base of
``tests/test_segments.py``; then the updater's sharded ``from_store``,
``compact`` and ``refit``, and the serve CLI's ``--sharded``,
``--host-devices`` and ``--merge``.

Bars (ROADMAP's parity contract): scores within rtol = atol = 1e-5, ids
equal up to near-ties, int8 bytes and stores exact; a PCA fit by its
eigenvalues (1e-4 of the largest) and its kept subspace (projector within
1e-4), or, where the reference's own test does, its top components up to
sign. Within the port, flat and hierarchical merges are bitwise equal by
construction; sharded = dense bitwise is a property of the card's fixed sum
order and is held there (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    DenseIndex as JaxDense,
    IndexStore as JaxStore,
    SegmentedIndex as JaxSegmented,
    ShardedDenseIndex as JaxSharded,
    StaticPruner as JaxPruner,
    fit_pca_distributed as jax_fit_pca_distributed,
    save_index as jax_save_index,
)
from repro.core.index import DeltaSegment as JaxDelta
from repro.core.index import _addressable_shard_ranges as jax_shard_ranges
from repro.core.maintenance import IndexUpdater as JaxUpdater
from repro.core.pca import gram_distributed as jax_gram_distributed
from repro.core.quantization import quantize_int8_per_dim as jax_quantize
from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
from repro_torch import convert
from repro_torch.core import IndexStore, IndexUpdater, SegmentedIndex, save_index
from repro_torch.core.index import (
    DeltaSegment,
    DenseIndex,
    ShardedDenseIndex,
    _addressable_shard_ranges,
    _staged_topk_merge,
    _topk_merge,
)
from repro_torch.core.pca import fit_pca, fit_pca_distributed, gram, gram_distributed
from repro_torch.core.pruning import StaticPruner
from repro_torch.core.quantization import quantize_int8_per_dim
from repro_torch.data.synthetic import ENCODER_PROFILES, _normalize, _orthonormal, make_corpus
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.par.mesh import axis_index, make_mesh
from test_torch_paged import TOL, _assert_close, _assert_ids_equal_up_to_near_ties
from test_torch_store import _assert_same_files

MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)), "2x2": ((2, 2), ("row", "col"))}


def _meshes(name):
    """The reference's mesh over the host devices and the port's over the
    CPU, of the same shape."""
    shape, names = MESHES[name]
    if jax.device_count() < int(np.prod(shape)):
        pytest.skip(f"needs {np.prod(shape)} devices, have {jax.device_count()}")
    return jax.make_mesh(shape, names), make_mesh(shape, names, "cpu")


def _rng(*key):
    """A generator of its own for each use, so a test's data does not
    depend on which tests ran before it."""
    return np.random.default_rng([42, *key])


def _data(n, d, nq=6):
    rng = _rng(n, d, nq)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _corpus(n=1003, d=32, seed=3):
    D, _ = make_corpus("tasb", n_docs=n, d=d, seed=seed)
    return D


def _build(D, jmesh, tmesh, **kw):
    """The same rows sharded by both packages."""
    return (JaxSharded.build(jnp.asarray(D), jmesh, **kw),
            ShardedDenseIndex.build(torch.from_numpy(D), tmesh, **kw))


def _np(res):
    return tuple(np.asarray(x) for x in res)


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _carried(jp: JaxPruner) -> StaticPruner:
    """The port's pruner over the reference's fitted state."""
    s = jp.state
    tp = StaticPruner(cutoff=jp.cutoff, center=jp.center)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    return tp


def _stored_rows(idx: ShardedDenseIndex) -> np.ndarray:
    return torch.cat(idx.shards).numpy()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_mesh_slots_and_axis_index():
    """Slots in row-major order, a device repeated round-robin; axis_index
    is the flat row-major slot index."""
    mesh = make_mesh((2, 3), ("row", "col"), ["cpu", "cpu"])
    assert mesh.shape == (2, 3) and mesh.size == 6 and mesh.axis_names == ("row", "col")
    assert mesh.device_list == [torch.device("cpu")] * 6 and mesh.device == torch.device("cpu")
    for pos in np.ndindex(2, 3):
        assert axis_index(mesh, pos) == pos[0] * 3 + pos[1]
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), "cpu")
    with pytest.raises(ValueError):
        make_mesh((0,), ("data",), "cpu")


def test_make_mesh_defaults_to_the_cards():
    """With no devices a mesh goes over the visible cards, and raises
    without one instead of quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="'cuda'"):
        make_mesh((4,), ("data",))


def test_make_host_mesh_matches_reference():
    """The reference's (data, model) factoring of the host devices."""
    for model in (None, 1, 4):
        tm = make_host_mesh(model, n=jax.device_count(), device="cpu")
        jm = jax_make_host_mesh(model)
        assert tm.shape == tuple(jm.devices.shape)
        assert tm.axis_names == tuple(jm.axis_names)
    assert make_host_mesh(device="cpu").shape == (1, 1)


# ---------------------------------------------------------------------------
# search parity (tests/test_sharded_parity.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_sharded_search_matches_reference_and_dense(mesh):
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(2048, 32)
    jidx, tidx = _build(D, jmesh, tmesh)
    got = tidx.search(torch.from_numpy(Q), k=10)
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10)), _np(got))
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D)).search(torch.from_numpy(Q), k=10)),
                  _np(got))
    assert _same(got, tidx.search(torch.from_numpy(Q), k=10, merge="hierarchical"))
    assert tidx.n == 2048 and tidx.dim == 32 and tidx.merge == "flat"


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_sharded_search_uneven_rows(mesh):
    """1003 % 4 != 0 with every real score negative: the reference's pad
    rows score 0 and must never surface; the port stores none."""
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(1003, 16)
    D, Q = np.abs(D), -np.abs(Q)
    jidx, tidx = _build(D, jmesh, tmesh)
    assert tidx.n == 1003
    assert [t.shape[0] for t in tidx.shards] == (
        [1003] if mesh == "1" else [251, 251, 251, 250])
    s, ids = tidx.search(torch.from_numpy(Q), k=10)
    assert int(ids.max()) < 1003 and float(s.max()) < 0.0
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10)), _np((s, ids)))


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_sharded_search_int8_matches_reference(mesh):
    """The int8 bytes and scale exactly the reference's real rows; the
    search within the contract."""
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(1000, 32)
    jidx, tidx = _build(D, jmesh, tmesh, quantize_int8=True)
    assert tidx.dtype == torch.int8
    np.testing.assert_array_equal(_stored_rows(tidx), np.asarray(jidx.vectors)[:1000])
    np.testing.assert_array_equal(tidx.scale.numpy(), np.asarray(jidx.scale))
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10)),
                  _np(tidx.search(torch.from_numpy(Q), k=10)))
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D), quantize_int8=True)
                      .search(torch.from_numpy(Q), k=10)),
                  _np(tidx.search(torch.from_numpy(Q), k=10)))


def test_sharded_search_int8_uneven_rows_4dev():
    jmesh, tmesh = _meshes("4")
    D, Q = _data(1001, 16)
    D, Q = np.abs(D), -np.abs(Q)
    jidx, tidx = _build(D, jmesh, tmesh, quantize_int8=True)
    s, ids = tidx.search(torch.from_numpy(Q), k=7)
    assert int(ids.max()) < 1001 and float(s.max()) < 0.0
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=7)), _np((s, ids)))


@pytest.mark.parametrize("mesh", ["1", "4"])
def test_sharded_hierarchical_matches_flat_1d(mesh):
    """On a one-axis mesh the hierarchical merge is the flat single stage:
    bitwise equal, and the reference's."""
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(2048, 32)
    jidx, tidx = _build(D, jmesh, tmesh)
    flat = tidx.search(torch.from_numpy(Q), k=10, merge="flat")
    hier = tidx.search(torch.from_numpy(Q), k=10, merge="hierarchical")
    assert _same(flat, hier)
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10, merge="hierarchical")), _np(hier))


def test_sharded_hierarchical_matches_flat_2d_mesh():
    """2x2: two merge stages (within 'col', then across 'row'), bitwise the
    flat merge with a row duplicated across shards, so both tie-break the
    same way; ids the reference's and the dense index's."""
    jmesh, tmesh = _meshes("2x2")
    D, Q = _data(1003, 16)
    D[900] = D[5]
    jidx, tidx = _build(D, jmesh, tmesh, merge="hierarchical")
    hier = tidx.search(torch.from_numpy(Q), k=10)            # the build's default
    flat = tidx.search(torch.from_numpy(Q), k=10, merge="flat")
    assert _same(flat, hier)
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10)), _np(hier))
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D)).search(torch.from_numpy(Q), k=10)),
                  _np(hier))
    # the duplicate ties: row 5 (the lower id) comes first wherever both rank
    ids = hier[1].numpy()
    for row in ids:
        if 5 in row and 900 in row:
            assert list(row).index(5) < list(row).index(900)


def test_sharded_hierarchical_int8_2d_mesh():
    jmesh, tmesh = _meshes("2x2")
    D, Q = _data(1001, 16)
    D, Q = np.abs(D), -np.abs(Q)
    jidx, tidx = _build(D, jmesh, tmesh, quantize_int8=True, merge="hierarchical")
    s, ids = tidx.search(torch.from_numpy(Q), k=7)
    assert int(ids.max()) < 1001 and float(s.max()) < 0.0
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=7)), _np((s, ids)))
    assert _same((s, ids), tidx.search(torch.from_numpy(Q), k=7, merge="flat"))


@pytest.mark.parametrize("merge", ["flat", "hierarchical"])
@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_sharded_pad_rows_cannot_displace_real_candidates(mesh, merge):
    """The global top-k concentrated in the last, padded shard, every real
    score below the 0.0 a pad row would score: the reference over-fetches
    k + pad; the port's last shard simply holds fewer rows."""
    jmesh, tmesh = _meshes(mesh)
    n, k = 29, 4
    D = np.abs(_rng(1).standard_normal((n, 8))).astype(np.float32)
    D[-k:] *= 0.01
    Q = -np.abs(_rng(2).standard_normal((3, 8))).astype(np.float32)
    jidx, tidx = _build(D, jmesh, tmesh)
    assert [t.shape[0] for t in tidx.shards] == [8, 8, 8, 5]
    got = tidx.search(torch.from_numpy(Q), k=k, merge=merge)
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=k, merge=merge)), _np(got))
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D)).search(torch.from_numpy(Q), k=k)),
                  _np(got))


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_sharded_k_exceeds_shard_rows(mesh):
    """k above any shard's rows: each shard pads with (-inf, -1) and the
    merge still gives the dense answer; k above n clamps to n."""
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(20, 8)                    # 5 rows a shard < k = 10
    jidx, tidx = _build(D, jmesh, tmesh)
    for merge in ("flat", "hierarchical"):
        got = tidx.search(torch.from_numpy(Q), k=10, merge=merge)
        _assert_close(_np(jidx.search(jnp.asarray(Q), k=10, merge=merge)), _np(got))
        over = tidx.search(torch.from_numpy(Q), k=25, merge=merge)
        assert over[1].shape == (6, 20) and int(over[1].min()) >= 0
        _assert_close(_np(jidx.search(jnp.asarray(Q), k=25, merge=merge)), _np(over))


def test_sharded_shard_entirely_padding(monkeypatch):
    """n = 5 over 4 slots: the last slot is all padding. It holds no row,
    launches no search, and the merge still gives the dense answer."""
    import repro_torch.core.index as index_mod
    jmesh, tmesh = _meshes("4")
    D, Q = _data(5, 8, nq=3)
    jidx, tidx = _build(D, jmesh, tmesh)
    assert [t.shape[0] for t in tidx.shards] == [2, 2, 1, 0]
    calls = []
    scan = index_mod._scan_topk
    monkeypatch.setattr(index_mod, "_scan_topk",
                        lambda Dl, q, k, **kw: calls.append(Dl.shape[0]) or scan(Dl, q, k, **kw))
    got = tidx.search(torch.from_numpy(Q), k=3)
    assert calls == [2, 2, 1]
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=3)), _np(got))
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D)).search(torch.from_numpy(Q), k=3)),
                  _np(got))


def test_shards_are_views_of_the_input():
    """A shard on the input's device is a row view of it, not a copy, and
    the index holds the dense index's bytes (no padding)."""
    _, tmesh = _meshes("4")
    D, _ = _data(1003, 16)
    t = torch.from_numpy(D)
    idx = ShardedDenseIndex.build(t, tmesh)
    per = idx.rows_per
    for i, shard in enumerate(idx.shards):
        assert shard.data_ptr() == t.data_ptr() + i * per * 16 * 4
    assert idx.nbytes == DenseIndex.build(t).nbytes
    assert torch.equal(idx.rows(240, 260), t[240:260])       # across two shards
    assert idx.rows(10, 20).data_ptr() == t[10:20].data_ptr()


def test_staged_merge_ids_identical_under_ties():
    """Every candidate tied within a few values: each staging from the minor
    axes to the major ones (the reference's order) of a 2x3 and a 2x2x2 mesh
    keeps the flat merge's scores and ids exactly."""
    g = torch.Generator().manual_seed(0)
    for shape in ((2, 3), (2, 2, 2)):
        B, k = 5, 7
        s = torch.randint(0, 4, (*shape, B, k), generator=g).float()
        s = torch.sort(s, dim=-1, descending=True).values
        ids = torch.arange(int(np.prod(shape)) * k, dtype=torch.int32).reshape(*shape, 1, k)
        ids = ids.expand(*shape, B, k).contiguous()
        axes = tuple(range(len(shape)))
        flat = _staged_topk_merge(s, ids, k, (axes,))
        want = _topk_merge(s.movedim(-2, 0).reshape(B, -1),
                           ids.movedim(-2, 0).reshape(B, -1), k)
        assert _same(flat, want)
        for stages in (((axes[-1],), axes[:-1]), (axes[1:], (0,)),
                       tuple((a,) for a in reversed(axes))):
            assert _same(_staged_topk_merge(s, ids, k, stages), flat), stages


# ---------------------------------------------------------------------------
# the distributed fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_gram_distributed_matches_gram_and_reference(mesh):
    """One strip Gram per slot, summed in slot order: within 1e-5 of max |G|
    of the single Gram and of the reference's psum (uneven rows, so the
    last strip is short)."""
    jmesh, tmesh = _meshes(mesh)
    D, _ = _data(1003, 24)
    G = gram_distributed(torch.from_numpy(D), tmesh)
    scale = float(G.abs().max())
    np.testing.assert_allclose(G.numpy(), gram(torch.from_numpy(D)).numpy(),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(G.numpy(), np.asarray(jax_gram_distributed(jnp.asarray(D), jmesh)),
                               rtol=0, atol=1e-5 * scale)
    # n = 5 over 4 slots: the padded strip adds nothing
    small = torch.from_numpy(D[:5])
    np.testing.assert_allclose(gram_distributed(small, tmesh).numpy(), gram(small).numpy(),
                               rtol=0, atol=1e-5 * float(gram(small).abs().max()))


def _assert_same_fit(ts, js, m, tol=1e-4):
    """Eigenvalues within ``tol`` of the largest, the kept m-dim subspace's
    projector within ``tol``, and the top 8 well-separated components up to
    sign (the reference's own bar)."""
    lam = np.asarray(js.eigenvalues)
    np.testing.assert_allclose(ts.eigenvalues.numpy(), lam, rtol=0, atol=tol * lam[0])
    Wt, Wj = ts.components.numpy()[:, :m], np.asarray(js.components)[:, :m]
    np.testing.assert_allclose(Wt @ Wt.T, Wj @ Wj.T, rtol=0, atol=tol)
    dots = np.abs(np.sum(ts.components.numpy()[:, :8] * np.asarray(js.components)[:, :8], 0))
    assert (dots > 0.99).all()


@pytest.mark.parametrize("mesh", ["1", "4", "2x2"])
def test_fit_pca_distributed_matches_serial_and_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    D = _corpus(1003, 24)
    ts = fit_pca_distributed(torch.from_numpy(D), tmesh)
    assert ts.n_samples == 1003
    _assert_same_fit(ts, jax_fit_pca_distributed(jnp.asarray(D), jmesh), 12)
    serial = fit_pca(torch.from_numpy(D))
    np.testing.assert_allclose(ts.eigenvalues.numpy(), serial.eigenvalues.numpy(),
                               rtol=0, atol=1e-4 * float(serial.eigenvalues[0]))
    centered = fit_pca_distributed(torch.from_numpy(D), tmesh, center=True)
    _assert_same_fit(centered, jax_fit_pca_distributed(jnp.asarray(D), jmesh, center=True), 12)
    np.testing.assert_allclose(centered.mean.numpy(), D.mean(0), rtol=0, atol=1e-5)


def _tasb_corpus(n, d, seed):
    """``make_corpus("tasb")``'s draw (its spectrum, basis and noise floor)
    from a generator keyed on ``seed`` alone. ``make_corpus`` keys its
    generator on ``hash("tasb")``, which moves with the interpreter's hash
    seed, so each test process drew another corpus; on a few of them the
    eigengap at the cut leaves the reference's f32 fit more than 1e-5 off."""
    prof = ENCODER_PROFILES["tasb"]
    rng = np.random.default_rng([seed, n, d])
    lam = np.arange(1, d + 1, dtype=np.float64) ** (-prof["alpha"])
    lam /= lam.sum()
    F = _orthonormal(d, d, rng)
    Z = rng.standard_normal((n, d)) * np.sqrt(lam)[None, :]
    noise = prof["sigma"] * rng.standard_normal((n, d)) / np.sqrt(d)
    return _normalize(Z @ F.T + noise).astype(np.float32)


def test_static_pruner_fit_distributed_end_to_end():
    """The paper's pipeline on a 4-slot mesh: distributed fit, sharded
    pruned index, search; the same kept dims and ids as the reference's
    pipeline and the port's serial one, and scores no further from the
    float64 pipeline's than the reference's are."""
    jmesh, tmesh = _meshes("4")
    D, Q = _tasb_corpus(1200, 32, 3), _data(1, 32)[1]
    tp = StaticPruner(cutoff=0.5).fit_distributed(torch.from_numpy(D), tmesh)
    jp = JaxPruner(cutoff=0.5).fit_distributed(jnp.asarray(D), jmesh)
    serial = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    assert tp.kept_dims == jp.kept_dims == serial.kept_dims
    tidx = tp.build_index(torch.from_numpy(D), mesh=tmesh)
    assert isinstance(tidx, ShardedDenseIndex) and tidx.mesh is tmesh
    got = tidx.search(tp.transform_queries(torch.from_numpy(Q)), k=10)
    jidx = jp.build_index(jnp.asarray(D), mesh=jmesh)
    jgot = _np(jidx.search(jp.transform_queries(jnp.asarray(Q)), k=10))
    _assert_close(jgot, _np(got))
    lam, V = np.linalg.eigh(D.astype(np.float64).T @ D.astype(np.float64))
    Vm = V[:, np.argsort(lam)[::-1][:tp.kept_dims]]
    s64 = (Q.astype(np.float64) @ Vm) @ (D.astype(np.float64) @ Vm).T
    err = {name: float(np.abs(r[0] - np.take_along_axis(s64, r[1], 1)).max())
           for name, r in (("port", _np(got)), ("ref", jgot))}
    assert err["port"] <= max(err["ref"], TOL["atol"]), err
    want = serial.build_index(torch.from_numpy(D)).search(
        serial.transform_queries(torch.from_numpy(Q)), k=10)
    _assert_close(_np(want), _np(got))
    q8 = tp.build_index(torch.from_numpy(D), mesh=tmesh, quantize_int8=True)
    assert q8.dtype == torch.int8 and q8.scale is not None


# ---------------------------------------------------------------------------
# search_projected: the fused path equals the two-step one
# ---------------------------------------------------------------------------


def _fused_vs_two_step(idx, pruner, Q, k=10):
    """Bitwise within the port (the same operations, in the same order), as
    the reference's own test holds its fused path."""
    W, mean = pruner.projection()
    two = idx.search(pruner.transform_queries(Q), k=k)
    fused = idx.search_projected(Q, W, k=k, mean=mean)
    assert _same(two, fused)
    return fused


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mesh", ["1", "4"])
def test_search_projected_matches_two_step_sharded(mesh, dtype):
    """1003 % 4 != 0; the reference's pruner carried over, the port's
    fused search held to the reference's."""
    jmesh, tmesh = _meshes(mesh)
    D, Q = _data(1003, 32)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    if dtype == "int8":
        jidx = JaxSharded.build(jnp.asarray(Dh), jmesh, quantize_int8=True)
        tidx = ShardedDenseIndex.build(torch.from_numpy(Dh), tmesh, quantize_int8=True)
    else:
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                    else (jnp.float32, torch.float32))
        jidx = JaxSharded.build(jnp.asarray(Dh).astype(jdt), jmesh)
        tidx = ShardedDenseIndex.build(torch.from_numpy(Dh).to(tdt), tmesh)
    got = _fused_vs_two_step(tidx, tp, torch.from_numpy(Q))
    W, mean = jp.projection()
    _assert_close(_np(jidx.search_projected(jnp.asarray(Q), W, k=10, mean=mean)), _np(got))


def test_search_projected_centered_pruner_sharded():
    jmesh, tmesh = _meshes("4")
    D, Q = _data(900, 24)
    jp = JaxPruner(cutoff=0.5, center=True).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    got = _fused_vs_two_step(ShardedDenseIndex.build(torch.from_numpy(Dh), tmesh), tp,
                             torch.from_numpy(Q))
    _fused_vs_two_step(DenseIndex.build(torch.from_numpy(Dh)), tp, torch.from_numpy(Q))
    W, mean = jp.projection()
    _assert_close(_np(JaxSharded.build(jnp.asarray(Dh), jmesh).search_projected(
        jnp.asarray(Q), W, k=10, mean=mean)), _np(got))


def test_search_projected_hierarchical_2d_mesh_int8():
    jmesh, tmesh = _meshes("2x2")
    D, Q = _data(1001, 16)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    jidx, tidx = _build(Dh, jmesh, tmesh, quantize_int8=True, merge="hierarchical")
    got = _fused_vs_two_step(tidx, tp, torch.from_numpy(Q), k=7)
    W, mean = jp.projection()
    _assert_close(_np(jidx.search_projected(jnp.asarray(Q), W, k=7, mean=mean)), _np(got))


def test_sharded_index_from_numpy_drops_the_reference_padding():
    """The reference's padded vectors come across as the real rows only,
    byte for byte, and search as the reference does."""
    jmesh, tmesh = _meshes("2x2")
    D, Q = _data(1003, 16)
    jidx = JaxSharded.build(jnp.asarray(D), jmesh, quantize_int8=True, merge="hierarchical")
    assert np.asarray(jidx.vectors).shape[0] == 1004
    tidx = convert.sharded_index_from_numpy(np.asarray(jidx.vectors), np.asarray(jidx.scale),
                                            tmesh, n_real=jidx.n, merge="hierarchical")
    assert tidx.n == 1003 and tidx.merge == "hierarchical"
    np.testing.assert_array_equal(_stored_rows(tidx), np.asarray(jidx.vectors)[:1003])
    _assert_close(_np(jidx.search(jnp.asarray(Q), k=10)),
                  _np(tidx.search(torch.from_numpy(Q), k=10)))


def test_sharded_index_rejects_a_bad_layout():
    _, tmesh = _meshes("4")
    t = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="shards for a mesh"):
        ShardedDenseIndex(shards=(t,), mesh=tmesh)
    with pytest.raises(ValueError, match="shard 1"):
        ShardedDenseIndex(shards=(t[:3], t[:2], t[:3], t[:2]), mesh=tmesh)
    with pytest.raises(ValueError, match="merge"):
        ShardedDenseIndex.build(t, tmesh, merge="tree")


# ---------------------------------------------------------------------------
# the store (tests/test_store.py) and the multi-host load
# (tests/test_multihost_load.py)
# ---------------------------------------------------------------------------


def _saved(tmp_path, writer, quantize, n=1003, d=32):
    """A store of n pruned rows written by ``writer``'s package, with the
    reference's fit carried into the port."""
    D = _corpus(n, d)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    path = str(tmp_path / f"st_{writer}")
    if writer == "jax":
        jax_save_index(path, jp.build_index(jnp.asarray(D), quantize_int8=quantize), pruner=jp)
    else:
        save_index(path, tp.build_index(torch.from_numpy(D), quantize_int8=quantize), pruner=tp)
    return path, jp, tp


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", ["1", "4"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_load_matches_dense_uneven_rows(tmp_path, writer, mesh, quantize):
    """1003 % 4 != 0: a store written by either package loads over the
    mesh with no padding surfacing, holding the store's bytes, searching
    as the reference's sharded load and the port's dense load."""
    jmesh, tmesh = _meshes(mesh)
    path, jp, tp = _saved(tmp_path, writer, quantize)
    sidx = ShardedDenseIndex.load(path, tmesh)
    assert sidx.n == IndexStore.open(path).n == 1003
    np.testing.assert_array_equal(
        _stored_rows(sidx), np.concatenate([np.asarray(c) for c in JaxStore.open(path)
                                            .iter_chunks()]))
    Q = _rng(3).standard_normal((6, 32)).astype(np.float32)
    qh = tp.transform_queries(torch.from_numpy(Q))
    got = sidx.search(qh, k=10)
    assert int(got[1].max()) < 1003
    jl = JaxSharded.load(path, jmesh)
    _assert_close(_np(jl.search(jp.transform_queries(jnp.asarray(Q)), k=10)), _np(got))
    _assert_close(_np(DenseIndex.load(path, device="cpu").search(qh, k=10)), _np(got))


def test_sharded_load_shard_entirely_padding(tmp_path):
    """n = 5 over 4 slots: the all-padding slot loads as an empty shard,
    reading nothing, and the search matches the dense oracle."""
    jmesh, tmesh = _meshes("4")
    D, Q = _data(5, 8, nq=3)
    save_index(str(tmp_path / "st"), DenseIndex.build(torch.from_numpy(D)))
    sidx = ShardedDenseIndex.load(str(tmp_path / "st"), tmesh)
    assert sidx.n == 5 and [t.shape[0] for t in sidx.shards] == [2, 2, 1, 0]
    got = sidx.search(torch.from_numpy(Q), k=3)
    _assert_close(_np(DenseIndex.build(torch.from_numpy(D)).search(torch.from_numpy(Q), k=3)),
                  _np(got))
    jl = JaxSharded.load(str(tmp_path / "st"), jmesh)
    _assert_close(_np(jl.search(jnp.asarray(Q), k=3)), _np(got))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_sharded_save_is_the_dense_save(tmp_path, quantize):
    """A sharded save writes the real rows only, in the dense save's chunks,
    byte for byte (also across a shard boundary inside a chunk): the port's
    dense save and the reference's of the same rows. (The reference's
    sharded save writes its dense save's bytes, ``repro/core/store.py``;
    on this JAX its row slicing of a sharded array raises, a version drift
    of the reference, so its dense save stands in.)"""
    jmesh, tmesh = _meshes("4")
    D = _corpus(1003, 32)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    sidx = ShardedDenseIndex.build(torch.from_numpy(Dh), tmesh, quantize_int8=quantize)
    dense = DenseIndex.build(torch.from_numpy(Dh), quantize_int8=quantize)
    a, b, c = (str(tmp_path / x) for x in ("sharded", "dense", "jax"))
    save_index(a, sidx, pruner=tp, chunk_rows=300)
    save_index(b, dense, pruner=tp, chunk_rows=300)
    jax_save_index(c, JaxDense.build(jnp.asarray(Dh), quantize_int8=quantize),
                   pruner=jp, chunk_rows=300)
    _assert_same_files(a, b)
    _assert_same_files(a, c)
    assert IndexStore.open(a).n == JaxStore.open(c).n == 1003


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_sharded_store_crosses_packages(tmp_path, direction):
    """A sharded index's store crosses to the other package, loads sharded
    there and answers as the index it was saved from. (The reference's side
    is written by its dense save of the same rows, the bytes its sharded
    save writes; see ``test_sharded_save_is_the_dense_save``.)"""
    jmesh, tmesh = _meshes("2x2")
    D = _corpus(1003, 32)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    Q = _rng(4).standard_normal((5, 32)).astype(np.float32)
    path = str(tmp_path / "st")
    if direction == "jax_to_torch":
        src = JaxSharded.build(jnp.asarray(Dh), jmesh, quantize_int8=True)
        jax_save_index(path, JaxDense.build(jnp.asarray(Dh), quantize_int8=True), pruner=jp)
        want = _np(src.search(jp.transform_queries(jnp.asarray(Q)), k=10))
        store = IndexStore.open(path)
        got = ShardedDenseIndex.load(store, tmesh).search(
            store.load_pruner(device="cpu").transform_queries(torch.from_numpy(Q)), k=10)
    else:
        src = ShardedDenseIndex.build(torch.from_numpy(Dh), tmesh, quantize_int8=True)
        save_index(path, src, pruner=tp)
        want = _np(src.search(tp.transform_queries(torch.from_numpy(Q)), k=10))
        store = JaxStore.open(path)
        got = JaxSharded.load(store, jmesh).search(
            store.load_pruner().transform_queries(jnp.asarray(Q)), k=10)
    _assert_close(want, _np(got))


def test_updater_append_sharded_reload(tmp_path):
    """Append through the dense updater, reload the grown artifact sharded."""
    _, tmesh = _meshes("4")
    D = _corpus(801, 32)
    up = IndexUpdater.build(torch.from_numpy(D), cutoff=0.5, store_path=str(tmp_path / "st"))
    up.add_documents(torch.from_numpy(_corpus(900, 32)[801:850]))
    sidx = ShardedDenseIndex.load(str(tmp_path / "st"), tmesh)
    assert sidx.n == 850
    qh = up.pruner.transform_queries(torch.from_numpy(_rng(5).standard_normal((6, 32))
                                                      .astype(np.float32)))
    _assert_close(_np(up.index.search(qh, k=10)), _np(sidx.search(qh, k=10)))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_served_topk_identical_after_reload_sharded(tmp_path, quantize):
    """serve.py's restart path: build + save, then serve the artifact
    sharded through the same RetrievalServer: the ids of the server over
    the built index, scores within the contract."""
    _, tmesh = _meshes("4")
    D = _corpus(1003, 32)
    Q = _rng(6).standard_normal((8, 32)).astype(np.float32)
    tp = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    idx = tp.build_index(torch.from_numpy(D), quantize_int8=quantize)
    store = save_index(str(tmp_path / "st"), idx, pruner=tp)
    s_build = serve.RetrievalServer(idx, tp, k=10, max_batch=4)
    s_load = serve.RetrievalServer(ShardedDenseIndex.load(store, tmesh),
                                   store.load_pruner(device="cpu"), k=10, max_batch=4)
    try:
        for q in Q:
            sb, ib = s_build.query(q)
            sl, il = s_load.query(q)
            _assert_close((sb[None], ib[None]), (sl[None], il[None]))
    finally:
        s_build.close()
        s_load.close()


class _CountingStore:
    """Delegating wrapper that records every row window read into a shard."""

    def __init__(self, store):
        self._store = store
        self.reads: list[tuple[int, int]] = []

    def read_into(self, out, start=0):
        self.reads.append((int(start), int(start) + int(out.shape[0])))
        return self._store.read_into(out, start)

    def __getattr__(self, name):
        return getattr(self._store, name)


def test_load_reads_each_local_row_exactly_once(tmp_path):
    _, tmesh = _meshes("4")
    D = _corpus(103, 32)
    tp = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    store = save_index(str(tmp_path / "st"), tp.build_index(torch.from_numpy(D),
                                                            quantize_int8=True), pruner=tp)
    counting = _CountingStore(store)
    sidx = ShardedDenseIndex.load(counting, tmesh)
    assert len(counting.reads) == tmesh.size           # one read a slot
    covered = np.zeros(store.n, dtype=int)
    for lo, hi in counting.reads:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    W, mean = tp.projection()
    q = torch.from_numpy(_rng(7).standard_normal((3, 32)).astype(np.float32))
    dense = DenseIndex.load(store, device="cpu")
    _assert_close(_np(dense.search_projected(q, W, k=5, mean=mean)),
                  _np(sidx.search_projected(q, W, k=5, mean=mean)))


def test_shard_ranges_partition_padded_rows():
    """The reference's windows, slot for slot: contiguous, disjoint, covering
    the padded rows; the clamps never reach padding."""
    jmesh, tmesh = _meshes("4")
    from jax.sharding import NamedSharding, PartitionSpec as P
    n = 103
    n_padded = n + (-n) % 4
    ranges = _addressable_shard_ranges(tmesh, (n_padded, 8), n)
    jranges = jax_shard_ranges(NamedSharding(jmesh, P(("data",), None)), (n_padded, 8), n)
    assert sorted(r[1:] for r in ranges) == sorted(r[1:] for r in jranges)
    assert [r[0] for r in ranges] == tmesh.device_list
    windows = [(start, stop) for _, start, stop, _, _ in ranges]
    assert windows[0][0] == 0 and windows[-1][1] == n_padded
    assert all(a[1] == b[0] for a, b in zip(windows, windows[1:]))
    for _, start, stop, lo, hi in ranges:
        assert start <= lo <= hi <= stop and hi <= n
    with pytest.raises(ValueError):
        _addressable_shard_ranges(tmesh, (n, 8), n)


def test_subset_addressable_reads_only_local_rows():
    """What one process of a multi-host job sees: its own slots' rows only."""
    _, tmesh = _meshes("4")
    n = 100
    per = 25
    ranges = _addressable_shard_ranges(tmesh, (n, 8), n, local=[0, 1])
    assert len(ranges) == 2
    rows = sorted((lo, hi) for _, _, _, lo, hi in ranges)
    assert rows[0][0] == 0 and max(hi for _, hi in rows) <= 2 * per
    far = _addressable_shard_ranges(tmesh, (n, 8), n, local=[3])
    assert [(lo, hi) for _, _, _, lo, hi in far] == [(75, 100)]


# ---------------------------------------------------------------------------
# a sharded base under the live index (tests/test_segments.py) and the
# updater's sharded branches
# ---------------------------------------------------------------------------


def _shared_scale_segmented(D, splits, quantize, jmesh, tmesh, capacity=256):
    """Both packages' segmented index over a sharded base with ONE shared
    scale (the reference's parity construction)."""
    if quantize:
        q8, scale = jax_quantize(jnp.asarray(D))
        stored, scale = np.array(q8), np.array(scale)
        raw = stored.astype(np.float32) * scale[None, :]
    else:
        stored, scale, raw = D, None, D
    lo = splits[0]
    jbase = JaxSharded.build(jnp.asarray(stored[:lo]), jmesh)
    jbase = JaxSharded(vectors=jbase.vectors, mesh=jmesh,
                       scale=None if scale is None else jnp.asarray(scale), n_real=lo)
    tbase = convert.sharded_index_from_numpy(stored[:lo], scale, tmesh)
    jd, td = [], []
    bounds = list(splits) + [len(D)]
    for a, b in zip(bounds, bounds[1:]):
        seg = np.zeros((capacity, D.shape[1]), stored.dtype)
        seg[:b - a] = stored[a:b]
        jd.append(JaxDelta(vectors=jnp.asarray(seg), n_real=b - a,
                           scale=None if scale is None else jnp.asarray(scale), raw=raw[a:b]))
        td.append(DeltaSegment(vectors=torch.from_numpy(seg), n_real=b - a,
                               scale=None if scale is None else torch.from_numpy(scale),
                               raw=raw[a:b]))
    return (JaxSegmented(base=jbase, deltas=tuple(jd), delta_capacity=capacity),
            SegmentedIndex(base=tbase, deltas=tuple(td), delta_capacity=capacity))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", ["1", "4"])
def test_sharded_base_parity(mesh, quantize):
    """A sharded base + dense deltas (uneven rows: device padding and delta
    padding together) against the reference's and against the port's
    monolithic sharded index; deltas offset at the base's logical n."""
    jmesh, tmesh = _meshes(mesh)
    D = _corpus(1003, 32)
    Q = _rng(8).standard_normal((7, 32)).astype(np.float32)
    jseg, tseg = _shared_scale_segmented(D, (801, 950), quantize, jmesh, tmesh)
    assert tseg.n == 1003 and tseg.storage_dtype == (torch.int8 if quantize else torch.float32)
    got = tseg.search(torch.from_numpy(Q), k=10)
    _assert_close(_np(jseg.search(jnp.asarray(Q), k=10)), _np(got))
    mono = ShardedDenseIndex.build(torch.from_numpy(D), tmesh, quantize_int8=quantize)
    _assert_close(_np(mono.search(torch.from_numpy(Q), k=10)), _np(got))
    # ids past the base come from the deltas, at offset 801
    _, ids = tseg.search(torch.from_numpy(D[[850, 960]]), k=1)
    assert ids[:, 0].tolist() == [850, 960]


def test_segmented_appends_over_a_sharded_base_match_reference():
    """Appends (rollover, a widened int8 delta) over a sharded base follow
    the reference's op stream and stored bytes; the search its answer."""
    jmesh, tmesh = _meshes("4")
    rng = np.random.default_rng(5)
    X = rng.standard_normal((301, 24)).astype(np.float32)
    jseg = JaxSegmented.from_index(JaxSharded.build(jnp.asarray(X), jmesh, quantize_int8=True),
                                   delta_capacity=64)
    tseg = SegmentedIndex.from_index(ShardedDenseIndex.build(torch.from_numpy(X), tmesh,
                                                             quantize_int8=True),
                                     delta_capacity=64)
    for bl in (rng.standard_normal((90, 24)), 9 * rng.standard_normal((20, 24))):
        bl = bl.astype(np.float32)
        jseg, jops = jseg.append_with_ops(bl)
        tseg, tops = tseg.append_with_ops(bl)
        assert [o[:2] for o in tops] == [o[:2] for o in jops]
        for a, b in zip(tops, jops):
            np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))
    assert tseg.n == jseg.n == 411
    Q = rng.standard_normal((5, 24)).astype(np.float32)
    _assert_close(_np(jseg.search(jnp.asarray(Q), k=10)),
                  _np(tseg.search(torch.from_numpy(Q), k=10)))


def _sharded_updaters(tmesh, jmesh, quantize, n=400, store_path=None):
    """Both packages' updater over the same sharded base (the reference's
    fit carried into the port)."""
    D = _corpus(n, 32)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = _carried(jp)
    Dh = np.array(jp.prune_index(jnp.asarray(D)), np.float32)
    jup = JaxUpdater(pruner=jp, index=JaxSharded.build(jnp.asarray(Dh), jmesh,
                                                       quantize_int8=quantize),
                     delta_capacity=128)
    tbase = ShardedDenseIndex.build(torch.from_numpy(Dh), tmesh, quantize_int8=quantize,
                                    merge="hierarchical")
    if store_path is not None:
        save_index(store_path, tbase, pruner=tp)
    tup = IndexUpdater(pruner=tp, index=tbase, delta_capacity=128, store=store_path)
    return jup, tup


@pytest.mark.parametrize("with_store", [False, True], ids=["storeless", "store"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_compact_keeps_the_mesh(tmp_path, quantize, with_store):
    """Compaction over a sharded base rebuilds it on the SAME mesh with the
    same merge (from the rows, or reloaded from the store's sidecar): the
    reference's fresh base, byte for byte."""
    jmesh, tmesh = _meshes("2x2")
    jup, tup = _sharded_updaters(tmesh, jmesh, quantize,
                                 store_path=str(tmp_path / "st") if with_store else None)
    assert isinstance(tup.index, SegmentedIndex)
    # the same pruned rows appended to both (one block x9, so an int8 delta
    # widens); the store-backed compaction streams the base from disk
    rng = np.random.default_rng(7)
    for mult in (1.0, 9.0):
        bl = (rng.standard_normal((150, tup.index.dim)) * mult).astype(np.float32)
        jup.index, tup.index = jup.index.append(bl), tup.index.append(bl)
    jup.compact(block_rows=64)
    tup.compact(block_rows=64)
    base = tup.index.base
    assert isinstance(base, ShardedDenseIndex)
    assert base.mesh is tmesh and base.merge == "hierarchical"
    assert tup.index.n == 700 and not tup.index.deltas
    np.testing.assert_array_equal(_stored_rows(base),
                                  np.asarray(jup.index.base.vectors)[:700])
    if quantize:
        np.testing.assert_array_equal(base.scale.numpy(), np.asarray(jup.index.base.scale))
    if with_store:
        assert IndexStore.open(str(tmp_path / "st")).n == 700
    Q = _rng(9).standard_normal((5, 32)).astype(np.float32)
    _assert_close(_np(jup.search(jnp.asarray(Q), k=10)), _np(tup.search(torch.from_numpy(Q), k=10)))


def test_iter_dequant_rows_walks_the_shards():
    """A sharded base streams its real rows in id order, padding skipped:
    the dense base's stream exactly."""
    _, tmesh = _meshes("4")
    D, _ = _data(1003, 16)
    q8, scale = quantize_int8_per_dim(torch.from_numpy(D))
    tp = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    sh = SegmentedIndex.from_index(ShardedDenseIndex.from_rows(q8, tmesh, scale=scale))
    dn = SegmentedIndex.from_index(DenseIndex(vectors=q8, scale=scale))
    up = IndexUpdater(pruner=tp, index=sh)
    a = torch.cat(list(up._iter_dequant_rows(sh, 100)))
    b = torch.cat(list(up._iter_dequant_rows(dn, 100)))
    assert a.shape == (1003, 16) and torch.equal(a, b)


def test_refit_preserves_sharded_base():
    """A refit on a sharded deployment rebuilds the base on the SAME mesh."""
    _, tmesh = _meshes("4")
    D = _corpus(400, 32)
    tp = StaticPruner(cutoff=0.5).fit(torch.from_numpy(D))
    base = tp.build_index(torch.from_numpy(D), mesh=tmesh, quantize_int8=True)
    up = IndexUpdater(pruner=tp, index=base, delta_capacity=128)
    shifted = _corpus(500, 32, seed=9)
    up.refit(torch.from_numpy(shifted))
    assert isinstance(up.index.base, ShardedDenseIndex)
    assert up.index.base.mesh is tmesh and up.index.base.dtype == torch.int8
    assert up.index.n == 500
    _, ids = up.search(torch.from_numpy(shifted[:3]), k=5)
    assert int(ids.max()) < 500


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_updater_from_store_over_a_mesh(tmp_path, writer):
    """A cold start of the updater over a mesh from a segmented store
    written by either package: the base sharded, the deltas rehydrated;
    durable appends, then SegmentedIndex.load(mesh=) serves the same."""
    jmesh, tmesh = _meshes("4")
    path, jp, tp = _saved(tmp_path, writer, True, n=801)
    grow = _corpus(900, 32)[801:870]
    if writer == "jax":
        JaxUpdater.from_store(path, delta_capacity=64).add_documents(jnp.asarray(grow[:40]))
    else:
        IndexUpdater.from_store(path, delta_capacity=64, device="cpu").add_documents(
            torch.from_numpy(grow[:40]))
    up = IndexUpdater.from_store(path, mesh=tmesh, merge="hierarchical", delta_capacity=64)
    assert isinstance(up.index.base, ShardedDenseIndex) and up.index.base.mesh is tmesh
    assert up.index.base.n == 801 and up.index.n == 841
    up.add_documents(torch.from_numpy(grow[40:]))
    assert IndexStore.open(path).n == 870
    Q = _rng(10).standard_normal((5, 32)).astype(np.float32)
    qh = up.pruner.transform_queries(torch.from_numpy(Q))
    reloaded = SegmentedIndex.load(path, mesh=tmesh, delta_capacity=64)
    assert isinstance(reloaded.base, ShardedDenseIndex) and reloaded.n == 870
    assert _same(up.index.search(qh, k=10), reloaded.search(qh, k=10))
    jseg = JaxSegmented.load(path, mesh=jmesh, delta_capacity=64)
    _assert_close(_np(jseg.search(jp.transform_queries(jnp.asarray(Q)), k=10)),
                  _np(reloaded.search(qh, k=10)))


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def _spy(monkeypatch, Qfix):
    """Each server's replies to ``Qfix`` right after its warmup, beside its
    index's direct search."""
    answers = []
    warmup = serve.RetrievalServer.warmup

    def spy(self):
        warmup(self)
        W, mean = self._proj
        answers.append(([self.query(q) for q in Qfix],
                        [tuple(x[0].numpy() for x in self.index.search_projected(
                            q[None], W, k=self.k, mean=mean)) for q in Qfix],
                        self.index))

    monkeypatch.setattr(serve.RetrievalServer, "warmup", spy)
    return answers


def _assert_replies_are_direct(answers):
    for replies, direct, _ in answers:
        for (gs, gi), (ws, wi) in zip(replies, direct):
            _assert_ids_equal_up_to_near_ties(ws[None], wi[None], gs[None], gi[None])
            np.testing.assert_allclose(gs, ws, **TOL)


COMMON = ["--device", "cpu", "--queries", "16", "--batch", "8", "--k", "10"]


def test_serve_cli_sharded_hierarchical(monkeypatch, capsys):
    """``--sharded --host-devices 4 --merge hierarchical``: a 2x2 mesh of CPU
    slots; the replies are the sharded index's own search."""
    Qfix = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    answers = _spy(monkeypatch, Qfix)
    serve.main([*COMMON, "--n-docs", "2003", "--dim", "64", "--sharded",
                "--host-devices", "4", "--merge", "hierarchical"])
    out = capsys.readouterr().out
    assert ("sharded index: 2003 x 32 over mesh {'row': 2, 'col': 2} on cpu" in out
            and "merge=hierarchical" in out)
    index = answers[0][2]
    assert isinstance(index, ShardedDenseIndex) and index.mesh.shape == (2, 2)
    _assert_replies_are_direct(answers)


def test_serve_cli_sharded_live_append(monkeypatch, capsys):
    """``--sharded --live-append``: a segmented index over the sharded base
    takes appends under traffic, then compacts onto the same mesh."""
    Qfix = np.random.default_rng(4).standard_normal((4, 64)).astype(np.float32)
    answers = _spy(monkeypatch, Qfix)
    serve.main([*COMMON, "--n-docs", "2000", "--dim", "64", "--sharded", "--host-devices",
                "3", "--quantize-int8", "--live-append", "3000", "--delta-capacity", "128"])
    out = capsys.readouterr().out
    assert "over mesh {'data': 3} on cpu" in out and "torch.int8" in out
    assert "live-append: +" in out and "compaction: base+deltas" in out
    assert "compacted base:" in out and "over mesh {'data': 3}" in out.split("compacted base:")[1]
    _assert_replies_are_direct(answers)


@pytest.mark.parametrize("mode", ["plain", "live_append"])
def test_serve_cli_sharded_save_then_load(tmp_path, monkeypatch, capsys, mode):
    """A sharded build saved with ``--save-index``, restarted with
    ``--load-index --sharded`` (under ``--live-append`` through
    ``IndexUpdater.from_store`` over the mesh, so appends grow the
    artifact): the restart answers as the built server did."""
    import re
    Qfix = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    answers = _spy(monkeypatch, Qfix)
    path = str(tmp_path / "idx")
    serve.main([*COMMON, "--n-docs", "2003", "--dim", "64", "--quantize-int8", "--sharded",
                "--save-index", path])
    assert f"saved artifact: {path}" in capsys.readouterr().out
    assert IndexStore.open(path).n == 2003
    extra = {"plain": ["--merge", "hierarchical"],
             "live_append": ["--live-append", "3000", "--delta-capacity", "128"]}[mode]
    serve.main([*COMMON, "--load-index", path, "--sharded", *extra])
    out = capsys.readouterr().out
    assert re.search(r"cold start \(open store -> first query\): [0-9.]+ms", out)
    built, loaded = answers[0][0], answers[1][0]
    for (ws, wi), (gs, gi) in zip(built, loaded):
        _assert_close((ws[None], wi[None]), (gs[None], gi[None]), mode)
    if mode == "plain":
        assert "loaded sharded index: 2003 x 32 over mesh {'row': 2, 'col': 2}" in out
    else:
        assert "loaded segmented index: 2003 x 32" in out and "sharded base" in out
        assert "compaction: base+deltas" in out and "compacted base:" in out
        grown = IndexStore.open(path)
        assert grown.n > 2003 and grown.meta["compactions"] == 1


@pytest.mark.parametrize("flags", [
    ["--sharded", "--paged"], ["--sharded", "--cascade", "16:4"], ["--sharded", "--fleet", "2"],
    ["--host-devices", "4"], ["--merge", "hierarchical"], ["--sharded", "--host-devices", "-1"]],
    ids=["paged", "cascade", "fleet", "host_devices_alone", "merge_alone", "negative"])
def test_serve_cli_sharded_refusals(flags, capsys):
    """The reference's refusals of ``--sharded`` with ``--paged``,
    ``--cascade`` and ``--fleet``, and the mesh flags without
    ``--sharded``."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", *flags])
    err = capsys.readouterr().err
    assert {"paged": "--paged does not compose with --sharded",
            "cascade": "--cascade does not compose with --sharded",
            "fleet": "--fleet composes with the single-node flat index only"}.get(
        next((f[2:] for f in flags if f in ("--paged", "--cascade", "--fleet")), ""),
        "error:") in err
