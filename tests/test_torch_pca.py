"""PCA fit and transforms of the port against ``repro`` on the same inputs:
eigenvalues at rtol 1e-4, components equal up to a per-column sign, and
``pca.npz`` read by either package from the other's file."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pca as jpca
from repro.core.pruning import StaticPruner as JaxPruner
from repro_torch import convert
from repro_torch.core import pca as tpca
from repro_torch.core.pruning import StaticPruner


def _corpus(n=600, d=48, seed=0):
    """Rows with a well separated spectrum, so eigenvectors are well
    defined (a near-degenerate pair may rotate within its plane)."""
    rng = np.random.default_rng(seed)
    lam = np.geomspace(4.0, 0.05, d)
    return (rng.standard_normal((n, d)) * np.sqrt(lam)).astype(np.float32) @ \
        np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)


def _assert_same_up_to_sign(A, B, atol):
    signs = np.sign(np.sum(A * B, axis=0))
    np.testing.assert_allclose(A * signs[None, :], B, atol=atol)


def test_gram_matches_reference():
    D = _corpus()
    np.testing.assert_allclose(tpca.gram(torch.from_numpy(D), block_rows=128).numpy(),
                               np.asarray(jpca.gram(jnp.asarray(D), block_rows=128)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("center", [False, True])
def test_fit_pca_matches_reference(center):
    D = _corpus(seed=1)
    js = jpca.fit_pca(jnp.asarray(D), center=center)
    ts = tpca.fit_pca(torch.from_numpy(D), center=center)
    assert ts.centered == center and ts.n_samples == int(js.n_samples)
    np.testing.assert_allclose(ts.eigenvalues.numpy(), np.asarray(js.eigenvalues),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), atol=1e-6)
    _assert_same_up_to_sign(ts.components.numpy(), np.asarray(js.components),
                            atol=2e-3)
    assert (np.diff(ts.eigenvalues.numpy()) <= 0).all()


def test_fit_streaming_equals_fit():
    D = _corpus(seed=2)
    blocks = [D[i:i + 100] for i in range(0, len(D), 100)]
    a = tpca.fit_pca_streaming(blocks, device="cpu")
    b = tpca.fit_pca(torch.from_numpy(D))
    np.testing.assert_allclose(a.eigenvalues.numpy(), b.eigenvalues.numpy(),
                               rtol=1e-4, atol=1e-6)
    js = jpca.fit_pca_streaming(blocks)
    np.testing.assert_allclose(a.eigenvalues.numpy(), np.asarray(js.eigenvalues),
                               rtol=1e-4, atol=1e-6)


def _carried(js):
    return convert.pca_state_from_numpy(
        np.asarray(js.components), np.asarray(js.eigenvalues),
        np.asarray(js.mean), int(js.n_samples), js.centered, device="cpu")


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("m", [None, 12])
def test_transforms_match_reference_with_carried_state(center, m):
    D = _corpus(seed=3)
    js = jpca.fit_pca(jnp.asarray(D), center=center)
    ts = _carried(js)
    X = D[:50]
    np.testing.assert_allclose(tpca.transform(torch.from_numpy(X), ts, m).numpy(),
                               np.asarray(jpca.transform(jnp.asarray(X), js, m)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tpca.transform_query(torch.from_numpy(X[0]), ts, m).numpy(),
        np.asarray(jpca.transform_query(jnp.asarray(X[0]), js, m)),
        rtol=1e-5, atol=1e-5)
    T = tpca.transform(torch.from_numpy(X), ts, m)
    np.testing.assert_allclose(
        tpca.inverse_transform(T, ts).numpy(),
        np.asarray(jpca.inverse_transform(jnp.asarray(T.numpy()), js)),
        rtol=1e-5, atol=1e-5)
    W, mean = tpca.projection_operands(ts, m)
    jW, jmean = jpca.projection_operands(js, m)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    assert (mean is None) == (jmean is None)


def test_dimension_helpers_match_reference():
    js = jpca.fit_pca(jnp.asarray(_corpus(seed=4)))
    ts = _carried(js)
    for d, c in [(768, 0.25), (768, 0.5), (768, 0.75), (100, 0.0), (7, 0.99)]:
        assert tpca.m_from_cutoff(d, c) == jpca.m_from_cutoff(d, c)
        assert tpca.cutoff_from_m(d, 50) == jpca.cutoff_from_m(d, 50)
    with pytest.raises(ValueError):
        tpca.m_from_cutoff(768, 1.0)
    for target in (0.1, 0.5, 0.9, 0.999, 1.0):
        assert tpca.m_for_variance(ts, target) == jpca.m_for_variance(js, target)
    np.testing.assert_allclose(tpca.explained_variance_ratio(ts).numpy(),
                               np.asarray(jpca.explained_variance_ratio(js)),
                               rtol=1e-6)


def test_pca_npz_cross_loads_both_ways(tmp_path):
    D = _corpus(seed=5)
    js = jpca.fit_pca(jnp.asarray(D), center=True)
    jpca.save_pca(str(tmp_path / "ref.npz"), js)
    ts = tpca.load_pca(str(tmp_path / "ref.npz"), device="cpu")
    np.testing.assert_array_equal(ts.components.numpy(), np.asarray(js.components))
    assert ts.centered and ts.n_samples == len(D)

    own = tpca.fit_pca(torch.from_numpy(D))
    tpca.save_pca(str(tmp_path / "port.npz"), own)
    back = jpca.load_pca(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.components), own.components.numpy())
    np.testing.assert_array_equal(np.asarray(back.eigenvalues), own.eigenvalues.numpy())
    assert not back.centered and int(back.n_samples) == len(D)
    assert set(np.load(tmp_path / "port.npz").files) == \
        set(np.load(tmp_path / "ref.npz").files)

    # StaticPruner.save / load on both sides
    JaxPruner(cutoff=0.5).fit(jnp.asarray(D)).save(str(tmp_path / "pr.npz"))
    p = StaticPruner.load(str(tmp_path / "pr.npz"), device="cpu")
    assert p.kept_dims == 24


def test_pruner_matches_reference_with_carried_state():
    D = _corpus(seed=6)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(D))
    tp = StaticPruner(cutoff=0.5)
    tp.state = _carried(jp.state)
    assert tp.kept_dims == jp.kept_dims and tp.effective_cutoff == jp.effective_cutoff
    np.testing.assert_allclose(
        tp.prune_index(torch.from_numpy(D), block_rows=256).numpy(),
        np.asarray(jp.prune_index(jnp.asarray(D), block_rows=256)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tp.transform_queries(torch.from_numpy(D[:5])).numpy(),
        np.asarray(jp.transform_queries(jnp.asarray(D[:5]))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        StaticPruner(cutoff=0.5, m=3)
    with pytest.raises(RuntimeError, match="not fitted"):
        StaticPruner(m=3).transform_queries(torch.zeros(2, 3))
