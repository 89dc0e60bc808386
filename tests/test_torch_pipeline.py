"""The paper's prune-and-search path through the port against ``repro``:
the Table-1 and Table-2 protocols (benchmarks/table1_indomain.py,
table2_ood.py) on one synthetic dataset, fed to both packages from the
same numpy arrays, and the port's protocol drivers. Also: the port imports
neither JAX nor ``repro``, and defaults to the card."""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DenseIndex as JaxIndex, StaticPruner as JaxPruner
from repro.core.metrics import (
    evaluate_run as jax_evaluate_run,
    wilcoxon_significant as jax_wilcoxon,
)
from repro.data import synthetic as jax_synthetic
from repro.data.synthetic import (
    make_dataset as jax_make_dataset,
    make_ood_corpus as jax_make_ood_corpus,
)
from repro_torch import convert
from repro_torch.core.index import DenseIndex
from repro_torch.core.metrics import evaluate_run, wilcoxon_significant
from repro_torch.core.pruning import StaticPruner
from repro_torch.data import synthetic as port_synthetic
from repro_torch.data.synthetic import make_dataset, make_ood_corpus, ood_corpus_on_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRICS = ("AP", "MRR@10", "nDCG@10")
DEPTH = 1000                     # benchmarks/common.py:24 retrieves this deep


@functools.lru_cache(maxsize=None)
def _hash_seed0(name: str) -> int:
    """``hash(name)`` as a process started with PYTHONHASHSEED=0 computes it."""
    out = subprocess.run([sys.executable, "-c", "import sys; print(hash(sys.argv[1]))", name],
                         env={**os.environ, "PYTHONHASHSEED": "0"}, capture_output=True,
                         text=True, check=True)
    return int(out.stdout)


@pytest.fixture(scope="module", autouse=True)
def _string_hash_of_seed0():
    """Both packages' ``make_dataset`` seed their generators with
    ``hash(name)``, which Python salts per process unless PYTHONHASHSEED is
    set. So each test process drew another dataset, and on some (6 of the
    88 hash seeds 0 to 87) the two frameworks' sums, an ULP apart, order a near-tie
    inside a query's top 10 differently, which the carried-state tests
    count as a swap. The module draws, in both packages alike, the dataset
    a PYTHONHASHSEED=0 process draws (as ``chip_smoke.py`` and the examples
    run): the same on every run."""
    def seeded(x):
        return _hash_seed0(x) if isinstance(x, str) else hash(x)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_synthetic, port_synthetic):
            mp.setattr(mod, "hash", seeded, raising=False)
        yield


@pytest.fixture(scope="module")
def dataset():
    return make_dataset("tasb", n_docs=4000, d=128, seed=0,
                        query_sets=("dl19", "devsmall"))


def _jax_run(D, Q, pruner=None):
    Dx = pruner.prune_index(D) if pruner else D
    Qx = pruner.transform_queries(Q) if pruner else Q
    s, ids = JaxIndex.build(Dx).search(Qx, k=min(DEPTH, Dx.shape[0]))
    return np.asarray(s), np.asarray(ids)


def _port_run(D, Q, pruner=None):
    Dx = pruner.prune_index(D) if pruner else D
    Qx = pruner.transform_queries(Q) if pruner else Q
    s, ids = DenseIndex.build(Dx).search(Qx, k=min(DEPTH, Dx.shape[0]))
    return s.numpy(), ids.numpy()


def _assert_differences_are_near_ties(s_ref, i_ref, s_got, i_got, eps=1e-5):
    """Ids equal the reference's, except where the reference's neighbouring
    scores lie within ``eps``, or, in the last slot, where the port's doc
    (from just past the reference's cut) scores within ``eps`` of the one
    it displaced: the frameworks sum in different orders, and the
    reference itself ties exactly where the port differs by an ULP."""
    k = s_ref.shape[1]
    for b, j in zip(*np.nonzero(i_ref != i_got)):
        assert any(abs(s_ref[b, j] - s_ref[b, jj]) <= eps
                   for jj in (j - 1, j + 1) if 0 <= jj < k) or (
            j == k - 1 and abs(s_got[b, j] - s_ref[b, j]) <= eps), \
            (b, j, s_ref[b, max(j - 1, 0):j + 2])


def _assert_protocol_matches(jrun, trun, qrels, *, top10_swaps=0):
    """Scores at 1e-5, ids up to near-tie swaps, the same top-10 ids on all
    but ``top10_swaps`` queries, and per-query metrics within 1e-6: nDCG@10
    and MRR@10 wherever the top 10 agree, AP wherever the two rankings
    carry the same relevance grades position by position, down to the
    depth AP is taken at.

    A near-tie swap of two docs of different grades below the top 10
    (rare: one query of 486 across the carried-state cases) moves AP by an
    amount set by the swap's rank, up to ~3e-5; which pairs swap also
    varies from run to run, since CPU matmuls differ by an ULP between
    runs. For those queries the metric code itself is held: both packages
    score the port's ranking alike within 1e-6."""
    (js, ji), (ts, ti) = jrun, trun
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    _assert_differences_are_near_ties(js, ji, ts, ti)
    top10 = (ji[:, :10] == ti[:, :10]).all(1)
    assert (~top10).sum() <= top10_swaps
    grades = [np.array([[qrels[b].get(int(x), 0) for x in row]
                        for b, row in enumerate(ids)]) for ids in (ji, ti)]
    same = (grades[0] == grades[1]).all(1)
    assert (~same).sum() <= max(1, len(ji) // 10)
    jm = _metrics(ji, qrels, jax_evaluate_run)
    tm = _metrics(ti, qrels, evaluate_run)
    jm_port_ranking = _metrics(ti, qrels, jax_evaluate_run)
    for name in METRICS:
        held = same if name == "AP" else top10
        np.testing.assert_allclose(tm[name][held], jm[name][held], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tm[name], jm_port_ranking[name], rtol=0,
                                   atol=1e-6)


def _metrics(ids, qrels, evaluate):
    return evaluate({i: ids[i].tolist() for i in range(len(ids))}, qrels,
                    metrics=METRICS)


def test_port_dataset_equals_reference(dataset):
    ref = jax_make_dataset("tasb", n_docs=4000, d=128, seed=0,
                           query_sets=("dl19", "devsmall"))
    np.testing.assert_array_equal(dataset.docs, ref.docs)
    for qs in ("dl19", "devsmall"):
        np.testing.assert_array_equal(dataset.queries[qs], ref.queries[qs])
        assert dataset.qrels[qs] == ref.qrels[qs]


@pytest.mark.parametrize("cutoff", [None, 0.25, 0.5, 0.75])
def test_table1_protocol_matches_reference_with_carried_state(dataset, cutoff):
    """Same fitted state in both packages: identical top-10 ids on every
    query, the same per-query nDCG@10 / MRR@10 (within 1e-6), and AP within
    1e-6 up to near-tie swaps below the top 10."""
    jD, tD = jnp.asarray(dataset.docs), torch.from_numpy(dataset.docs)
    jp = tp = None
    if cutoff is not None:
        jp = JaxPruner(cutoff=cutoff).fit(jD)
        s = jp.state
        tp = StaticPruner(cutoff=cutoff)
        tp.state = convert.pca_state_from_numpy(
            np.asarray(s.components), np.asarray(s.eigenvalues),
            np.asarray(s.mean), int(s.n_samples), s.centered, device="cpu")
    for qs, Q in dataset.queries.items():
        _assert_protocol_matches(_jax_run(jD, jnp.asarray(Q), jp),
                                 _port_run(tD, torch.from_numpy(Q), tp),
                                 dataset.qrels[qs])


def test_ood_corpus_equals_reference():
    for kw in ({}, {"seed": 3, "domain_seed": 77}):
        np.testing.assert_array_equal(
            make_ood_corpus("contriever", n_docs=300, d=64, **kw),
            jax_make_ood_corpus("contriever", n_docs=300, d=64, **kw))


def test_ood_corpus_on_device_shares_the_encoder_space():
    """The device draw of the OOD corpus lives in ``make_corpus``'s encoder
    space with the OOD domain's spectrum: a PCA fit on it keeps nearly the
    same energy on the host-drawn OOD corpus as a fit on that corpus."""
    host = torch.from_numpy(make_ood_corpus("tasb", n_docs=4000, d=64))
    dev = ood_corpus_on_device("tasb", n_docs=4000, d=64, device="cpu")
    assert dev.shape == (4000, 64)
    torch.testing.assert_close(dev.norm(dim=1), torch.ones(4000))
    W_host = StaticPruner(cutoff=0.5).fit(host).projection()[0]
    W_dev = StaticPruner(cutoff=0.5).fit(dev).projection()[0]
    e_host = float(((host @ W_host) ** 2).sum() / (host ** 2).sum())
    e_dev = float(((host @ W_dev) ** 2).sum() / (host ** 2).sum())
    assert abs(e_host - e_dev) < 0.01


def test_table2_protocol_matches_reference_with_carried_state(dataset):
    """Table 2 (RQ2): W_m fit OUT of domain on ``make_ood_corpus``, then
    the in-domain query sets searched. With the reference's fitted state
    carried across: identical top-10 ids, nDCG@10 / MRR@10 within 1e-6."""
    ood = make_ood_corpus("tasb", n_docs=4000, d=128)
    jp = JaxPruner(cutoff=0.5).fit(jnp.asarray(ood))
    s = jp.state
    tp = StaticPruner(cutoff=0.5)
    tp.state = convert.pca_state_from_numpy(
        np.asarray(s.components), np.asarray(s.eigenvalues), np.asarray(s.mean),
        int(s.n_samples), s.centered, device="cpu")
    jD, tD = jnp.asarray(dataset.docs), torch.from_numpy(dataset.docs)
    for qs, Q in dataset.queries.items():
        _assert_protocol_matches(_jax_run(jD, jnp.asarray(Q), jp),
                                 _port_run(tD, torch.from_numpy(Q), tp),
                                 dataset.qrels[qs])


def test_protocol_drivers_on_cpu(tmp_path, capsys):
    """Each driver runs through its command line on the CPU, prints the
    reference's table header and writes its JSON where it was told."""
    import json

    from repro_torch.benchmarks import (
        fig1_cutoff,
        fig2_nembed,
        index_size,
        table1_indomain,
        table2_ood,
    )
    from repro_torch.benchmarks.common import main
    small = ["--device", "cpu", "--n-docs", "1200", "--dim", "32"]
    for mod, head in ((table1_indomain, "### Table 1 — tasb (in-domain PCA)"),
                      (table2_ood, "### Table 2 — ance (out-of-domain PCA)"),
                      (fig1_cutoff, "### Fig 1 — DL19 effectiveness vs cutoff"),
                      (fig2_nembed, "### Fig 2 — nDCG@10 (DL19)"),
                      (index_size, "index_pca_c50_int8,0,bytes=")):
        out = tmp_path / f"{mod.__name__}.json"
        main(mod.__name__.rsplit(".", 1)[1], mod.run, [*small, "--out", str(out)],
             datasets=mod is not index_size)
        assert head in capsys.readouterr().out
        doc = json.loads(out.read_text())
        assert doc["device"] == "cpu" and doc["n_docs"] == 1200 and doc["results"]


def test_table1_protocol_with_own_fit_matches_reference(dataset):
    """The port's own fit (eigh in torch) at cutoff 0.5 retrieves what the
    reference retrieves, up to near-ties, and the Wilcoxon verdicts vs the
    unpruned baseline agree."""
    jD, tD = jnp.asarray(dataset.docs), torch.from_numpy(dataset.docs)
    jp = JaxPruner(cutoff=0.5).fit(jD)
    tp = StaticPruner(cutoff=0.5).fit(tD)
    Q = dataset.queries["dl19"]
    jrun = _jax_run(jD, jnp.asarray(Q), jp)
    trun = _port_run(tD, torch.from_numpy(Q), tp)
    # two fits may differ by an ULP in W_m: one query's top 10 may swap a
    # near-tie
    _assert_protocol_matches(jrun, trun, dataset.qrels["dl19"], top10_swaps=1)
    qrels = dataset.qrels["dl19"]
    base = _metrics(_port_run(tD, torch.from_numpy(Q))[1], qrels, evaluate_run)
    jbase = _metrics(_jax_run(jD, jnp.asarray(Q))[1], qrels, jax_evaluate_run)
    pruned = _metrics(trun[1], qrels, evaluate_run)
    jpruned = _metrics(jrun[1], qrels, jax_evaluate_run)
    for name in METRICS:
        sig, p = wilcoxon_significant(base[name], pruned[name])
        jsig, _ = jax_wilcoxon(jbase[name], jpruned[name])
        assert sig == jsig
        # a near-tie swap may nudge a p-value; the test itself is held exactly
        assert jax_wilcoxon(base[name], pruned[name]) == (sig, p)


@pytest.mark.parametrize("quantize_int8", [False, True])
def test_search_projected_equals_two_step_search(dataset, quantize_int8):
    """The serving path (raw query, W_m, scale fold, top-k) returns what
    transform_queries -> search returns, and matches the reference."""
    tD = torch.from_numpy(dataset.docs)
    tp = StaticPruner(cutoff=0.5).fit(tD)
    index = tp.build_index(tD, quantize_int8=quantize_int8)
    Q = torch.from_numpy(dataset.queries["dl19"])
    W, mean = tp.projection()
    s1, i1 = index.search_projected(Q, W, k=10, mean=mean)
    s2, i2 = index.search(tp.transform_queries(Q), k=10)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-5, atol=1e-5)

    jindex = JaxIndex(vectors=jnp.asarray(index.vectors.numpy()),
                      scale=None if index.scale is None
                      else jnp.asarray(index.scale.numpy()))
    s3, i3 = jindex.search_projected(jnp.asarray(Q.numpy()),
                                     jnp.asarray(W.numpy()), k=10)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i3))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s3), rtol=1e-5, atol=1e-5)
    assert index.nbytes == (index.vectors.numel() * index.vectors.element_size()
                            + (0 if index.scale is None else 4 * index.dim))


def test_library_defaults_to_the_card():
    """Without a card, anything that would place data by default raises and
    names the device, instead of quietly using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.util import default_device
    with pytest.raises(RuntimeError, match="cuda"):
        default_device()
    with pytest.raises(RuntimeError, match="cuda"):
        DenseIndex.build(np.zeros((4, 2), np.float32))
    assert default_device("cpu") == torch.device("cpu")


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
