"""The port's analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``) where the two mean the same thing, its
fixtures, and its gate on the live tree.

Two directions, as ``tests/test_analysis.py``: every known-bad fixture trips
exactly its finding, and the port's code gives no unsuppressed finding on
the CPU (the gate is green at head). The AST passes are held to the
reference's analyzer key for key (the module renamed).
"""
import ast
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import concurrency as ref_conc
from repro.analysis import lock_sanitizer as ref_locks
from repro_torch.analysis import BASELINE_PATH, COSTS_PATH, Finding
from repro_torch.analysis import concurrency, cost_model, dispatch_lints, invariants
from repro_torch.analysis import kernel_budget, lock_sanitizer
from repro_torch.analysis.fixtures import bad_invariants, bad_jaxpr
from repro_torch.analysis.report import (apply_baseline, format_text, load_baseline,
                                         write_report)

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "src" / "repro" / "analysis" / "fixtures"
FIXTURES = REPO / "src" / "repro_torch" / "analysis" / "fixtures"


def _rename(key: str) -> str:
    return key.replace("repro_torch.", "repro.")


# ---------------------------------------------------------------------------
# the AST passes, key for key with the reference's analyzer
# ---------------------------------------------------------------------------


def test_concurrency_keys_equal_the_reference_over_the_port():
    ours = sorted(f.key for f in concurrency.run())
    theirs = sorted(f.key for f in ref_conc.analyze(concurrency.source_targets()))
    assert ours == theirs
    assert ours == [
        "conc.unguarded-field:repro_torch.launch.serve:RetrievalServer._busy:_inflight_n",
        "conc.unlocked-shared-mutable:repro_torch.launch.serve:RetrievalServer:error"]
    # and the reference's own tree gives the same keys, the module renamed
    assert [_rename(k) for k in ours] == sorted(
        f.key for f in ref_conc.run() if f.key.startswith("conc."))


@pytest.mark.parametrize("name", ["bad_locks", "bad_handoff"])
def test_reference_fixtures_give_the_same_keys(name):
    path = REF_FIXTURES / f"{name}.py"
    assert sorted(f.key for f in concurrency.analyze([("fx", path)])) == sorted(
        f.key for f in ref_conc.analyze([("fx", path)]))
    ours = lock_sanitizer.handoff_findings(concurrency.analyze_classes(path.read_text(), "fx"))
    theirs = ref_locks.handoff_findings(ref_conc.analyze_classes(path.read_text(), "fx"))
    assert [f.key for f in ours] == [f.key for f in theirs]


def test_static_lock_graph_equals_the_reference():
    ours = lock_sanitizer.static_lock_graph()
    theirs = ref_locks.static_lock_graph()

    def strip(label):
        return label.split(":", 1)[1]

    assert ours["edges"] == [["repro_torch.core.maintenance:IndexUpdater._lock",
                              "repro_torch.launch.serve:RetrievalServer._index_lock"]]
    assert [[strip(a), strip(b)] for a, b in ours["edges"]] == theirs["edges"]
    assert {strip(n) for n in ours["nodes"]} >= set(theirs["nodes"]) - {"Router._lock"}
    assert all(n.startswith("repro_torch.") for n in ours["nodes"])
    assert ours["handoffs"] == theirs["handoffs"] == []
    # the reference's analyzer over the port's sources draws the same graph
    infos = []
    for module, path in concurrency.source_targets():
        infos += ref_conc.analyze_classes(Path(path).read_text(), module)
    assert ref_locks.static_lock_graph(infos)["edges"] == theirs["edges"]


def test_handoff_clean_on_live_tree():
    assert lock_sanitizer.run() == []


# ---------------------------------------------------------------------------
# report / baseline
# ---------------------------------------------------------------------------


def _f(check="c.x", where="w", sev="error"):
    return Finding(check=check, where=where, message="m", severity=sev)


def test_baseline_roundtrip(tmp_path):
    findings = [_f(where="a"), _f(where="b"), _f(where="w2", sev="warn")]
    base = tmp_path / "b.json"
    base.write_text(json.dumps({"suppressions": [
        {"key": "c.x:a", "reason": "reviewed"}, {"key": "c.x:gone", "reason": "paid off"}]}))
    report = apply_baseline(findings, load_baseline(base))
    assert [f.where for f in report.findings] == ["b", "w2"]
    assert report.gating == (findings[1],)
    assert report.stale == ("c.x:gone",)
    out = tmp_path / "r.json"
    write_report(report, out)
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro_torch.analysis/v1"
    assert doc["counts"] == {"findings": 2, "gating": 1, "suppressed": 1,
                             "stale_suppressions": 1}
    assert "stale-suppression" in format_text(report)
    assert load_baseline(None) == {} and load_baseline(tmp_path / "none.json") == {}


def test_duplicate_baseline_key_rejected(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"suppressions": [{"key": "k", "reason": "1"},
                                              {"key": "k", "reason": "2"}]}))
    with pytest.raises(ValueError, match="duplicate"):
        load_baseline(p)


def test_stale_suppressions_scoped_to_ran_analyzers():
    findings = [_f(check="conc.x", where="a")]
    baseline = {"conc.x:a": "r", "cost.regression:gone": "r", "budget.smem:x": "r",
                "mystery.key:z": "r"}
    rep = apply_baseline(findings, baseline, active_analyzers=["conc"])
    assert rep.stale == ("mystery.key:z",)
    rep = apply_baseline(findings, baseline, active_analyzers=None)
    assert sorted(rep.stale) == ["budget.smem:x", "cost.regression:gone", "mystery.key:z"]


def test_port_baseline_holds_only_the_expected_keys():
    keys = sorted(load_baseline(BASELINE_PATH))
    assert keys == [
        "conc.unguarded-field:repro_torch.launch.serve:RetrievalServer._busy:_inflight_n",
        "conc.unlocked-shared-mutable:repro_torch.launch.serve:RetrievalServer:error",
        "dispatch.host-sync:CascadeIndex.search_projected[paged-host,int8]"]
    ref = load_baseline(REPO / "analysis_baseline.json")
    ours = load_baseline(BASELINE_PATH)
    for key in keys[:2]:
        assert ours[key] == ref[_rename(key)]
    assert all(ours.values())


# ---------------------------------------------------------------------------
# the fixtures: each trips exactly its finding
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(5)


def _int8_corpus(n=256, m=32):
    D = torch.from_numpy(RNG.integers(-127, 128, size=(n, m)).astype(np.int8))
    scale = torch.full((m,), 0.05)
    q = torch.from_numpy(RNG.standard_normal((3, m)).astype(np.float32))
    return D, scale, q


def _fixture_findings(case):
    D, scale, q = _int8_corpus()
    Df = D.float()
    if case == "upcast":
        return dispatch_lints.check_upcast(
            "fx", lambda x: bad_jaxpr.upcasting_search(D, scale, x), (q,), tuple(D.shape),
            strip_rows=64)
    if case == "strip-sized-dequant":
        D64 = D[:64].contiguous()
        return dispatch_lints.check_upcast(
            "fx", lambda x: bad_jaxpr.upcasting_search(D64, scale, x), (q,),
            tuple(D64.shape), strip_rows=64)
    if case == "two-call":
        return dispatch_lints.check_dispatch_count(
            "fx", lambda x: bad_jaxpr.two_call_search(Df, x), (q,), 1)
    if case == "chatty":
        return dispatch_lints.check_host_sync("fx", lambda x: bad_jaxpr.chatty_search(Df, x),
                                              (q,))
    if case == "recompile":
        s = bad_jaxpr.RecompilingSearcher(Df[:64].contiguous(), q)
        return dispatch_lints.check_recompile_stability(
            lambda live: (lambda: s.search(live)), [4, 5, 6], "fx")
    raise ValueError(case)


@pytest.mark.parametrize("case,expect", [
    ("upcast", ["dispatch.upcast"]),
    ("strip-sized-dequant", []),
    ("two-call", ["dispatch.extra-dispatch"]),
    ("chatty", ["dispatch.host-sync"]),
    ("recompile", ["dispatch.recompile"]),
])
def test_dispatch_fixtures_trip_exactly_their_finding(case, expect):
    fs = _fixture_findings(case)
    assert [f.check for f in fs] == expect
    assert all(f.severity == "error" for f in fs)


def test_upcast_message_names_the_op():
    (f,) = _fixture_findings("upcast")
    assert "aten." in f.message and "torch.int8" in f.message


def test_fused_entry_is_one_call_and_reads_no_host():
    """The port's own dense path is the known-good control."""
    ep = next(e for e in dispatch_lints.serving_entry_points()
              if e.label == "DenseIndex.search_projected[int8]")
    assert dispatch_lints.lint_entry(ep) == []


def test_bad_locks_fixture_findings_exact():
    fs = concurrency.analyze([("fx", FIXTURES / "bad_locks.py")])
    keys = sorted(f.key for f in fs)
    assert keys == sorted([
        "conc.unguarded-field:fx:UnguardedCounter.peek:count",
        "conc.unlocked-shared-mutable:fx:NeverLockedLog:log",
        "conc.blocking-under-lock:fx:SleepyWriter.publish:np.asarray",
        "conc.blocking-under-lock:fx:SleepyWriter.publish:time.sleep",
        "conc.lock-order:Left._lock:Right._lock"])


def test_blocking_calls_are_the_ports():
    src = '''
import threading, torch

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.x = None

    def a(self, t, ev):
        with self._lock:
            torch.cuda.synchronize()
            ev.synchronize()
            self.x = t.item()
            self.x = t.cpu()
            self.x = t.tolist()

    def b(self):
        with self._lock:
            return self.x
'''
    infos = concurrency.analyze_classes(src, "fx")
    calls = sorted(f.where.rsplit(":", 1)[1] for f in concurrency.blocking_findings(infos))
    assert calls == ["ev.synchronize", "t.cpu", "t.item", "t.tolist",
                     "torch.cuda.synchronize"]


def test_handoff_fixture_flagged_exactly():
    infos = concurrency.analyze_classes((FIXTURES / "bad_handoff.py").read_text(), "fx")
    assert [f.key for f in lock_sanitizer.handoff_findings(infos)] == \
        ["locks.handoff-deadlock:fx:StalledPipeline.consume:_q"]
    assert concurrency.lock_order_findings(infos) == []


def _costs_doc():
    return json.loads(COSTS_PATH.read_text())


@pytest.mark.parametrize("name,regressed", [
    ("shadow_copy_entry", "hbm_read_bytes_per_query"),
    ("extra_dispatch_entry", "dispatches"),
])
def test_cost_fixtures_fail_the_gate(name, regressed):
    from repro_torch.analysis.fixtures import bad_costs
    ep = getattr(bad_costs, name)()
    doc = _costs_doc()
    sub = {"schema": doc["schema"], "entries": {ep.label: doc["entries"][ep.label]}}
    fs = cost_model.compare_costs({ep.label: cost_model.measure_entry(ep)}, sub)
    got = {f.where.rsplit(":", 1)[-1] for f in fs if f.check == "cost.regression"}
    assert regressed in got
    if name == "shadow_copy_entry":
        assert "dispatches" not in got


def _inv_args():
    g = torch.Generator().manual_seed(3)
    D = torch.randn((64, 16), generator=g)
    D[0] = 50.0                                   # the row a -1 lane gathers scores highest
    q = torch.rand((2, 16), generator=g) + 0.5
    cids = torch.tensor([[5, 9, 9, 9, 33, 12, 40, 7, 2, 61, 18, 27],
                         [9, 5, 33, 33, 8, 12, 7, 40, 2, 61, 11, 27]], dtype=torch.int32)
    return D, q, cids


@pytest.mark.parametrize("fn_name,expect", [
    ("unsorted_rescore", "inv.rowids-order"),
    ("swapped_dedup_rescore", "inv.dedup-tiebreak"),
    ("unmasked_rescore", "inv.sentinel-mask"),
])
def test_invariant_fixtures_trip_exactly_their_finding(fn_name, expect):
    fs = invariants.check_entry(f"fx.{fn_name}", getattr(bad_invariants, fn_name),
                                _inv_args())
    assert [f.check for f in fs] == [expect]


def test_segment_offset_fixture_flagged():
    g = torch.Generator().manual_seed(4)
    D8a = torch.randint(-127, 127, (64, 16), generator=g).to(torch.int8)
    D8b = torch.randint(-127, 127, (64, 16), generator=g).to(torch.int8)
    fs = invariants.check_entry("fx.overlap", bad_invariants.overlapping_segments,
                                (D8a, D8b, torch.full((16,), 0.05), torch.randn(2, 16)))
    assert [f.check for f in fs] == ["inv.segment-offsets"]
    assert "100" in fs[0].message and "132" in fs[0].message


def test_invariant_inputs_exercise_the_contracts():
    """The tie corpus is exact in fp32 and breaks what it should: its
    shortlists carry -1 lanes, the row those lanes gather is the best full-
    width row but never shortlisted, and exact ties exist."""
    base, new, q = invariants.tie_corpus()
    S = q.astype(np.int64) @ base.astype(np.int64).T
    assert (S.argmax(1) == 0).all() and np.abs(S).max() < 2 ** 24
    _, cids = invariants._topk_exact(q[:, :invariants.MC] @ base[:, :invariants.MC].T,
                                     3 * invariants.K)
    assert 0 not in cids and len(np.unique(cids)) < cids.size
    label, fn, args, _ = next(e for e in invariants.tie_entry_points()
                              if e[0] == "CascadeIndex.search_projected[int8]")
    probe = dispatch_lints.run_probed(fn, args)
    (rescore,) = [c for c in probe.calls if "row_ids" in c.kwargs]
    assert int((rescore.kwargs["row_ids"] < 0).sum()) > 0


def test_invariants_clean_on_live_entry_points():
    assert invariants.run() == []


# ---------------------------------------------------------------------------
# cost model: baseline file and cross-check
# ---------------------------------------------------------------------------


def test_cost_baseline_schema_valid_and_rejects_missing_metric():
    doc = _costs_doc()
    cost_model.check_costs_schema(doc)
    label = next(iter(doc["entries"]))
    del doc["entries"][label]["flops_per_query"]
    with pytest.raises(SystemExit, match="flops_per_query"):
        cost_model.check_costs_schema(doc)


def test_cost_write_baseline_roundtrips(tmp_path):
    eps = [ep for ep in dispatch_lints.serving_entry_points() if ep.family == "dense"]
    measured = cost_model.measure_all(eps)
    path = tmp_path / "costs.json"
    cost_model.write_baseline(path, measured)
    doc = json.loads(path.read_text())
    assert cost_model.compare_costs(measured, doc) == []
    assert {k: doc["entries"][k] for k in measured} == {
        k: _costs_doc()["entries"][k] for k in measured}


def test_cost_crosscheck_flags_inverted_ordering(tmp_path):
    entries = {label: row for label, row in _costs_doc()["entries"].items()
               if row["family"] == "dense" and row["bench_key"]}
    assert len(entries) == 2
    f32, i8 = sorted(entries)                  # "[f32]" sorts before "[int8]"
    path = tmp_path / "measured.json"
    cost_model.write_measured(path, {f32: {"ms": 7.49, "B": 32}, i8: {"ms": 7.84, "B": 32}},
                              device="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    doc = json.loads(path.read_text())
    fs = cost_model.bench_crosscheck(entries, doc)
    assert [f.check for f in fs] == ["cost.bench-mismatch"]
    assert fs[0].severity == "warn" and "700.00 W" in fs[0].message
    doc["entries"][i8]["ms"] = 3.3
    assert cost_model.bench_crosscheck(entries, doc) == []
    assert cost_model.bench_crosscheck(entries, None) == []


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_cli_gate_green_on_the_tree(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "rep.json"
    rc = main(["--device", "cpu", "--json", str(out), "--measured", str(tmp_path / "none"),
               "--fail-on-findings"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["counts"]["gating"] == 0 and doc["counts"]["stale_suppressions"] == 0
    assert doc["counts"]["suppressed"] == 3
    assert [f["check"] for f in doc["findings"]] == ["budget.not-run"]


def test_cli_gate_red_on_a_fixture(tmp_path):
    from repro_torch.analysis.__main__ import main
    # without the baseline the suppressed findings gate
    assert main(["--device", "cpu", "--only", "conc", "--json", "",
                 "--baseline", str(tmp_path / "missing.json"), "--fail-on-findings"]) == 1
    # a cost baseline doctored below what the code spends
    costs = _costs_doc()
    costs["entries"]["DenseIndex.search_projected[f32]"]["hbm_read_bytes_per_query"] /= 4
    doctored = tmp_path / "costs.json"
    doctored.write_text(json.dumps(costs))
    assert main(["--device", "cpu", "--only", "cost", "--json", "", "--costs", str(doctored),
                 "--measured", str(tmp_path / "none"), "--fail-on-findings"]) == 1
    assert main(["--device", "cpu", "--only", "cost", "--json", "",
                 "--measured", str(tmp_path / "none"), "--fail-on-findings"]) == 0


def test_cli_defaults_to_the_card():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--only", "conc", "--json", ""])


def test_budget_not_run_without_the_card():
    (f,) = kernel_budget.run("cpu")
    assert f.key == "budget.not-run:kernels" and f.severity == "warn"
    assert "cpu" in f.message


# ---------------------------------------------------------------------------
# the runtime lock monitor
# ---------------------------------------------------------------------------


def test_port_monitor_nested_in_the_session_records_only_the_port():
    """Under the session's reference monitor (``tests/conftest.py``), the
    port's records only ``repro_torch`` labels, its graph embeds in the
    static one, and ``uninstrument`` puts back exactly what was there."""
    before = (threading.Lock, threading.RLock, threading.Condition)
    mon = lock_sanitizer.LockMonitor()
    originals = lock_sanitizer.instrument(mon)
    try:
        from repro_torch.core.maintenance import IndexUpdater
        from repro_torch.launch.serve import RetrievalServer
        corpus = torch.from_numpy(RNG.standard_normal((96, 32)).astype(np.float32))
        upd = IndexUpdater.build(corpus, cutoff=0.5, quantize_int8=True, delta_capacity=16)
        assert type(upd._lock).__name__ == "_TrackedLock"
        srv = RetrievalServer(upd.index, upd.pruner, max_batch=4)
        upd.server = srv
        try:
            srv.query(corpus[0].numpy())
            upd.add_documents(RNG.standard_normal((8, 32)).astype(np.float32))
            srv.query(corpus[0].numpy())
        finally:
            srv.close()
    finally:
        lock_sanitizer.uninstrument(originals)
    assert (threading.Lock, threading.RLock, threading.Condition) == before
    observed = mon.to_doc()
    assert observed["nodes"] and all(n.startswith("repro_torch.") for n in observed["nodes"])
    assert ["repro_torch.core.maintenance:IndexUpdater._lock",
            "repro_torch.launch.serve:RetrievalServer._index_lock"] in observed["edges"]
    assert lock_sanitizer.crosscheck(observed, lock_sanitizer.static_lock_graph()) == []


def test_lock_scope_keeps_the_packages_apart():
    root, analysis = lock_sanitizer._port_scope()
    assert root.endswith("repro_torch/") and analysis.endswith("repro_torch/analysis/")
    ref_file = str(REPO / "src" / "repro" / "core" / "maintenance.py")
    assert not ref_file.startswith(root)


def test_lock_graph_crosscheck_and_schema(tmp_path):
    static = {"nodes": ["m:A.x", "m:B.y", "m:C.z"], "edges": [["m:A.x", "m:B.y"],
                                                              ["m:B.y", "m:C.z"]]}
    assert lock_sanitizer.crosscheck({"nodes": ["m:A.x", "m:C.z"],
                                      "edges": [["m:A.x", "m:C.z"]]}, static) == []
    fs = lock_sanitizer.crosscheck({"nodes": ["m:A.x", "m:B.y", "m:D.w"],
                                    "edges": [["m:B.y", "m:A.x"]]}, static)
    assert sorted(f.key for f in fs) == ["locks.graph-divergence:m:B.y->m:A.x",
                                         "locks.unknown-lock:m:D.w"]
    p = tmp_path / "g.json"
    p.write_text(json.dumps({"schema": "nope", "nodes": [], "edges": []}))
    with pytest.raises(SystemExit, match="lockgraph"):
        lock_sanitizer.run(lock_graph_path=str(p))


# ---------------------------------------------------------------------------
# the package stands alone
# ---------------------------------------------------------------------------


def test_analysis_imports_neither_jax_nor_the_reference():
    pkg = REPO / "src" / "repro_torch" / "analysis"
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"
    code = ("import sys, importlib, pkgutil, repro_torch.analysis as a\n"
            "for m in pkgutil.walk_packages(a.__path__, 'repro_torch.analysis.'):\n"
            "    importlib.import_module(m.name)\n"
            "import repro_torch.analysis.__main__\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
