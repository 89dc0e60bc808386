"""The port's dry-run tools against ``repro``'s: ``launch.flops`` (matmul
FLOPs, totals, per-device argument bytes), ``launch.dryrun`` (its records
and ``--list``), ``launch.roofline`` (H100 datasheet terms), ``report``,
``reaccount`` and ``hillclimb``, and the shape-static paths the dry run
counts through: the rowwise update, held to its real path, and the decode
steps with a tensor position, held to a prefill one token longer.

Tolerances: the products' FLOPs exactly equal a dot-only walk of the
reference's jaxpr (scan bodies times their length, remat and custom-VJP
bodies recursed); total FLOPs within 5 % of the reference's
``jaxpr_cost`` (measured: at most 2.8 %, the two-tower smoke step, whose
elementwise share is the largest: aten and ``jax.lax`` split the
elementwise work into different ops); argument bytes exactly the
reference's ``memory_analysis()`` on the production mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import registry as jreg, steps as jsteps
from repro.configs.base import ShapeCell as JCell
from repro.launch.flops import jaxpr_cost
from repro.models import biencoder as JB
from repro.par import compat
from repro_torch.configs import registry, steps
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, flops, hillclimb, reaccount, report, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import rowwise
from repro_torch.par.mesh import make_mesh

TOTAL_RTOL = 0.05
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
SMOKE = {"lm": dict(seq_len=32, global_batch=8), "biencoder": dict(seq_len=16, global_batch=8),
         "recsys": dict(batch=32)}


def dot_flops(jaxpr) -> float:
    """FLOPs of the dot_generals of a jaxpr, 2·out·K each: scan bodies times
    their length, the larger branch of a cond, shard_map bodies times their
    devices, and every other sub-jaxpr (pjit, remat, custom VJP) once."""
    tot = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            k = int(np.prod([lhs.shape[d] for d in lc])) if lc else 1
            tot += 2.0 * int(np.prod(eqn.outvars[0].aval.shape)) * k
        elif prim == "scan":
            tot += eqn.params["length"] * dot_flops(eqn.params["jaxpr"].jaxpr)
        elif prim == "cond":
            tot += max(dot_flops(b.jaxpr) for b in eqn.params["branches"])
        elif prim == "shard_map":
            tot += compat.shard_map_eqn_device_count(eqn) * dot_flops(
                compat.shard_map_eqn_body(eqn))
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = eqn.params.get(key)
                if sub is not None:
                    tot += dot_flops(sub.jaxpr if hasattr(sub, "jaxpr") else sub)
                    break
    return tot


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _smoke_dims(arch):
    fam = jreg.get_arch(arch).family
    if fam == "gnn":
        return dict(n_nodes=120, n_edges=480, batch=4, d_feat=jreg.get_smoke_cfg(arch).d_in)
    return dict(SMOKE[fam])


def _bundles(arch, shape):
    """(reference bundle on a (1, 1) Auto-axes mesh, port bundle on a
    (1, 1) meta mesh): the arch's smoke config on its family's smoke cell,
    or the full config's ``shape``."""
    js, ts = jreg.get_arch(arch), registry.get_arch(arch)
    if shape == "smoke":
        dims = _smoke_dims(arch)
        js = dataclasses.replace(js, cfg=jreg.get_smoke_cfg(arch),
                                 shapes=(JCell("smoke", "train", dims),))
        ts = dataclasses.replace(ts, cfg=registry.get_smoke_cfg(arch),
                                 shapes=(ShapeCell("smoke", "train", dims),))
    jm = _auto_mesh()
    jb = jsteps.BUNDLE_BUILDERS[js.family](js, js.cell(shape), jm)
    tb = steps.BUNDLE_BUILDERS[ts.family](ts, ts.cell(shape),
                                          make_mesh((1, 1), ("data", "model"), "meta"))
    return jm, jb, tb


CELLS = [("smollm-135m", "smoke"), ("mixtral-8x7b", "smoke"), ("two-tower-retrieval", "smoke"),
         ("dlrm-mlperf", "smoke"), ("autoint", "smoke"), ("graphcast", "smoke"),
         ("graphcast", "molecule"), ("graphcast", "full_graph_sm")]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_matmul_flops_equal_the_reference_jaxpr(arch, shape):
    """Each family's smoke train step (the LMs' dense and MoE, the recsys
    two-tower's AdamW step and the CTR rowwise step, graphcast) and
    graphcast's molecule and full_graph_sm cells at full width."""
    jm, jb, tb = _bundles(arch, shape)
    with jm:
        want = dot_flops(jax.make_jaxpr(jb.fn)(*jb.args).jaxpr)
        want_total = jaxpr_cost(jb.fn, *jb.args)["flops"]
    got = flops.step_cost(tb)
    assert got["matmul_flops"] == want
    assert abs(got["flops"] - want_total) <= TOTAL_RTOL * want_total


def test_biencoder_matmul_flops_equal_the_reference_step():
    """The reference's bi-encoder bundle cannot be built (its
    ``biencoder_bundle`` names the parameter count ``P``, hiding the
    PartitionSpec it calls next); its ``_make_train_step`` on the smoke
    config is walked instead."""
    cfg = jreg.get_smoke_cfg("biencoder-msmarco")
    step, init = jsteps._make_train_step(partial(jsteps._be_loss, cfg=cfg), "adamw")
    params = jax.eval_shape(lambda: JB.init_biencoder(jax.random.PRNGKey(0), cfg))
    batch = {k: jax.ShapeDtypeStruct((8, 16), np.int32)
             for k in ("q_tokens", "q_mask", "d_tokens", "d_mask")}
    args = (params, jax.eval_shape(init, params), batch)
    want = dot_flops(jax.make_jaxpr(step)(*args).jaxpr)
    ts = registry.get_arch("biencoder-msmarco")
    ts = dataclasses.replace(ts, cfg=registry.get_smoke_cfg("biencoder-msmarco"),
                             shapes=(ShapeCell("smoke", "train", SMOKE["biencoder"]),))
    tb = steps.biencoder_bundle(ts, ts.shapes[0], make_mesh((1, 1), ("data", "model"), "meta"))
    got = flops.step_cost(tb)
    assert got["matmul_flops"] == want
    assert abs(got["flops"] - jaxpr_cost(step, *args)["flops"]) <= TOTAL_RTOL * got["flops"]


_REF_TOOLS = r"""
import contextlib, io, json, sys
from repro.launch import dryrun, hillclimb
from repro.configs.registry import make_step_bundle
from repro.launch.mesh import make_production_mesh
out = {}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    sys.argv = ["dryrun", "--list"]
    dryrun.main()
out["list"] = buf.getvalue()
out["hillclimb"] = {c: [v[0] for v in fn()] for c, fn in hillclimb.CELLS.items()}
mesh = make_production_mesh()
from repro.configs.steps import BUNDLE_BUILDERS
for name, _, spec, cell in hillclimb.CELLS["tt_retrieval"]():
    if name == "pca50_int8_live_delta":
        meta = BUNDLE_BUILDERS[spec.family](spec, cell, mesh).meta
        out["live_delta_meta"] = {k: meta[k] for k in ("model_flops", "analytic_bytes",
                                                        "delta_rows")}
for arch, shape in (("graphcast", "molecule"), ("two-tower-retrieval", "serve_p99")):
    b = make_step_bundle(arch, shape, mesh)
    with mesh:
        c = b.lower().compile()
    out[f"{arch}:{shape}"] = int(c.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


def ref_subprocess(code: str, devices: int = 512) -> dict:
    """Run ``code`` (printing one JSON line last) under the reference with
    ``devices`` forced host devices, as its dry run runs."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_tools():
    return ref_subprocess(_REF_TOOLS)


@pytest.mark.parametrize("arch,shape", [("graphcast", "molecule"),
                                        ("two-tower-retrieval", "serve_p99")])
def test_argument_bytes_equal_memory_analysis(ref_tools, arch, shape):
    """Per-device argument bytes on the (16, 16) pod: graphcast molecule
    (140,797,608: replicated parameters and batch, ZeRO-1 moments) and the
    two-tower's serve_p99 (row-sharded tables), the reference's compiled
    ``memory_analysis()``."""
    mesh = make_production_mesh()
    b = registry.make_step_bundle(arch, shape, mesh)
    assert flops.per_device_bytes(b.args, b.in_specs, mesh) == ref_tools[f"{arch}:{shape}"]
    if arch == "graphcast":
        assert ref_tools[f"{arch}:{shape}"] == 140_797_608


def test_per_device_bytes_rounds_uneven_shards_up():
    mesh = make_mesh((2, 3), ("data", "model"), "meta")
    from repro_torch.par.sharding import P
    args = ({"a": torch.empty((7, 4), device="meta"),
             "b": torch.empty((5,), dtype=torch.int8, device="meta")},)
    specs = ({"a": P(("data", "model"), None), "b": P("model")},)
    assert flops.per_device_bytes(args, specs, mesh) == 2 * 4 * 4 + 2


def test_dryrun_list_equals_the_reference(ref_tools, capsys):
    dryrun.main(["--list"])
    assert capsys.readouterr().out == ref_tools["list"]


def test_registry_cells_equal_the_reference():
    got = [(s.arch_id, c.name, c.skip_reason) for s, c in registry.cells()]
    want = [(s.arch_id, c.name, c.skip_reason) for s, c in jreg.cells()]
    assert got == want and len(got) == 40


def test_dryrun_records(tmp_path, capsys):
    """A record for each graphcast cell on both meshes, the reference's keys
    where the port has a counterpart, ``null`` where it has none (with the
    reason), and a skipped cell with the reference's reason."""
    counts = dryrun.main(["--arch", "graphcast", "--shape", "molecule", "--out", str(tmp_path)])
    assert counts == {"ok": 2}
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products"):
        dryrun.main(["--arch", "graphcast", "--shape", shape, "--mesh", "pod",
                     "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--mesh", "pod",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: 0 ok, 1 skipped, 0 errors" in out
    rec = json.load(open(tmp_path / "graphcast__molecule__pod.json"))
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory"] == {"argument_size_in_bytes": 140_797_608, "output_size_in_bytes": None,
                             "temp_size_in_bytes": None, "peak_memory_in_bytes": None}
    assert rec["compile_s"] is None and rec["collectives"] is None
    assert rec["memory_null_reason"] and rec["collectives_reason"].startswith("not counted")
    assert rec["meta"]["model_flops"] == 1_142_664_462_336
    assert rec["meta"]["analytic_bytes"] == 3_937_803_264
    assert abs(rec["accounting"]["global_flops"] - 1.519e12) <= 0.01 * 1.519e12
    multi = json.load(open(tmp_path / "graphcast__molecule__multipod.json"))
    assert multi["n_devices"] == 512 and multi["accounting"] == rec["accounting"]
    big = json.load(open(tmp_path / "graphcast__ogb_products__pod.json"))
    assert big["meta"]["n_edges"] == 61_859_328        # round_up(E, 512)
    skip = json.load(open(tmp_path / "qwen2-1.5b__long_500k__pod.json"))
    assert skip["status"] == "skipped"
    assert skip["reason"] == jreg.get_arch("qwen2-1.5b").cell("long_500k").skip_reason


def test_dryrun_records_a_failing_cell_with_its_op(tmp_path, monkeypatch):
    real = steps.gnn_bundle

    def broken(spec_, cell, mesh):
        b = real(spec_, cell, mesh)
        return dataclasses.replace(b, fn=lambda model, opt, batch, t=0: batch["nodes"].sum().item())

    monkeypatch.setitem(steps.BUNDLE_BUILDERS, "gnn", broken)
    rec = dryrun.run_cell("graphcast", "molecule", "pod", str(tmp_path))
    assert rec["status"] == "error" and rec["op"] == "aten._local_scalar_dense.default"
    assert "meta" in rec["error"]


def _fake(arch="x", shape="s", mesh="pod", flops_=989e12 * 256 * 2.0, bytes_=3.35e12 * 256,
          model_flops=989e12 * 256):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok", "n_devices": 256,
            "accounting": {"global_flops": flops_}, "memory": {"temp_size_in_bytes": None},
            "meta": {"analytic_bytes": bytes_, "model_flops": model_flops}}


def test_roofline_uses_h100_datasheet_terms():
    """2 s of bf16 work and 1 s of HBM traffic a chip on 256 chips:
    compute-bound at 2 s, half of it useful, collective not counted."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    a = roofline.analyse(_fake())
    assert a["t_compute_s"] == pytest.approx(2.0) and a["t_memory_s"] == pytest.approx(1.0)
    assert a["dominant"] == "compute" and a["step_time_s"] == pytest.approx(2.0)
    assert a["t_collective_s"] is None and a["useful_ratio"] == pytest.approx(0.5)
    assert a["roofline_fraction"] == pytest.approx(0.5)
    b = roofline.analyse(_fake(bytes_=3.35e12 * 256 * 4))
    assert b["dominant"] == "memory" and b["step_time_s"] == pytest.approx(4.0)
    assert roofline.analyse({"status": "skipped"}) is None
    table = roofline.fmt_table([a])
    assert "| not counted |" in table and "| — |" in table
    assert not {"197e12", "819e9", "50e9"} & set(open(roofline.__file__).read().split())


def test_report_and_reaccount(tmp_path, capsys):
    art = tmp_path / "dry"
    dryrun.main(["--arch", "graphcast", "--shape", "full_graph_sm", "--mesh", "pod",
                 "--out", str(art)])
    dryrun.main(["--arch", "arctic-480b", "--shape", "long_500k", "--mesh", "pod",
                 "--out", str(art)])
    json.dump({"arch": "z", "shape": "s", "mesh": "pod", "status": "error",
               "error": "RuntimeError: boom", "op": "aten.nonzero.default"},
              open(art / "z__s__pod.json", "w"))
    path = art / "graphcast__full_graph_sm__pod.json"
    rec = json.load(open(path))
    good = rec["accounting"]
    rec["accounting"] = {"global_flops": 1.0, "global_bytes": 1.0, "matmul_flops": 1.0}
    json.dump(rec, open(path, "w"))
    assert reaccount.main(["--dir", str(art)]) == 1
    assert json.load(open(path))["accounting"] == good
    capsys.readouterr()
    text = report.main(["--dir", str(art), "--hillclimb-dir", str(tmp_path / "hc")])
    assert "| graphcast | full_graph_sm | pod | ok | 0.15 | — | — | — |" in text
    assert "| arctic-480b | long_500k | pod | SKIP |" in text
    assert "ERROR | — | — | — | — | at aten.nonzero.default: RuntimeError: boom" in text
    assert "| not counted |" in text and "H100 SXM datasheet" in text


def test_hillclimb_variants_equal_the_reference_and_one_is_measured(ref_tools, tmp_path):
    assert {c: [v[0] for v in fn()] for c, fn in hillclimb.CELLS.items()} == ref_tools["hillclimb"]
    for fn in hillclimb.CELLS.values():
        for _, hypothesis, _, _ in fn():
            assert not any(t in hypothesis for t in ("TPU", "ICI", "VMEM", "HBM"))
    log = hillclimb.main(["--cell", "tt_retrieval", "--only", "pca50_int8_128",
                          "--out", str(tmp_path)])
    (m,) = log
    assert m["status"] == "ok" and m["dominant"] == "memory" and m["t_collective_s"] is None
    # C x 128 int8 bytes (+ 2 ‰ of the parameters) over 256 chips' HBM
    assert m["t_memory_s"] == pytest.approx((1_000_448 * 128 + 2 * registry.get_arch(
        "two-tower-retrieval").cfg.param_count() // 1000) / (256 * 3.35e12))
    assert json.load(open(tmp_path / "tt_retrieval_pod.json"))[0]["variant"] == "pca50_int8_128"


def test_hillclimb_live_delta_variant_is_ok_with_the_reference_meta(ref_tools, tmp_path):
    """The live-delta variant counts on meta: its live count reaches the
    delta's top-k as a 0-d tensor, with no host read, as the reference
    traces it. Its meta equals the reference bundle's."""
    log = hillclimb.main(["--cell", "tt_retrieval", "--only", "pca50_int8_live_delta",
                          "--out", str(tmp_path)])
    (m,) = log
    assert m["status"] == "ok", m.get("error")
    assert m["model_flops"] == ref_tools["live_delta_meta"]["model_flops"]
    for name, _, spec, cell in hillclimb.tt_retrieval_variants():
        if name == "pca50_int8_live_delta":
            meta = steps.BUNDLE_BUILDERS[spec.family](spec, cell, make_production_mesh()).meta
    assert {k: meta[k] for k in ref_tools["live_delta_meta"]} == ref_tools["live_delta_meta"]


# ---------------------------------------------------------------------------
# the shape-static paths the dry run counts through
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_rowwise_static_path_equals_the_real_path(seed):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(50, 8, generator=g)
    acc = torch.rand(50, generator=g)
    idx = torch.randint(0, 12, (40,), generator=g).int()
    g_rows = torch.randn(40, 8, generator=g)
    t1, a1 = rowwise.rowwise_adagrad_update(table.clone(), acc.clone(), idx, g_rows, 1e-2,
                                            static=False)
    t2, a2 = rowwise.rowwise_adagrad_update(table.clone(), acc.clone(), idx, g_rows, 1e-2,
                                            static=True)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_decode_position_as_tensor_matches_prefill(arch):
    """The decode steps take the position as an int or a 0-d tensor (no host
    read, so the dry run counts them on meta) and write the cache slot that
    a prefill one token longer writes."""
    cfg = registry.get_smoke_cfg(arch)
    model = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    _, cache = T.prefill(model, toks[:, :16], cache_len=40)
    want_logits, want = T.prefill(model, toks, cache_len=40)
    a, ca = T.decode_step(model, tuple(x.clone() for x in cache), toks[:, 16], 16)
    b, cb = T.decode_step(model, tuple(x.clone() for x in cache), toks[:, 16],
                          torch.tensor(16))
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ca, cb))
    torch.testing.assert_close(a, want_logits, rtol=1e-5, atol=1e-5)
    for x, y in zip(ca, want):
        torch.testing.assert_close(x[:, :, :17], y[:, :, :17], rtol=1e-5, atol=1e-5)
    if cfg.sliding_window:
        W, pos = cfg.sliding_window, 21
        rc = tuple(c[:, :, :W].clone() for c in cache)
        a, ca = T.decode_step_sliding(model, tuple(x.clone() for x in rc), toks[:, 0], pos)
        b, cb = T.decode_step_sliding(model, tuple(x.clone() for x in rc), toks[:, 0],
                                      torch.tensor(pos))
        assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ca, cb))
