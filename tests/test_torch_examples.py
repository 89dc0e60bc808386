"""The port's four examples (``repro_torch.examples``) against the
reference's scripts (``examples/``), on the CPU.

Each port example runs as ``python -m repro_torch.examples.<name> --device
cpu`` and each reference script with ``JAX_PLATFORMS=cpu``, all under
``PYTHONHASHSEED=0`` (``make_dataset`` keys its generators on
``hash(str)``), started together. Printed metric lines agree within 1e-4
with their text, integers and † marks equal; quickstart prints the values
the reference prints at that hash seed. serve_retrieval's timing lines are
compared by format only, and its served answers are held in-process to a
direct search (ids equal). train_biencoder is run in-process from the
reference's ``init_biencoder(PRNGKey(0), cfg)`` weights: 4 steps give the
reference step's losses within 1e-4 and the reference script's lines.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro.models import biencoder as JB
from repro.optim import adamw as JA, schedule as JS
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.synthetic import make_dataset
from repro_torch.examples import quickstart, serve_retrieval, train_biencoder
from repro_torch.launch import encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASH_SEED = "0"
TOL = 1e-4
TRAIN_STEPS = 4
NUM = re.compile(r"[-+]?\d+\.\d+")
# what quickstart prints at PYTHONHASHSEED=0 (the reference's own run)
QUICKSTART_AT_SEED_0 = {"nDCG@10": (0.8455, 0.8515), "AP": (0.2113, 0.2125)}
TIMING_LINES = (r"\d+ queries from 8 concurrent clients in \d+\.\d\ds \(\d+ qps\)",
                r"latency p50=\d+\.\dms p95=\d+\.\dms p99=\d+\.\dms")


def _env():
    """One thread a run (eight run at once) and one JAX device (not the
    suite's forced four), the hash seed pinned."""
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONHASHSEED": HASH_SEED, "JAX_PLATFORMS": "cpu",
            "PYTHONIOENCODING": "utf-8", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
            "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
            "PYTHONPATH": src if not path else src + os.pathsep + path}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Every example run, started with the module so that they run beside
    its in-process tests; ``runs(name)`` waits for one and returns its
    stdout (it must exit 0)."""
    ck = tmp_path_factory.mktemp("ckpt")
    argv = {
        ("ref", "quickstart"): [os.path.join(ROOT, "examples", "quickstart.py")],
        ("ref", "ood_transfer"): [os.path.join(ROOT, "examples", "ood_transfer.py")],
        ("ref", "serve_retrieval"): [os.path.join(ROOT, "examples", "serve_retrieval.py")],
        ("ref", "train_biencoder"): [os.path.join(ROOT, "examples", "train_biencoder.py"),
                                     "--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ck / "ref")],
        **{("port", name): ["-m", f"repro_torch.examples.{name}", "--device", "cpu"]
           for name in ("quickstart", "ood_transfer", "serve_retrieval")},
        ("port", "train_biencoder"): ["-m", "repro_torch.examples.train_biencoder", "--device",
                                      "cpu", "--steps", str(TRAIN_STEPS), "--ckpt-dir",
                                      str(ck / "port")],
    }
    procs = {key: subprocess.Popen([sys.executable, *a], cwd=ROOT, env=_env(),
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True, encoding="utf-8") for key, a in argv.items()}
    done = {}

    def get(key):
        if key not in done:
            out, err = procs[key].communicate(timeout=900)
            assert procs[key].returncode == 0, (key, err[-3000:])
            done[key] = out
        return done[key]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # the in-process runs beside the eight
    try:
        yield get
    finally:
        torch.set_num_threads(threads)
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _assert_metric_lines_match(want: str, got: str):
    wl, gl = want.strip().splitlines(), got.strip().splitlines()
    assert len(wl) == len(gl), (wl, gl)
    for w, g in zip(wl, gl):
        assert NUM.sub("#", w) == NUM.sub("#", g), (w, g)     # text, ints, † marks
        for a, b in zip(NUM.findall(w), NUM.findall(g)):
            assert abs(float(a) - float(b)) <= TOL, (w, g)


def test_served_answers_equal_a_direct_search(capsys):
    ds = make_dataset("ance", n_docs=1500, d=64, query_sets=("dl19",))
    out = serve_retrieval.serve_retrieval(ds, clients=4, per_client=6, device="cpu")
    assert len(out["replies"]) == 24 and len(out["latencies_ms"]) == 24
    W, mean = out["pruner"].projection()
    Q = torch.as_tensor(ds.queries["dl19"])
    for row, scores, ids in out["replies"]:
        s, i = out["index"].search_projected(Q[row:row + 1], W, k=10, mean=mean)
        np.testing.assert_array_equal(np.asarray(ids), i[0].numpy())
        np.testing.assert_allclose(np.asarray(scores), s[0].numpy(), rtol=1e-5, atol=1e-5)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "serving 1500 docs at 32 dims (0.2 MiB)"
    assert re.fullmatch(TIMING_LINES[0].replace("8 concurrent", "4 concurrent"), lines[1])


def _reference_losses(params, jc, steps, batch, seq_len):
    """examples/train_biencoder.py's jitted step, ``steps`` times."""
    opt = JA.adamw_init(params)
    lr_fn = JS.warmup_cosine(3e-4, steps // 10, steps)

    @jax.jit
    def step(p, o, b, t):
        loss, g = jax.value_and_grad(JB.contrastive_loss)(p, b, jc)
        p, o = JA.adamw_update(g, o, p, lr_fn(t))
        return p, o, loss

    losses = []
    for t in range(steps):
        b = jtokens.pair_batch(0, t, batch=batch, seq_len=seq_len, vocab=jc.vocab)
        params, opt, loss = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()}, t)
        losses.append(float(loss))
    return losses


def test_train_biencoder_from_the_reference_init(runs, tmp_path, capsys):
    cfg = encode.SMALL_CFG
    jc = JB.BiEncoderConfig(**dataclasses.asdict(cfg))
    params = JB.init_biencoder(jax.random.PRNGKey(0), jc)
    model = convert.biencoder_from_numpy(jax.device_get(params), cfg, device="cpu")
    args = train_biencoder.parse_args(["--device", "cpu", "--steps", str(TRAIN_STEPS),
                                       "--ckpt-dir", str(tmp_path)])
    res = train_biencoder.train_biencoder(args, model=model)
    np.testing.assert_allclose(res.losses, _reference_losses(params, jc, TRAIN_STEPS, 32, 24),
                               rtol=0, atol=TOL)
    _assert_metric_lines_match(runs(("ref", "train_biencoder")), capsys.readouterr().out)


def test_train_biencoder_trains_from_step_0_over_a_checkpoint(tmp_path, monkeypatch, capsys):
    """The reference script never restores: a second run over the same
    ``--ckpt-dir`` (now holding checkpoints) trains its steps again."""
    monkeypatch.setattr(encode, "CKPT_EVERY", 2)
    argv = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq-len", "6",
            "--ckpt-dir", str(tmp_path)]
    first = train_biencoder.main(argv)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    again = train_biencoder.main(argv)
    assert again.losses == first.losses and len(again.losses) == 4
    assert "resumed" not in capsys.readouterr().out


@pytest.mark.parametrize("module", [quickstart, serve_retrieval, train_biencoder])
def test_examples_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="'cuda'"):
        module.main(["--steps", "1"] if module is train_biencoder else [])


# the subprocesses, waited for last


@pytest.mark.parametrize("name", ["quickstart", "ood_transfer"])
def test_example_prints_the_reference_metrics(runs, name):
    _assert_metric_lines_match(runs(("ref", name)), runs(("port", name)))


def test_quickstart_prints_the_known_values(runs):
    lines = runs(("port", "quickstart")).splitlines()
    for metric, (base, pruned) in QUICKSTART_AT_SEED_0.items():
        line = next(ln for ln in lines if ln.startswith(metric + " "))
        assert f"baseline {base:.4f} | 50%-pruned {pruned:.4f}" in line, line


def test_ood_transfer_marks_significance_as_the_reference(runs):
    marks = [[ln.count("†")] for ln in runs(("port", "ood_transfer")).splitlines()]
    assert marks == [[ln.count("†")] for ln in runs(("ref", "ood_transfer")).splitlines()]


def test_serve_retrieval_lines(runs):
    want, got = runs(("ref", "serve_retrieval")), runs(("port", "serve_retrieval"))
    w, g = want.strip().splitlines(), got.strip().splitlines()
    assert g[0] == w[0] == "serving 20000 docs at 256 dims (19.5 MiB)"
    for pattern, wl, gl in zip(TIMING_LINES, w[1:], g[1:], strict=True):
        assert re.fullmatch(pattern, wl) and re.fullmatch(pattern, gl), (wl, gl)


def test_train_biencoder_cli_lines(runs):
    lines = runs(("port", "train_biencoder")).strip().splitlines()
    assert lines[:3] == ["[biencoder] 1.3M params", "[encode] corpus of 2000 docs",
                         "[prune] 128 -> 64 dims (0.98 -> 0.49 MiB)"]
    assert re.fullmatch(r"\[serve\] MRR@10 full=\d\.\d{4} pruned=\d\.\d{4}", lines[3])
