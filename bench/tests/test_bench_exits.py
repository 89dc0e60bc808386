"""The command fails, printing no result, where it must."""
from __future__ import annotations

import shutil
import subprocess
import sys

from bench.tests.conftest import ROOT


def run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "BENCH_RUN": "x"})


def test_without_a_card_it_exits_2_and_prints_nothing(cuda_absent):
    out = run(ROOT, "--workload", "msmarco-f32.open-k10", "--seed", "5", "--seconds", "1",
              "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, "--workload", "msmarco-f32.open-k10", "--seed", "5", "--seconds", "1",
              "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    code = ("import sys, torch; sys.path[:0] = ['.']; from bench import harness; "
            "harness.run_cell('msmarco-f32.open-k10', 5, 1.0, False, "
            "device=torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "No module named 'repro_torch'" in out.stderr


def test_an_unknown_cell_fails():
    out = run(ROOT, "--workload", "no-such-cell", "--seed", "5", "--seconds", "1",
              "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
