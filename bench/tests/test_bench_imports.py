"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: by whole top-level names."""
from __future__ import annotations

import shutil
import subprocess
import sys

from bench import imports_check
from bench.tests.conftest import ROOT


def test_bench_imports_no_jax_and_the_reference_no_program():
    assert imports_check.scan(ROOT / "bench") == []
    names = imports_check.imported(ROOT / "bench" / "reference.py")
    assert names <= {"__future__", "torch"}


def test_a_planted_import_is_caught(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "sneaky.py").write_text("import jax.numpy as jnp\n")
    (bench / "reference.py").write_text(
        (bench / "reference.py").read_text() + "\nfrom repro_torch.core import pca\n")
    (bench / "data.py").write_text((bench / "data.py").read_text() + "\nimport repro\n")
    found = imports_check.scan(bench)
    assert any("sneaky.py: imports jax" in f for f in found)
    assert any("reference.py: imports repro_torch" in f for f in found)
    assert any("data.py: imports repro" in f and "repro_torch" not in f for f in found)


def test_program_names_are_compared_whole():
    # repro_torch begins with repro's name but is not it
    code = ("import sys; sys.path[:0] = [%r, %r]; import repro_torch; "
            "from bench import imports_check; print(imports_check.loaded())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    code = ("import sys; sys.modules['jaxlib'] = sys; sys.path[:0] = [%r]; "
            "from bench import imports_check; print(imports_check.loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "['jaxlib']"
