"""Refresh the accounting of existing dry-run records (port of
``repro/launch/reaccount.py``): each ``ok`` record's ``accounting`` and
``meta`` are counted again from the current code (``launch.flops``), the
rest of the record is kept.

  PYTHONPATH=src python -m repro_torch.launch.reaccount [--dir build/experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT, _json_meta


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import make_step_bundle
    from repro_torch.launch.flops import step_cost
    from repro_torch.launch.mesh import make_production_mesh

    meshes = {"pod": make_production_mesh(),
              "multipod": make_production_mesh(multi_pod=True)}
    n_ok = 0
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        try:
            bundle = make_step_bundle(rec["arch"], rec["shape"], meshes[rec["mesh"]])
            acc = step_cost(bundle)
            rec["accounting"] = {"global_flops": acc["flops"], "global_bytes": acc["bytes"],
                                 "matmul_flops": acc["matmul_flops"]}
            rec["meta"] = _json_meta(bundle.meta)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            n_ok += 1
            print(f"ok   {rec['arch']:24s} {rec['shape']:14s} {rec['mesh']:8s} "
                  f"flops={acc['flops']:.3e}")
        except Exception as e:
            print(f"FAIL {path}: {type(e).__name__}: {e}")
    return n_ok


if __name__ == "__main__":
    main()
