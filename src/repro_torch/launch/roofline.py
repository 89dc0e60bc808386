"""Roofline analysis over the port's dry-run records, with the NVIDIA H100
SXM's datasheet figures (port of ``repro/launch/roofline.py``).

Two terms per (arch × shape × mesh), in seconds a step, with ``chips`` the
record's ``n_devices`` (the production mesh's 256 or 512 slots, each
taken as an H100):

  compute = global_FLOPs / (chips × 989e12)      [bf16 dense, datasheet]
  memory  = analytic_HBM_bytes / (chips × 3.35e12)   [HBM3, datasheet]

and the bound is the larger. The reference adds a third, per-device
collective bytes over a link's bandwidth; the port partitions no program,
so it has no collective bytes to count: ``t_collective_s`` is ``None`` and
the table says "not counted". ``LINK_BW`` (NVLink, one direction, the
datasheet's 900 GB/s split in two) is kept for the day it is.

  * global_FLOPs: ``launch.flops.step_cost`` (every layer, remat recompute
    included);
  * HBM bytes: the bundle's analytic per-family model (``meta``); the
    op-level byte proxy is recorded beside it as an upper bound.

These are datasheet figures, not measurements.

Usage: python -m repro_torch.launch.roofline [--dir build/experiments/dryrun] [--mesh pod]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense tensor-core FLOP/s (datasheet)
HBM_BW = 3.35e12         # H100 SXM, HBM3 bytes/s (datasheet)
LINK_BW = 450e9          # H100 SXM, NVLink bytes/s in one direction (datasheet)
DEFAULT_DIR = os.path.join("build", "experiments", "dryrun")


def load_records(art_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def analyse(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    flops = rec["accounting"]["global_flops"]
    mem_bytes = rec["meta"].get("analytic_bytes") or 0
    t_compute = flops / (chips * PEAK_FLOPS)
    t_memory = mem_bytes / (chips * HBM_BW)
    terms = {"compute": t_compute, "memory": t_memory}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    model_flops = rec["meta"].get("model_flops") or 0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": None,
        "dominant": dominant, "step_time_s": step_time,
        "model_flops": model_flops, "hlo_flops": flops,
        "useful_ratio": (model_flops / flops) if flops else 0.0,
        "roofline_fraction": ((model_flops / step_time) / (chips * PEAK_FLOPS)
                              if step_time else 0.0),
        "temp_gib": None,
        "compile_s": rec.get("compile_s"),
    }


def _num(v, fmt: str) -> str:
    return "—" if v is None else format(v, fmt)


def fmt_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful (model/counted) | roofline frac | temp GiB |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        coll = "not counted" if r["t_collective_s"] is None else f"{r['t_collective_s']:.3e}"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {coll} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']*100:.1f}% "
            f"| {_num(r['temp_gib'], '.1f')} |")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    rows = []
    for rec in load_records(args.dir):
        if args.mesh and rec.get("mesh") != args.mesh:
            continue
        a = analyse(rec)
        if a:
            rows.append(a)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print(fmt_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
