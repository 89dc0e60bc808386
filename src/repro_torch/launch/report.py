"""The dry-run, roofline and hillclimb tables from the port's records (port
of ``repro/launch/report.py``), "—" where a field is ``null``.

  PYTHONPATH=src python -m repro_torch.launch.report > build/experiments/report.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.roofline import analyse, fmt_table, load_records

DEFAULT_HC = os.path.join("build", "experiments", "hillclimb")


def _gib(v) -> str:
    return "—" if v is None else f"{v / 2**30:.2f}"


def dryrun_table(art_dir: str = DEFAULT_OUT) -> str:
    rows = []
    for rec in load_records(art_dir):
        head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
        if rec.get("status") == "skipped":
            rows.append(f"{head} SKIP | — | — | — | — | {rec['reason'][:70]} |")
            continue
        if rec.get("status") != "ok":
            rows.append(f"{head} ERROR | — | — | — | — | at {rec.get('op')}: "
                        f"{rec.get('error', '')[:70]} |")
            continue
        mem = rec.get("memory", {})
        coll = rec.get("collectives")
        rows.append(
            f"{head} ok | {_gib(mem.get('argument_size_in_bytes'))} | "
            f"{_gib(mem.get('temp_size_in_bytes'))} | "
            f"{'—' if coll is None else _gib(coll.get('total_bytes'))} | "
            f"{'—' if rec.get('compile_s') is None else format(rec['compile_s'], '.0f')} | "
            f"{rec['accounting']['global_flops']:.3e} FLOP |")
    hdr = ("| arch | shape | mesh | status | args GiB/dev | temp GiB/dev | collective "
           "GiB/dev/step | compile s | note |\n" + "|" + "---|" * 9)
    return hdr + "\n" + "\n".join(sorted(rows))


def hillclimb_tables(hc_dir: str = DEFAULT_HC) -> str:
    out = []
    for path in sorted(glob.glob(os.path.join(hc_dir, "*.json"))):
        cell = os.path.basename(path).replace(".json", "")
        with open(path) as f:
            log = json.load(f)
        out.append(f"\n#### {cell}\n")
        out.append("| variant | hypothesis | compute s | memory s | "
                   "collective s | dominant | step s | vs baseline |")
        out.append("|" + "---|" * 8)
        base = next((e for e in log if e["status"] == "ok"), None)
        for e in log:
            if e["status"] != "ok":
                out.append(f"| {e['variant']} | {e['hypothesis'][:60]} | "
                           f"ERROR {e.get('error', '')[:40]} |||||||")
                continue
            speed = (base["step_time_s"] / e["step_time_s"]
                     if base and e["step_time_s"] else 0)
            coll = e.get("t_collective_s")
            out.append(
                f"| {e['variant']} | {e['hypothesis'][:60]}… | "
                f"{e['t_compute_s']:.2e} | {e['t_memory_s']:.2e} | "
                f"{'not counted' if coll is None else format(coll, '.2e')} | "
                f"{e['dominant']} | {e['step_time_s']:.2e} | {speed:.2f}x |")
    return "\n".join(out)


def report(art_dir: str = DEFAULT_OUT, hc_dir: str = DEFAULT_HC) -> str:
    recs = load_records(art_dir)
    parts = ["## Dry run (all cells × both meshes)\n", dryrun_table(art_dir)]
    for mesh, title in (("pod", "single pod, 256 slots"), ("multipod", "two pods, 512 slots")):
        rows = sorted((a for a in map(analyse, recs) if a and a["mesh"] == mesh),
                      key=lambda r: (r["arch"], r["shape"]))
        parts += [f"\n## Roofline ({title}, H100 SXM datasheet)\n", fmt_table(rows)]
    parts += ["\n## Hillclimb logs\n", hillclimb_tables(hc_dir)]
    return "\n".join(parts)


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--hillclimb-dir", default=DEFAULT_HC)
    args = ap.parse_args(argv)
    text = report(args.dir, args.hillclimb_dir)
    print(text)
    return text


if __name__ == "__main__":
    main()
