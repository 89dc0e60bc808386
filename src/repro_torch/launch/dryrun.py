"""Dry run of every (arch × shape × mesh) cell on meta tensors (port of
``repro/launch/dryrun.py``).

Each cell's step bundle is built on the production mesh (16 × 16, or
2 × 16 × 16 under ``multipod``) and its step is run once on the meta
device at the cell's global shapes (``launch.flops.step_cost``): nothing
is allocated, and a step that cannot take those shapes fails here.

Per cell the JSON record holds, under the reference's keys where the port
has a counterpart:
  * ``status`` (``ok``, ``skipped`` with the reference's ``reason``, or
    ``error`` with the exception and ``op``, the aten op it stopped in);
  * ``n_devices``: the mesh's slots;
  * ``accounting``: global FLOPs (and the products' share) and the byte
    proxy from ``step_cost``;
  * ``meta``: the bundle's analytic model FLOPs, bytes, parameters, dims;
  * ``memory.argument_size_in_bytes``: the per-device bytes of the
    bundle's arguments under its ``in_specs`` (uneven shards rounded up);
    ``output``, ``temp`` and ``peak`` bytes are ``null``: the port compiles
    no partitioned program to ask (``memory_null_reason`` says so);
  * ``compile_s`` ``null`` (nothing is compiled) and ``collectives``
    ``null`` (no partitioned program: not counted), each with its reason.

Usage:
  python -m repro_torch.launch.dryrun --all --jobs 4         # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch graphcast --shape molecule --mesh pod
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from collections import Counter
from concurrent.futures import ProcessPoolExecutor

DEFAULT_OUT = os.path.join("build", "experiments", "dryrun")
NO_PROGRAM = ("the port runs the step eagerly and compiles no partitioned program, so "
              "there is no memory analysis to read")
NO_COMPILE = "nothing is compiled: the step runs on meta tensors"
NO_COLLECTIVES = ("not counted: the port partitions no program, so there are no "
                  "per-device collectives")


def _json_meta(meta: dict) -> dict:
    return json.loads(json.dumps(meta, default=str))


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str,
             force: bool = False) -> dict:
    from repro_torch.configs.registry import get_arch, make_step_bundle
    from repro_torch.launch.flops import per_device_bytes, step_cost
    from repro_torch.launch.mesh import make_production_mesh

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cell = get_arch(arch).cell(shape)
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "status": None, "timestamp": time.time()}
    if cell.skip_reason:
        record.update(status="skipped", reason=cell.skip_reason)
    else:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        t0 = time.time()
        try:
            bundle = make_step_bundle(arch, shape, mesh)
            acc = step_cost(bundle)
            record.update(
                status="ok", count_s=round(time.time() - t0, 2),
                compile_s=None, compile_null_reason=NO_COMPILE,
                n_devices=mesh.size,
                memory={"argument_size_in_bytes": per_device_bytes(
                            bundle.args, bundle.in_specs, mesh),
                        "output_size_in_bytes": None, "temp_size_in_bytes": None,
                        "peak_memory_in_bytes": None},
                memory_null_reason=NO_PROGRAM,
                collectives=None, collectives_reason=NO_COLLECTIVES,
                accounting={"global_flops": acc["flops"], "global_bytes": acc["bytes"],
                            "matmul_flops": acc["matmul_flops"]},
                meta=_json_meta(bundle.meta))
        except Exception as e:  # a failed cell is recorded loudly, with its op
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          op=getattr(e, "last_op", None),
                          traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv: list[str] | None = None) -> Counter:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in a process of its own")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import cells

    if args.list:
        for spec, cell in cells():
            skip = f"  [SKIP: {cell.skip_reason}]" if cell.skip_reason else ""
            print(f"{spec.arch_id:24s} {cell.name:16s} {cell.kind:14s}{skip}")
        return Counter()

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(spec.arch_id, cell.name, m) for spec, cell in cells() for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all / --list)")
        todo = [(args.arch, args.shape, m) for m in meshes]

    counts: Counter = Counter()
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            recs = list(ex.map(run_cell, *zip(*todo), [args.out] * len(todo),
                               [args.force] * len(todo)))
    else:
        recs = (run_cell(arch, shape, m, args.out, force=args.force) for arch, shape, m in todo)
    for (arch, shape, m), rec in zip(todo, recs):
        counts[rec["status"]] += 1
        if rec["status"] == "ok":
            print(f"OK    {arch:24s} {shape:14s} {m:8s} "
                  f"args={rec['memory']['argument_size_in_bytes'] / 2**30:7.2f}GiB/dev "
                  f"flops={rec['accounting']['global_flops']:.3e} "
                  f"count={rec['count_s']:.1f}s")
        elif rec["status"] == "skipped":
            print(f"SKIP  {arch:24s} {shape:14s} {m:8s} {rec['reason'][:60]}")
        else:
            print(f"ERROR {arch:24s} {shape:14s} {m:8s} at {rec['op']}: {rec['error'][:120]}")
    print(f"\ndone: {counts['ok']} ok, {counts['skipped']} skipped, {counts['error']} errors")
    return counts


if __name__ == "__main__":
    main()
