"""Hillclimb driver — named variants for the reference's four chosen cells
(port of ``repro/launch/hillclimb.py``: the same variant sets, names and
overrides).

Each variant is a (hypothesis, change) pair; ``measure`` counts its step on
meta tensors (``launch.flops.step_cost``), takes the roofline terms with
the H100 SXM's datasheet figures (``launch.roofline``; the collective
term is not counted: the port partitions no program) and the per-device
argument bytes, and the result is appended to
``build/experiments/hillclimb/<cell>_<mesh>.json``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell tt_retrieval
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell arctic_train
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell dlrm_train
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell smollm_train
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

DEFAULT_OUT = os.path.join("build", "experiments", "hillclimb")


def measure(bundle, mesh) -> dict:
    from repro_torch.launch.flops import per_device_bytes, step_cost
    t0 = time.time()
    acc = step_cost(bundle)
    chips = mesh.size
    flops = acc["flops"]
    mem_bytes = bundle.meta.get("analytic_bytes") or 0
    t_compute = flops / (chips * PEAK_FLOPS)
    t_memory = mem_bytes / (chips * HBM_BW)
    terms = dict(compute=t_compute, memory=t_memory)
    dom = max(terms, key=terms.get)
    model_flops = bundle.meta.get("model_flops") or 0
    step = max(terms.values())
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": None, "dominant": dom, "step_time_s": step,
        "roofline_fraction": (model_flops / step) / (chips * PEAK_FLOPS) if step else 0.0,
        "collective_bytes_dev": None,
        "argument_gib": per_device_bytes(bundle.args, bundle.in_specs, mesh) / 2**30,
        "temp_gib": None,
        "global_flops": flops, "matmul_flops": acc["matmul_flops"],
        "model_flops": model_flops, "count_s": round(time.time() - t0, 1),
    }


def tt_retrieval_variants():
    """Paper cell: 1 query vs 1M candidates. Dominant term = index stream."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch("two-tower-retrieval")
    cell = spec.cell("retrieval_cand")

    def variant(name, hypothesis, **dims):
        c = dataclasses.replace(cell, dims={**cell.dims, **dims})
        return name, hypothesis, spec, c

    return [
        variant("baseline_f32_256",
                "the index stream (C x 256 x 4 B) dominates; the top-k merge is "
                "a few k-long lists a slot and secondary"),
        variant("pca50_f32_128",
                "PAPER: m = d/2 halves the streamed bytes -> memory term / 2; "
                "quality cost < 5% nDCG (benchmarks Table 1)",
                index_dim=128),
        variant("pca50_int8_128",
                "BEYOND PAPER: int8 index on the rotated basis -> bytes / 4 "
                "again (8x total); the scale folds into q-hat so the scan kernel "
                "is unchanged; expect the merge to weigh more",
                index_dim=128, int8=1),
        variant("pca75_int8_64",
                "BEYOND PAPER: 75% cutoff (paper: robust for low-rank "
                "encoders) + int8 -> 16x fewer bytes than baseline",
                index_dim=64, int8=1),
        variant("pca50_int8_hier_merge",
                "after compression the flat all-slot top-k merge weighs most: "
                "a two-stage merge (model axis, then dp) gathers (|model| + "
                "|dp|) x k candidates a slot instead of |slots| x k",
                index_dim=128, int8=1, hier_merge=1),
        variant("pca75_int8_hier_merge",
                "compose 75% PCA + int8 + hierarchical merge: the terms come "
                "within a small factor of each other (balanced design)",
                index_dim=64, int8=1, hier_merge=1),
        variant("pca50_int8_live_delta",
                "LIVE INDEX: sharded immutable base + one replicated open "
                "delta (8k rows, own scale, live count) merged via "
                "merge_segment_topk — the delta scan is 8k x m extra streamed "
                "bytes (< 1% of the base) and the merge adds one small "
                "replicated top-k: live appends should be ~free at serve "
                "time",
                index_dim=128, int8=1, delta_rows=8192),
    ]


def arctic_train_variants():
    """The reference's most collective-bound cell: FSDP weight re-gathers x
    microbatches."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch("arctic-480b")
    cell = spec.cell("train_4k")

    def variant(name, hypothesis, **cfg_over):
        s = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **cfg_over))
        return name, hypothesis, s, cell

    return [
        variant("baseline_mb16",
                "FSDP gathers weights per layer per microbatch x 3 passes "
                "(fwd / bwd / remat): collective ~ 16 mb x 35 L x a layer's weights"),
        variant("mb8",
                "halve microbatches -> FSDP re-gather bytes / 2; activation "
                "memory x 2",
                microbatch=8),
        variant("mb4",
                "quarter microbatches -> collective / 4 vs baseline; "
                "activations x 4 — check memory headroom",
                microbatch=4),
        variant("mb4_group1024",
                "larger MoE dispatch groups cut all-to-all count per layer "
                "(same bytes, fewer launches); dispatch transient x 2",
                microbatch=4, moe_group_size=1024),
        variant("cf1.0",
                "if the collective is mb-invariant it is dominated by EP-side "
                "expert_in gathers over the FSDP-sharded ff dim: shrink the "
                "gathered buffer directly: capacity_factor 1.25 -> 1.0 cuts "
                "C = 10 -> 8 per group",
                capacity_factor=1.0),
        variant("cf1.0_mb8",
                "compose the capacity cut with mb8 (mb8 still halves the "
                "activation-side TP all-reduces even if expert gathers are "
                "invariant)",
                capacity_factor=1.0, microbatch=8),
        variant("moe_dp_d_model",
                "STRUCTURAL: FSDP-shard expert d_model instead of ff. The "
                "expert GEMMs then contract / produce the dp-sharded dim, so "
                "cross-dp traffic becomes (E_loc, G_loc, C, ff) partial-sum "
                "psums + (…, d) gathers instead of gathering the dispatched "
                "activations",
                capacity_factor=1.0, moe_dp_dim="d_model"),
        variant("moe_dp_d_model_mb8",
                "compose the structural fix with mb8 to also halve the "
                "remaining activation-side TP collectives",
                capacity_factor=1.0, moe_dp_dim="d_model", microbatch=8),
    ]


def dlrm_train_variants():
    """Worst-fraction family cell: dense-optimizer traffic + lookup pattern."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch("dlrm-mlperf")
    cell = spec.cell("train_batch")
    out = [("baseline_adamw_dense",
            "dense AdamW on 24B table params: optimizer read-write of every "
            "table's moments dominates the memory term; gathers and scatters "
            "on FSDP tables drive the collective",
            spec, cell)]
    rw = dataclasses.replace(spec, optimizer="rowwise")
    out.append(("rowwise_sparse",
                "gather rows OUTSIDE autodiff + rowwise AdaGrad: dense "
                "table grads never exist; optimizer traffic O(B x F x E) "
                "-> memory term ~ / 100; table scatter in place (donated)",
                rw, cell))
    rw16 = dataclasses.replace(
        rw, cfg=dataclasses.replace(rw.cfg, param_dtype="bfloat16"))
    out.append(("rowwise_bf16_tables",
                "a sharded gather can replicate row outputs at global batch; "
                "bf16 tables halve every row byte moved (industry-standard "
                "fp16 / bf16 embeddings)",
                rw16, cell))
    return out


def smollm_train_variants():
    """Bonus cell: the over-parallelisation finding made concrete."""
    from repro_torch.configs.registry import get_arch
    spec = get_arch("smollm-135m")
    cell = spec.cell("train_4k")

    def variant(name, hypothesis, **cfg_over):
        s = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **cfg_over))
        return name, hypothesis, s, cell

    return [
        variant("baseline_tp16_fsdp",
                "TP16 per-layer all-reduces x remat x microbatches cost "
                "many times the compute for a 135M model"),
        variant("dp_only",
                "replicate params (540 MB fp32 fits trivially), batch-only "
                "sharding: collective collapses to the one grad all-reduce "
                "=> compute-bound",
                parallelism="dp_only"),
        variant("dp_only_mb1",
                "microbatching exists only for memory; DP-only activations "
                "are small, so drop it and save the grad-accum passes",
                parallelism="dp_only", microbatch=1),
    ]


CELLS = {
    "tt_retrieval": tt_retrieval_variants,
    "arctic_train": arctic_train_variants,
    "dlrm_train": dlrm_train_variants,
    "smollm_train": smollm_train_variants,
}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--only", default=None, help="variant name filter")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from repro_torch.configs.steps import BUNDLE_BUILDERS
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.cell}_{args.mesh}.json")
    log = []
    if os.path.exists(path):
        with open(path) as f:
            log = json.load(f)
    done = {e["variant"] for e in log}

    for name, hypothesis, spec, cell in CELLS[args.cell]():
        if args.only and args.only != name:
            continue
        if name in done:
            print(f"skip {name} (already measured)")
            continue
        print(f"== {name}: {hypothesis[:70]}")
        try:
            bundle = BUNDLE_BUILDERS[spec.family](spec, cell, mesh)
            m = measure(bundle, mesh)
            m.update(variant=name, hypothesis=hypothesis, status="ok")
        except Exception as e:
            import traceback
            m = dict(variant=name, hypothesis=hypothesis, status="error",
                     error=f"{type(e).__name__}: {e}", op=getattr(e, "last_op", None),
                     traceback=traceback.format_exc()[-2000:])
        log.append(m)
        with open(path, "w") as f:
            json.dump(log, f, indent=1)
        if m["status"] == "ok":
            print(f"   compute={m['t_compute_s']:.3e}s memory={m['t_memory_s']:.3e}s "
                  f"collective=not counted dom={m['dominant']} "
                  f"step={m['step_time_s']:.3e}s args={m['argument_gib']:.2f}GiB/dev")
        else:
            print(f"   ERROR at {m['op']}: {m['error'][:120]}")
    return log


if __name__ == "__main__":
    main()
