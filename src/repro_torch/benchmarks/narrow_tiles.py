"""Time the top-k for one to sixteen queries on the card against another
build, in turns: the chunk kernel's narrow query tiles (1 query at B 1, 8 at
B 2 to 8) and the two-level select, against a tree whose chunk kernel
always took the 32-query tile and whose select took one level.

    python src/repro_torch/benchmarks/narrow_tiles.py --src TREE [--reps R]
    python src/repro_torch/benchmarks/narrow_tiles.py --variant NAME [--reps R]

Builds this tree's ``topk_score.cu`` and TREE's, called through TREE's own
wrapper (``turns.load_other``). On random unit-norm rows it runs each shape
through both builds, requires equal bits, and times both in turns
(``turns.in_turns``, R eager calls each). Beside them, on this build: the
same call under ``chip_smoke.wide_tiles`` (the 32-query tile and the
one-level select), bitwise and in turns (``wide_ms``); at B 9 to 16 the
call forced onto the other tile width of 8 and 32 (``alt_qn``,
``alt_ms``), bitwise and in turns; torch.profiler's split of one call into
the chunk kernel, the select and the merge, and each select launch's
device ms (``select_launch_ms``: the two levels); the share of the rows the list
mode listed (k > 32); ``matmul`` + ``topk`` over the same rows (an f32
copy of bf16 and int8 rows); at B 1 the port's plain version on the card
(``plain_ms``); and the bound (each row read once, 2 B n m FLOP).

Shapes: B 1, 2, 4, 8, 9, 10, 12 and 16 at k 100 over ``retrieval_cand``'s
1,000,448 candidates (d 256 f32, pruned m 128 f32, bf16 and int8) and one slot of
its (2, 2) mesh (250,112 x 128 int8), and at k 10 and 100 over
8,841,823 x 384 f32 and int8. ``--variant NAME`` compares this tree with
itself built from an edited ``topk_score.cu`` (``VARIANTS``) at the
shapes where the select takes two levels. JSON lines go to stdout and to
``build/benchmarks/narrow_tiles/<name>.jsonl``; the first line is the
card's name and power limit. Exits 1 if a build or a bitwise check fails.
"""
import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "benchmarks" / "narrow_tiles"
BATCHES = (1, 2, 4, 8, 9, 10, 12, 16)
# the two-level select's variants: text edits of csrc/topk_score.cu
VARIANTS = {
    # a digit pass may leave at most 256 keys to the sort (1,024 at k 100)
    "room256": (("  int room = 1024;\n", "  int room = 256;\n"),),
}
SPLIT = {"chunk": ("topk_chunk_kernel", "topk_unit_kernel"),
         "select": ("select_fused_kernel", "radix_hist_kernel", "radix_pick_kernel",
                    "radix_gather_kernel", "bitonic_tile_kernel", "bitonic_global_kernel",
                    "select_write_kernel"),
         "merge": ("topk_merge_kernel",)}


def shapes(dev):
    """(name, D, scale, ks) of each index: retrieval_cand's full and pruned
    f32, pruned bf16 and int8 rows, a slot of its mesh, then 8,841,823 x 384
    f32 and int8."""
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    g = torch.Generator(device=dev).manual_seed(0)
    for n, m, ks in ((1_000_448, 256, (100,)), (1_000_448, 128, (100,)),
                     (250_112, 128, (100,)), (8_841_823, 384, (10, 100))):
        D = torch.randn(n, m, generator=g, device=dev) / m ** 0.5
        if n != 250_112:
            yield f"{n}x{m}_f32", D, None, ks
        if (n, m) == (1_000_448, 128):
            yield f"{n}x{m}_bf16", D.to(torch.bfloat16), None, ks
        if m != 256:
            q8, s8 = quantize_int8_per_dim(D)
            del D
            yield f"{n}x{m}_int8", q8, s8, ks
            del q8
        else:
            del D


def same(a, b):
    import torch
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _edit(variant):
    def edit(name, text):
        for old, new in VARIANTS[variant]:
            if text.count(old) != 1:
                sys.exit(f"narrow_tiles: variant {variant}: {old!r} is not in {name}.cu once")
            text = text.replace(old, new)
        return text
    return edit


def launch_ms(fn, name):
    """Device ms of each launch of kernel ``name`` in one call of ``fn``, in
    order (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
            if name in ev.name and ev.device_type == torch.autograd.DeviceType.CUDA]


def run(this, other, variant, reps, emit):
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build, topk_score
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    Qall = torch.randn(max(BATCHES), 384, generator=g, device=dev)
    for name, D, scale, ks in shapes(dev):
        n, m = D.shape
        item = D.element_size()
        Df = D.float() if item != 4 else D
        for B in BATCHES:
            Q = Qall[:B, :m].contiguous()
            if scale is not None:
                Q = (Q * scale[None, :]).contiguous()
            plan = topk_score.dense_plan(n, B, sms)
            for k in ks:
                groups = topk_score.select_groups(B, plan, k, sms)
                if variant and not groups:
                    continue
                row = dict(shape=name, n=n, m=m, B=B, k=k, qn=plan.qn, segs=plan.segs,
                           ctas=plan.ctas, select_groups=groups)
                listed = {}

                def mine():
                    return this.topk_score_cuda(D, Q, k=k)

                def theirs():
                    return other.topk_score_cuda(D, Q, k=k)

                def wide():
                    with chip_smoke.wide_tiles():
                        return this.topk_score_cuda(D, Q, k=k)

                got = this.topk_score_cuda(D, Q, k=k, on_lists=lambda g0, c, pack:
                                           listed.update(counts=c))
                row["bitwise"] = same(got, theirs())
                row["wide_bitwise"] = same(got, wide())
                if "counts" in listed:
                    row["listed_share"] = float(listed["counts"].double().mean()) / n
                row["this_ms"], row["other_ms"] = turns.in_turns(mine, theirs, reps)
                if variant:
                    row["other_select_launch_ms"] = launch_ms(theirs, "select_fused_kernel")
                else:
                    _, row["wide_ms"] = turns.in_turns(mine, wide, reps)
                if 8 < B <= 16 and not variant:
                    alt_qn = 32 if plan.qn == 8 else 8

                    def alt():
                        with mock.patch.object(topk_score, "query_width", lambda b: alt_qn):
                            return this.topk_score_cuda(D, Q, k=k)
                    row.update(alt_qn=alt_qn, alt_bitwise=same(got, alt()))
                    row["plan_ms"], row["alt_ms"] = turns.in_turns(mine, alt, reps)
                split = chip_smoke.kernel_ms(mine, SPLIT,
                                             launches=chip_smoke.topk_launches(mine))
                row.update({f"{part}_ms": v for part, v in split.items()})
                row["select_launch_ms"] = launch_ms(mine, "select_fused_kernel")
                row["library_ms"] = turns.cuda_ms(lambda: torch.topk(Q @ Df.T, k), reps)
                if B == 1 and not variant:      # the port's plain version on the card
                    row["plain_ms"] = turns.cuda_ms(
                        lambda: topk_score.topk_score_plain(D, Q, k=k), max(2, reps // 4))
                b_ms, b_by = chip_smoke.bound(item * n * m + 4 * B * m + 8 * B * k,
                                              2 * B * n * m)
                row.update(bound_ms=b_ms, bound_by=b_by)
                emit(row)
                if not (row["bitwise"] and row["wide_bitwise"] and row.get("alt_bitwise", True)):
                    return False
                torch.cuda.empty_cache()
        del Df
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--src", type=Path,
                     help="the other tree of the port (e.g. the parent commit unpacked)")
    how.add_argument("--variant", choices=sorted(VARIANTS),
                     help="this tree against itself built from an edited topk_score.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import topk_score
    OUT.mkdir(parents=True, exist_ok=True)
    if args.variant:
        other = turns.load_other(ROOT, OUT / args.variant, ("topk_score",),
                                 edit=_edit(args.variant)).topk_score
    else:
        other = turns.load_other(args.src.resolve(), OUT / "other", ("topk_score",)).topk_score
    log = open(OUT / f"{args.variant or 'narrow_tiles'}.jsonl", "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    emit({"card": turns.card(), "src": str(args.src), "variant": args.variant})
    ok = run(topk_score, other, args.variant, args.reps, emit)
    log.close()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
