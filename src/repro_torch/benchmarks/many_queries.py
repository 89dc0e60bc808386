"""Time the top-k over many query tiles on the card against another build,
in turns: the chunk kernel's persistent (segment, tile) items against a
tree that launched a CTA a segment and tile.

    python src/repro_torch/benchmarks/many_queries.py --src TREE [--reps R]
    python src/repro_torch/benchmarks/many_queries.py --variant NAME [--reps R]
    python src/repro_torch/benchmarks/many_queries.py --sass

Builds this tree's ``topk_score.cu`` and, with ``--src``, TREE's, called
through TREE's own wrapper (``turns.load_other``). On random unit-norm rows
it runs each shape through both builds, requires equal bits, and times
both in turns (``turns.in_turns``, R calls each, eager); where the call
keeps no large scratch (k <= 32) also one call's device time from a CUDA
graph (``turns.graph_ms``). Beside them: ``matmul`` + ``topk`` over the
same rows (an f32 copy of int8 rows) where the score matrix fits in 8 GB,
the plan's segments, CTAs and makespan (the most 512-row chunks one CTA
walks; TREE's walk as ``wave_plan`` gives it, its CTAs past the SMs in a
second wave), and ``chunk_us``, this tree's ms over its makespan: one
chunk's walk. Where this tree's plan keeps each CTA on one query tile
with fewer CTAs than SMs, ``alt_*`` is this tree's call under
``spread_plan`` (every SM, the least makespan, the running lists started
afresh an item), bitwise and in turns with the plan's.

Shapes: B in {32, 64, 200, 256, 1,000, 2,048, 6,980} over 100,000 x 768 and
x 384 f32 and x 384 int8 at k 10 and 1,000; B 32, 200 and 1,000 at k 10
over 8,841,823 x 384 f32 and int8 (B 32: the one-tile search, which must
not move).

``--variant NAME`` compares this tree with itself built from an edited
``topk_score.cu`` (``turns.load_other``'s ``edit``; the mainloop variants
of the chunk kernel, ``VARIANTS``) on the k 10 shapes at B 32 and 1,000;
a variant that is not bitwise says so in its rows (``no_epilogue`` is not
meant to be: it times the per-chunk select away). ``--sass`` dumps the
f32 dense chunk kernel's SASS (``cuobjdump``) and counts its instructions
by opcode: whole, in its loop over slabs, and from the slab's first FFMA
to its last. JSON lines go to stdout and
to ``build/benchmarks/many_queries/<name>.jsonl``; the first line is the
card's name and power limit. Exits 1 if a build or a bitwise check fails.
"""
import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "benchmarks" / "many_queries"
BATCHES = (32, 64, 200, 256, 1000, 2048, 6980)
SCORE_BYTES = 8 << 30       # matmul + topk only where the score matrix fits

# the chunk kernel's mainloop variants: text edits of csrc/topk_score.cu
SLAB = (
    ("constexpr int AHEAD = C::RAW ? C::STAGES : C::STAGES - 2;",
     "constexpr int AHEAD = C::RAW ? C::STAGES : C::STAGES - 1;"),
    ("      const bool synced = C::RAW || t % 2 == 0 || nslab == 1;",
     "      const bool synced = true;"),
    ("        if constexpr (C::RAW)\n          cp_async_wait<C::STAGES - 2>();\n"
     "        else if (t % 2 == 0)\n          cp_async_wait<0>();",
     "        cp_async_wait<C::STAGES - 2>();"),
    ("      if constexpr (C::RAW) {\n        if (t + AHEAD < total) load(t + AHEAD);\n"
     "        cp_async_commit();\n      } else if (t % 2 == 0) {\n"
     "        if (t + 2 < total) load(t + 2);\n        if (t + 3 < total) load(t + 3);\n"
     "        cp_async_commit();\n      }",
     "      if (t + AHEAD < total) load(t + AHEAD);\n      cp_async_commit();"))
VARIANTS = {
    # (b), undone: one barrier per 16-deep f32 slab, three slabs ahead (the
    # parent's schedule)
    "slab_barrier": SLAB,
    # (a) the whole 768-wide query tile resident (no panel reloads a chunk),
    # three f32 ring stages to make room (k <= 32 only: list mode's lane
    # lists would pass 227 KB at m 768); three stages need a barrier a slab
    "kp768": SLAB + (("constexpr int KP_MAX = 384;", "constexpr int KP_MAX = 768;"),
                     ("RAW_RING / STAGE_BYTES : 4;", "RAW_RING / STAGE_BYTES : 3;")),
    # (c) the per-chunk epilogue timed away: the scores are summed (so the
    # FMAs stay) and no key is selected; not bitwise
    "no_epilogue": ((
        "          chunk_keys(acc, Ss, run, src, B, q0, k, chunk_of(t), ldq, cand, tid);",
        "          { float z = 0.f;\n"
        "#pragma unroll\n"
        "            for (int i = 0; i < 8; ++i)\n"
        "#pragma unroll\n"
        "              for (int j = 0; j < 8; ++j) { z += acc[i][j]; acc[i][j] = 0.f; }\n"
        "            if (z == 1234.5f) cand[tid] = 0; }"),),
}


def _edit(variant):
    def edit(name, text):
        for old, new in VARIANTS[variant]:
            if text.count(old) != 1:
                sys.exit(f"many_queries: variant {variant}: {old!r} is not in {name}.cu once")
            text = text.replace(old, new)
        return text
    return edit


def plan_of(n, B, sms):
    """This tree's plan of a dense call and TREE's (``wave_plan``), with the
    makespan of each."""
    from repro_torch.kernels import topk_score as T
    plan, tiles = T.dense_plan(n, B, sms), -(-B // 32)
    old = T.wave_plan(plan.chunks, -(-n // 64), B, sms)
    out = dict(segs=plan.segs, ctas=plan.ctas, wave_segs=old.segs, wave_ctas=old.ctas)
    if plan.upc == 8:
        out.update(makespan=T.makespan(plan.chunks, tiles, plan.segs, plan.ctas),
                   wave_makespan=T.makespan(plan.chunks, tiles, old.segs, min(old.ctas, sms)))
    return out


def spread_plan(big_chunks, units, B, sms, qn=None):
    """``chunk_plan`` without the restart charge: the least makespan over
    min(sms, tiles x segs) CTAs, the fewest segments on a tie."""
    from repro_torch.kernels import topk_score as T
    if not T._takes_chunks(big_chunks, units, B, sms):
        return T.unit_plan(units, B)
    qn = T.query_width(B) if qn is None else qn
    tiles = -(-B // qn)
    s0 = min(big_chunks, -(-sms // tiles))
    segs = min(range(s0, min(big_chunks, T.SEG_SPAN * s0) + 1),
               key=lambda S: T.makespan(big_chunks, tiles, S, min(sms, tiles * S)))
    return T.ChunkPlan(8, big_chunks, segs, min(sms, tiles * segs), qn)


def same(a, b):
    import torch
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def shapes(dev):
    """(name, D, scale) of each index: 100,000 x 768 / 384 f32, 384 int8,
    then 8,841,823 x 384 f32 and int8."""
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    g = torch.Generator(device=dev).manual_seed(0)
    for n, m in ((100_000, 768), (100_000, 384), (8_841_823, 384)):
        D = torch.randn(n, m, generator=g, device=dev) / m ** 0.5
        yield f"{n}x{m}_f32", D, None
        if m == 384:
            q8, s8 = quantize_int8_per_dim(D)
            del D
            yield f"{n}x{m}_int8", q8, s8
            del q8
        else:
            del D


def run(this, other, variant, reps, emit):
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build, topk_score
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    Qall = torch.randn(max(BATCHES), 768, generator=g, device=dev)
    for name, D, scale in shapes(dev):
        n, m = D.shape
        big = n > 100_000
        Df = D if scale is None else D.float()
        for B in ((32, 200, 1000) if big else BATCHES):
            for k in ((10,) if big or variant else (10, 1000)):
                if variant and B not in (32, 1000):
                    continue
                Q = Qall[:B, :m].contiguous()
                if scale is not None:
                    Q = (Q * scale[None, :]).contiguous()
                row = dict(shape=name, n=n, m=m, B=B, k=k, **plan_of(n, B, sms))

                def mine():
                    return this.topk_score_cuda(D, Q, k=k)

                def theirs():
                    return other.topk_score_cuda(D, Q, k=k)

                row["bitwise"] = same(mine(), theirs())
                r = max(2, reps // 4) if B * n > 10 ** 9 else reps
                row["this_ms"], row["other_ms"] = turns.in_turns(mine, theirs, r)
                alt = spread_plan(-(-n // 512), -(-n // 64), B, sms)
                if not variant and alt.ctas != row["ctas"]:
                    def spread():
                        with mock.patch.object(topk_score, "chunk_plan", spread_plan):
                            return this.topk_score_cuda(D, Q, k=k)
                    row.update(alt_segs=alt.segs, alt_ctas=alt.ctas,
                               alt_makespan=topk_score.makespan(alt.chunks, -(-B // 32),
                                                                alt.segs, alt.ctas),
                               alt_bitwise=same(mine(), spread()))
                    row["plan_ms"], row["alt_ms"] = turns.in_turns(mine, spread, r)
                if "makespan" in row:
                    row["chunk_us"] = min(row["this_ms"]) / row["makespan"] * 1e3
                if k <= 32 and not big:
                    row["device_ms"] = turns.graph_ms(mine, reps)
                    row["other_device_ms"] = turns.graph_ms(theirs, reps)
                if B * n * 4 <= SCORE_BYTES:
                    row["library_ms"] = turns.cuda_ms(lambda: torch.topk(Q @ Df.T, k), r)
                emit(row)
                torch.cuda.empty_cache()
        del Df


def sass(emit):
    """The f32 dense keep-mode chunk kernel's SASS, counted by opcode: the
    whole function, its loop over slabs (the shortest backward branch
    whose body holds the most FFMAs) and the stretch from the first FFMA
    to the last."""
    from repro_torch.kernels import _build
    _build.build(("topk_score",))
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path("topk_score"))],
                          capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        head, body = fn.split("\n", 1)
        if "topk_chunk_kernel" not in head or "DenseSrcIf" not in head or "Lb1ELb0E" not in head:
            continue
        (OUT / "sass_chunk_f32_dense_keep.txt").write_text(head + "\n" + body)
        ops = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        addr = {int(a, 16): i for i, (a, _) in enumerate(ops)}
        loops = []
        for i, (a, op) in enumerate(ops):
            if op.startswith("BRA"):
                tgt = re.search(r"/\*" + a + r"\*/[^\n]*?BRA[^\n]*?0x([0-9a-f]+)", body)
                if tgt and int(tgt.group(1), 16) in addr and int(tgt.group(1), 16) < int(a, 16):
                    loops.append((addr[int(tgt.group(1), 16)], i))
        # the innermost loop of the most FMAs: the mainloop over slabs
        inner = max(loops, key=lambda l: (sum(op.startswith("FFMA") for _, op in
                                              ops[l[0]:l[1] + 1]), l[0] - l[1]), default=None)
        whole = Counter(op.split(".")[0] for _, op in ops)
        row = dict(sass="topk_chunk_kernel<f32,vec,keep,dense>", function=head.strip(),
                   instructions=len(ops), by_opcode=dict(whole.most_common(20)))
        if inner is not None:
            body_ops = Counter(op.split(".")[0] for _, op in ops[inner[0]:inner[1] + 1])
            row.update(loop_instructions=inner[1] - inner[0] + 1,
                       loop_by_opcode=dict(body_ops.most_common(20)),
                       loop_ffma=body_ops["FFMA"],
                       loop_non_ffma=inner[1] - inner[0] + 1 - body_ops["FFMA"])
        # the slab's product: from its first FFMA to its last
        fma = [i for i, (_, op) in enumerate(ops) if op.startswith("FFMA")]
        span = Counter(op for _, op in ops[fma[0]:fma[-1] + 1])
        row.update(fma_span_instructions=fma[-1] - fma[0] + 1,
                   fma_span_by_opcode=dict(span.most_common(12)))
        emit(row)
        return
    sys.exit("many_queries: no f32 dense keep-mode chunk kernel in the SASS")


def main():
    ap = argparse.ArgumentParser()
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--src", help="another source tree to compare with")
    group.add_argument("--variant", choices=sorted(VARIANTS))
    group.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build, topk_score

    if not torch.cuda.is_available():
        sys.exit("many_queries: needs a CUDA device")
    lines = []

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    label = "sass" if args.sass else (args.variant or Path(args.src).resolve().name)
    emit(dict(card=turns.card(), other=args.src, variant=args.variant))
    if args.sass:
        sass(emit)
    else:
        _build.build(("topk_score",))
        tree, edit = (Path(args.src).resolve(), None) if args.src else (ROOT, _edit(args.variant))
        other = turns.load_other(tree, OUT / f"build_{label}", ("topk_score",), edit=edit)
        run(topk_score, other.topk_score, args.variant, args.reps, emit)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{label}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
    if not args.sass and not args.variant == "no_epilogue" and not all(
            v for r in lines for key, v in r.items() if key.endswith("bitwise")):
        sys.exit(1)


if __name__ == "__main__":
    main()
