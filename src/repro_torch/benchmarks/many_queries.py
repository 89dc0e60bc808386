"""Time the top-k over many query tiles on the card against another build,
in turns: the chunk kernel's 32-query tile (its persistent (segment, tile)
items and its k-major mainloop) against another tree's.

    python src/repro_torch/benchmarks/many_queries.py --src TREE [--reps R] [--shapes S]
    python src/repro_torch/benchmarks/many_queries.py --variant A[,B...] [--reps R] [--shapes S]
    python src/repro_torch/benchmarks/many_queries.py --sass

Builds this tree's ``topk_score.cu`` and, with ``--src``, TREE's, called
through TREE's own wrapper (``turns.load_other``), all compiled at once.
On random unit-norm rows it runs each shape through both builds, requires
equal bits, and times both in turns (``turns.in_turns``, R calls each,
eager), each time beside its FMA share (B n m FMAs a second over the fp32
peak, 33.5 T: the mainloop's rate where the chunk kernel takes the call);
where a dense call keeps no large scratch (k <= 32) also one call's device
time from a CUDA graph (``turns.graph_ms``). Beside them: ``matmul`` +
``topk`` over the same rows (an f32 copy of int8 and bf16 rows, dequantized
pages) where the score matrix fits in 8 GB, a dense plan's segments, CTAs
and makespan (the most 512-row chunks one CTA walks; TREE's walk as
``wave_plan`` gives it, its CTAs past the SMs in a second wave), and
``chunk_us``, this tree's ms over its makespan: one chunk's walk. Where
this tree's plan keeps each CTA on one query tile with fewer CTAs than
SMs, ``alt_*`` is this tree's call under ``spread_plan`` (every SM, the
least makespan, the running lists started afresh an item), bitwise and in
turns with the plan's.

Shapes (``--shapes`` keeps those whose names hold one of its parts): B in
{32, 64, 200, 256, 1,000, 2,048, 6,980} over 100,000 x 768 f32 and x 384
f32, int8 and bf16 at k 10 and 1,000; the same 384-wide rows in 256-row
pages, f32 and int8 with a scale row a page (``topk_score_paged_cuda``),
at B 32 and 1,000, k 10 and 100; B 32, 200 and 1,000 at k 10 over
8,841,823 x 384 f32 and int8, and the f32 rows paged at B 32, k 10 and
100.

``--variant`` compares this tree with itself built from edited
``topk_score.cu`` sources (``turns.load_other``'s ``edit``; the mainloop
variants of the chunk kernel, ``VARIANTS``) on the shapes at B 32 and
1,000 and their first k; the variants in ``ABLATIONS`` are not bitwise by
design (they time a part of the loop away). ``--sass`` dumps the f32 and
int8 dense keep-mode chunk kernels' SASS (``cuobjdump``) and counts their
instructions by opcode: whole, in the loop over slabs, per slab, and from
the slab's first FFMA to its last; then ptxas's registers and spills of
every wide-tile instance. JSON lines go to stdout and to
``build/benchmarks/many_queries/<name>.jsonl``; the first line of each
comparison is the card's name and power limit. Exits 1 if a build or a
bitwise check fails.
"""
import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "benchmarks" / "many_queries"
BATCHES = (32, 64, 200, 256, 1000, 2048, 6980)
SCORE_BYTES = 8 << 30       # matmul + topk only where the score matrix fits

# the chunk kernel's mainloop variants: text edits of csrc/topk_score.cu.
# Tried on earlier forms of the new loop and gone with them (NVIDIA H100
# 80GB HBM3, 700 W, ms at B 32 over 8,841,823 x 384, k 10, f32 / int8,
# variant against the loop it edited): a 64 KB ring, not 96 KB, with a
# block barrier a slab (7.29 / 7.09 against 7.04 / 7.02); the rewrite of
# raw slab t + 1 before slab t's product (7.01 / 7.01 against 6.97 / 6.72).
# The loop before this one had its own (slab_barrier, kp768), gone with it.
REWRITE = "        to_kmajor<T>(stage(t + 1), Fs, warp, lane);\n"
PAIRED = "  static constexpr bool PAIRED = sizeof(T) == 4;"
VARIANTS = {
    # the per-chunk epilogue timed away: the scores are summed (so the FMAs
    # stay) and no key is selected; not bitwise
    "no_epilogue": ((
        "          chunk_keys(acc, Fs, run, src, B, q0, k, chunk, ldq, cand, tid);",
        "          { float z = 0.f;\n"
        "#pragma unroll\n"
        "            for (int i = 0; i < 8; ++i)\n"
        "#pragma unroll\n"
        "              for (int j = 0; j < 8; ++j) { z += acc[i][j]; acc[i][j] = 0.f; }\n"
        "            if (z == 1234.5f) cand[tid] = 0; }"),),
    # each slab's row addresses found anew, not once a chunk
    "find_each_slab": (("          if (lslab == 0) rows.find(src, lchunk, warp, lane);",
                        "          rows.find(src, lchunk, warp, lane);"),),
    # f32 asks for one raw slab a slab, before its product (a row's 64-byte
    # halves of a line a slab apart), as int8 and bf16 do
    "single_loads": ((PAIRED, "  static constexpr bool PAIRED = false;"),),
    # int8 and bf16 ask for two raw slabs every other slab, as f32 does
    "paired_loads": ((PAIRED, "  static constexpr bool PAIRED = true;"),),
    # no rewrite of the raw slabs: the product reads a stale f32 slab (what
    # the rewrite costs; not bitwise)
    "no_rewrite": ((REWRITE, ""),),
    # no copies into the ring: the rewrite reads stale raw stages (what the
    # loads and their waits cost; not bitwise)
    "no_load": (("          rows.load(stage(lt), lslab * CK, warp, lane);", ""),),
}
# variants that change the result by design: their rows are not held bitwise
ABLATIONS = {"no_epilogue", "no_rewrite", "no_load"}
PEAK_FMA = 33.5e12          # an H100 SXM's fp32 FMAs a second (67 TFLOP/s)


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


def paged_view(D, R, quantize):
    """D's rows in pages of R rows, in order: the paged top-k's (pool,
    page_table, page_nvalid, page_offset), and with ``quantize`` each page
    quantized to int8 with its own per-dim scale row (page_scale), else
    None."""
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    n, m = D.shape
    npages = -(-n // R)
    pool = D.new_zeros((npages, R, m))
    pool.view(-1, m)[:n] = D
    ps = None
    if quantize:
        q = torch.empty(pool.shape, dtype=torch.int8, device=D.device)
        ps = torch.empty((npages, m), device=D.device)
        for p in range(npages):
            q[p], ps[p] = quantize_int8_per_dim(pool[p])
        pool = q
    dev = D.device
    pt = torch.arange(npages, dtype=torch.int32, device=dev)
    nv = torch.full((npages,), R, dtype=torch.int32, device=dev)
    nv[-1] = n - (npages - 1) * R
    return (pool, pt, nv, pt * R), ps


def shapes(dev):
    """Each index: name, n, m, the batches and ks it runs, how the query is
    scaled (an int8 index's scale), an f32 copy of its rows for ``matmul`` +
    ``topk``, and call(module, Q, k) through a build's wrapper. 100,000 x
    768 f32, x 384 f32, int8, bf16, the same 384-wide rows in 256-row pages
    (f32, int8 with a scale row a page), then 8,841,823 x 384 f32, paged
    f32 (B 32) and int8."""
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    g = torch.Generator(device=dev).manual_seed(0)

    def dense(name, D, scale, Df, batches, ks):
        return dict(name=name, n=D.shape[0], m=D.shape[1], batches=batches, ks=ks,
                    qscale=scale, Df=Df, paged=False,
                    call=lambda mod, Q, k: mod.topk_score_cuda(D, Q, k=k))

    def paged(name, args, ps, Df, batches=(32, 1000)):
        return dict(name=name, n=Df.shape[0], m=Df.shape[1], batches=batches, ks=(10, 100),
                    qscale=None, Df=Df, paged=True,
                    call=lambda mod, Q, k: mod.topk_score_paged_cuda(
                        *args, 0, args[1].shape[0], Q, k=k, page_scale=ps))

    D = torch.randn(100_000, 768, generator=g, device=dev) / 768 ** 0.5
    yield dense("100000x768_f32", D, None, D, BATCHES, (10, 1000))
    D = torch.randn(100_000, 384, generator=g, device=dev) / 384 ** 0.5
    yield dense("100000x384_f32", D, None, D, BATCHES, (10, 1000))
    q8, s8 = quantize_int8_per_dim(D)
    yield dense("100000x384_int8", q8, s8, q8.float(), BATCHES, (10, 1000))
    yield dense("100000x384_bf16", D.bfloat16(), None, D.bfloat16().float(), BATCHES,
                (10, 1000))
    args, _ = paged_view(D, 256, False)
    yield paged("100000x384_paged_f32", args, None, D)
    args, ps = paged_view(D, 256, True)
    Dq = (args[0].float() * ps[:, None, :]).view(-1, 384)[:D.shape[0]]
    yield paged("100000x384_paged_int8", args, ps, Dq)
    del D, q8, args, Dq
    D = torch.randn(8_841_823, 384, generator=g, device=dev) / 384 ** 0.5
    yield dense("8841823x384_f32", D, None, D, (32, 200, 1000), (10,))
    args, _ = paged_view(D, 256, False)
    yield paged("8841823x384_paged_f32", args, None, D, (32,))
    del args
    q8, s8 = quantize_int8_per_dim(D)
    del D
    yield dense("8841823x384_int8", q8, s8, q8.float(), (32, 200, 1000), (10,))


def run(this, other, variant, reps, emit, only=None):
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build, topk_score
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    Qall = torch.randn(max(BATCHES), 768, generator=g, device=dev)
    for sh in shapes(dev):
        if only and not any(o in sh["name"] for o in only):
            continue
        n, m, Df = sh["n"], sh["m"], sh["Df"]
        big = n > 100_000
        for B in sh["batches"]:
            for k in sh["ks"]:
                if variant and (B not in (32, 1000) or k != sh["ks"][0]):
                    continue
                Q = Qall[:B, :m].contiguous()
                if sh["qscale"] is not None:
                    Q = (Q * sh["qscale"][None, :]).contiguous()
                row = dict(shape=sh["name"], n=n, m=m, B=B, k=k)
                if not sh["paged"]:
                    row.update(plan_of(n, B, sms))

                def mine(Q=Q, k=k):
                    return sh["call"](this, Q, k)

                def theirs(Q=Q, k=k):
                    return sh["call"](other, Q, k)

                row["bitwise"] = same(mine(), theirs())
                r = max(2, reps // 4) if B * n > 10 ** 9 else reps
                row["this_ms"], row["other_ms"] = turns.in_turns(mine, theirs, r)
                # the FMAs a second over the fp32 peak: the mainloop's rate
                # where the call's time is its chunk kernel's
                for key in ("this", "other"):
                    row[f"{key}_fma_share"] = B * n * m / (min(row[f"{key}_ms"]) * 1e-3) / PEAK_FMA
                alt = spread_plan(-(-n // 512), -(-n // 64), B, sms)
                if not variant and not sh["paged"] and alt.ctas != row["ctas"]:
                    def spread(Q=Q, k=k):
                        with mock.patch.object(topk_score, "chunk_plan", spread_plan):
                            return sh["call"](this, Q, k)
                    row.update(alt_segs=alt.segs, alt_ctas=alt.ctas,
                               alt_makespan=topk_score.makespan(alt.chunks, -(-B // 32),
                                                                alt.segs, alt.ctas),
                               alt_bitwise=same(mine(), spread()))
                    row["plan_ms"], row["alt_ms"] = turns.in_turns(mine, spread, r)
                if "makespan" in row:
                    row["chunk_us"] = min(row["this_ms"]) / row["makespan"] * 1e3
                if k <= 32 and not big and not sh["paged"]:
                    row["device_ms"] = turns.graph_ms(mine, reps)
                    row["other_device_ms"] = turns.graph_ms(theirs, reps)
                if B * n * 4 <= SCORE_BYTES:
                    row["library_ms"] = turns.cuda_ms(lambda: torch.topk(Q @ Df.T, k), r)
                emit(row)
                torch.cuda.empty_cache()


def chunk_label(fn):
    """A wide-tile chunk kernel's instance from its mangled name, as
    ``<dtype>,<vec|scalar>,<keep|list>,<dense|paged|paged_scaled>``, or
    None for another kernel or a narrow tile."""
    m = re.search(r"topk_chunk_kernelI(f|13__nv_bfloat16|a)Lb([01])ELb([01])E", fn)
    if m is None or not re.search(r"Li32EE", fn):
        return None
    src = "dense" if "DenseSrc" in fn else (
        "paged_scaled" if re.search(r"PagedSrcI(?:f|a|S\d*_|13__nv_bfloat16)Lb1E", fn) else "paged")
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}[m.group(1)]
    return ",".join((dtype, "vec" if m.group(2) == "1" else "scalar",
                     "list" if m.group(3) == "1" else "keep", src))


def sass(emit):
    """The f32 and int8 dense keep-mode chunk kernels' SASS, counted by
    opcode: the whole function, its loop over slabs (the shortest backward
    branch whose body holds the most FFMAs; its FFMAs over 1,024 are the
    slabs one pass covers, so ``per_slab`` is a slab's instructions) and
    the stretch from the first FFMA to the last; then ptxas's registers and
    spills of every wide-tile instance."""
    from repro_torch.kernels import _build
    report = _build.build(("topk_score",))["topk_score"]
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path("topk_score"))],
                          capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    found = set()
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        head, body = fn.split("\n", 1)
        label = chunk_label(head)
        if label not in ("f32,vec,keep,dense", "int8,vec,keep,dense"):
            continue
        found.add(label)
        (OUT / f"sass_chunk_{label.replace(',', '_')}.txt").write_text(head + "\n" + body)
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
        row = dict(sass=f"topk_chunk_kernel<{label}>", function=head.strip(),
                   instructions=len(ops), by_opcode=dict(whole.most_common(20)))
        if inner is not None:
            body_ops = Counter(op.split(".")[0] for _, op in ops[inner[0]:inner[1] + 1])
            full = Counter(op for _, op in ops[inner[0]:inner[1] + 1])
            slabs = max(1, body_ops["FFMA"] // 1024)
            row.update(loop_instructions=inner[1] - inner[0] + 1,
                       loop_by_opcode=dict(body_ops.most_common(20)),
                       loop_ffma=body_ops["FFMA"],
                       loop_non_ffma=inner[1] - inner[0] + 1 - body_ops["FFMA"],
                       per_slab={op: c / slabs for op, c in full.most_common(16)})
        # the slab's product: from its first FFMA to its last
        fma = [i for i, (_, op) in enumerate(ops) if op.startswith("FFMA")]
        span = Counter(op for _, op in ops[fma[0]:fma[-1] + 1])
        row.update(fma_span_instructions=fma[-1] - fma[0] + 1,
                   fma_span_by_opcode=dict(span.most_common(12)))
        emit(row)
    if len(found) < 2:
        sys.exit("many_queries: no f32 / int8 dense keep-mode chunk kernel in the SASS")
    emit(dict(ptxas=[dict(kernel=label, registers=r["registers"],
                          spill_bytes=r["spill_store_bytes"] + r["spill_load_bytes"])
                     for r in _build.ptxas_summary(report)
                     if (label := chunk_label(r["function"])) is not None]))


def main():
    ap = argparse.ArgumentParser()
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--src", help="another source tree to compare with")
    group.add_argument("--variant", help="comma-separated names of VARIANTS: "
                       + ", ".join(sorted(VARIANTS)))
    group.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", help="comma-separated parts of shape names to run (default all)")
    args = ap.parse_args()
    variants = args.variant.split(",") if args.variant else []
    if unknown := [v for v in variants if v not in VARIANTS]:
        sys.exit(f"many_queries: unknown variants {unknown}; known: {sorted(VARIANTS)}")
    only = args.shapes.split(",") if args.shapes else None
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build, topk_score

    if not torch.cuda.is_available():
        sys.exit("many_queries: needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    failed = False
    if args.sass:
        lines = []

        def emit(row):
            lines.append(row)
            print(json.dumps(row), flush=True)
        emit(dict(card=turns.card(), sass=True))
        sass(emit)
        (OUT / "sass.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
        return
    # this tree and each other build, all compiled at once
    jobs = [(Path(args.src).resolve().name, Path(args.src).resolve(), None)] if args.src else [
        (v, ROOT, _edit(v)) for v in variants]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        mine = pool.submit(_build.build, ("topk_score",))
        others = [pool.submit(turns.load_other, tree, OUT / f"build_{label}", ("topk_score",),
                              edit=edit) for label, tree, edit in jobs]
        mine.result()
        others = [o.result() for o in others]
    for (label, _, _), other in zip(jobs, others):
        variant = None if args.src else label
        lines = []

        def emit(row):
            lines.append(row)
            print(json.dumps(row), flush=True)
        emit(dict(card=turns.card(), other=args.src, variant=variant))
        run(topk_score, other.topk_score, variant, args.reps, emit, only)
        (OUT / f"{label}.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
        failed |= variant not in ABLATIONS and not all(
            v for r in lines for key, v in r.items() if key.endswith("bitwise"))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
