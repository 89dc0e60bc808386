"""Time the top-k at large k on the card against another build of its
kernels, in turns, at full shapes.

    python src/repro_torch/benchmarks/topk_large_k.py [--src TREE] [--cap0]
                                                      [--reps R] [--out PATH]

Builds this tree's kernels; with ``--src`` also TREE's
``src/repro_torch/csrc/topk_score.cu``, and with ``--cap0`` this tree's
source with the fused select's cap at 0, so every query goes through the
multi-CTA select. Each other build is called through its own tree's
wrapper (``turns.load_other``). On random rows of unit norm (8,841,823 x
384 f32 and its per-dim int8, the int8 coarse views at m 64 and 128, a
1,000,448-row m 128 / 256 slice for one query, and the f32 rows in
256-row pages) it holds each other build bitwise against this one and
times both with CUDA events in the order other, this, this, other (R calls
each). Also prints the keys the list mode listed a query (share of the
rows) and the card's name and power limit. One JSON line a shape; ``--out`` writes them too.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
FCAP = "constexpr long long FCAP = 1LL << 20;"


def cap0(name: str, text: str) -> str:
    """topk_score.cu's text with the fused select's cap at 0."""
    if FCAP not in text:
        sys.exit("topk_large_k: the fused select's cap was not found")
    return text.replace(FCAP, "constexpr long long FCAP = 0;")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None, help="another source tree to compare with")
    ap.add_argument("--cap0", action="store_true",
                    help="compare with this tree's kernels with the fused select's cap at 0")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import _build, topk_score

    if not torch.cuda.is_available():
        sys.exit("topk_large_k: needs a CUDA device")
    lines = []
    _build.build(("topk_score",))
    others = {}
    work = ROOT / "build" / "benchmarks" / "topk_large_k"
    if args.src:
        others["src"] = turns.load_other(Path(args.src).resolve(), work / "src",
                                         ("topk_score",)).topk_score
    if args.cap0:
        others["cap0"] = turns.load_other(ROOT, work / "cap0", ("topk_score",),
                                          edit=cap0).topk_score

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    def compare(row, this, other_calls):
        got = this()
        for key, other in other_calls.items():
            o = other()
            row[f"bitwise_{key}"] = torch.equal(o[0], got[0]) and torch.equal(o[1], got[1])
            row[f"this_vs_{key}_ms"], row[f"{key}_ms"] = turns.in_turns(this, other, args.reps)
        row["ms"] = turns.cuda_ms(this, args.reps)
        emit(row)

    emit(dict(card=turns.card()))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D = torch.randn(8_841_823, 384, generator=g, device=dev) / 384 ** 0.5
    Q = torch.randn(32, 384, generator=g, device=dev)
    D8, s8 = quantize_int8_per_dim(D)
    c64, s64 = quantize_int8_per_dim(D[:, :64].contiguous())
    c128, s128 = quantize_int8_per_dim(D[:, :128].contiguous())
    shapes = [("f32", D, Q, k) for k in (10, 100, 1000, 2000, 10000)]
    shapes += [("int8", D8, (Q * s8).contiguous(), k) for k in (10, 100, 1000)]
    shapes += [("coarse_m64", c64, (Q[:, :64] * s64).contiguous(), 80),
               ("coarse_m128", c128, (Q[:, :128] * s128).contiguous(), 160)]
    shapes += [(f"b1_m{w}", D[:1_000_448, :w].contiguous(), Q[:1, :w].contiguous(), 100)
               for w in (128, 256)]
    for name, Dx, Qx, k in shapes:
        listed = {}
        topk_score.topk_score_cuda(Dx, Qx, k=k, on_lists=lambda g0, c, pack: listed.update(c=c))
        row = dict(shape=name, n=Dx.shape[0], m=Dx.shape[1], B=Qx.shape[0], k=k)
        if listed:
            row["listed_share"] = float(listed["c"].double().mean()) / Dx.shape[0]
        compare(row, lambda: topk_score.topk_score_cuda(Dx, Qx, k=k),
                {key: lambda mod=mod: mod.topk_score_cuda(Dx, Qx, k=k)
                 for key, mod in others.items()})
    del D8, c64, c128, shapes
    st = PagedIndex.from_index(DenseIndex.build(D), page_rows=256).storage
    args_p = (st.pool, st.page_table, st.page_nvalid, st.page_offset, 0, st.n_slots, Q)
    for k in (10, 100, 2000):
        row = dict(shape="paged_f32", pages=st.n_slots, page_rows=st.page_rows, k=k)
        compare(row, lambda: topk_score.topk_score_paged_cuda(*args_p, k=k, tail=st.tail),
                {key: lambda mod=mod: mod.topk_score_paged_cuda(*args_p, k=k, tail=st.tail)
                 for key, mod in others.items()})
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    if not all(v for r in lines for key, v in r.items() if key.startswith("bitwise_")):
        sys.exit("topk_large_k: a build differs from this one")


if __name__ == "__main__":
    main()
