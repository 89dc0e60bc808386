"""Time the top-k at large k on the card against another build of its
kernels, in turns, at full shapes.

    python src/repro_torch/benchmarks/topk_large_k.py [--src TREE] [--cap0]
                                                      [--reps R] [--out PATH]

Builds this tree's kernels; with ``--src`` also compiles TREE's
``src/repro_torch/csrc/topk_score.cu`` (its C entries must take this
tree's arguments), and with ``--cap0`` this tree's source with the fused
select's cap at 0, so every query goes through the multi-CTA select. Each
other build is loaded with ``ctypes`` beside this tree's wrappers. On
random rows of unit norm (8,841,823 x 384 f32 and its per-dim int8, the
int8 coarse views at m 64 and 128, a 1,000,448-row m 128 / 256 slice for
one query, and the f32 rows in 256-row pages) it holds each other build
bitwise against this one and times both with CUDA events in the order
other, this, this, other (R calls each). Also prints the keys the list
mode listed a query (share of the rows) and the card's name and power
limit. One JSON line a shape; ``--out`` writes them too.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def compile_other(src: Path, out: Path, cap0: bool = False) -> ctypes.CDLL:
    """topk_score.cu from ``src`` (with the fused cap at 0 if ``cap0``)
    built into ``out`` and loaded with this tree's C signatures."""
    from repro_torch.kernels import _build, topk_score
    text = (src / "src/repro_torch/csrc/topk_score.cu").read_text()
    if cap0:
        line = "constexpr long long FCAP = 1LL << 20;"
        if line not in text:
            sys.exit("topk_large_k: the fused select's cap was not found")
        text = text.replace(line, "constexpr long long FCAP = 0;")
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "topk_score.cu"
    cu.write_text(text)
    so = out / "topk_score.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                           *_build.SOURCE_FLAGS.get("topk_score", ()), "-I",
                           str(src / "src/repro_torch/csrc"), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"topk_large_k: nvcc failed for {cu}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("topk_plan", "topk_score_f32", "topk_paged_plan", "topk_score_paged_f32"):
        restype, argtypes = topk_score._SIGNATURES[fn]
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def dense(lib, D, Q, k):
    import torch
    from repro_torch.kernels import topk_score
    B, (n, m) = Q.shape[0], D.shape
    plan = (ctypes.c_int64 * 2)()
    lib.topk_plan(n, k, B, plan)
    scratch = torch.empty(plan[0], dtype=torch.int64, device=D.device)
    s = torch.empty((B, k), device=D.device)
    i = torch.empty((B, k), dtype=torch.int32, device=D.device)
    launched = ctypes.c_int(0)
    err = lib.topk_score_f32(D.data_ptr(), Q.data_ptr(), None, n, m, B, n, None, k,
                             topk_score._DTYPES[D.dtype], int(m % 16 == 0), scratch.data_ptr(),
                             s.data_ptr(), i.data_ptr(), torch.cuda.current_stream().cuda_stream,
                             ctypes.byref(launched))
    if err:
        sys.exit(f"topk_large_k: CUDA error {err}")
    return s, i


def paged(lib, st, Q, k):
    import torch
    from repro_torch.kernels import topk_score
    B, R, m, hi = Q.shape[0], st.page_rows, st.dim, st.n_slots
    plan = (ctypes.c_int64 * 2)()
    lib.topk_paged_plan(hi, R, k, 0, 0, B, plan)
    scratch = torch.empty(plan[0], dtype=torch.int64, device=Q.device)
    s = torch.empty((B, k), device=Q.device)
    i = torch.empty((B, k), dtype=torch.int32, device=Q.device)
    launched = ctypes.c_int(0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.topk_score_paged_f32(
        st.pool.data_ptr(), ptr(st.tail), st.page_table.data_ptr(), st.page_nvalid.data_ptr(),
        st.page_offset.data_ptr(), ptr(st.page_scale), None, Q.data_ptr(), None, None,
        st.pool.shape[0], 0 if st.tail is None else st.tail.shape[0], R, m, B, 0, hi, None,
        None, k, topk_score._DTYPES[st.pool.dtype], int(m % 16 == 0), 1, scratch.data_ptr(),
        s.data_ptr(), i.data_ptr(), torch.cuda.current_stream().cuda_stream,
        ctypes.byref(launched))
    if err:
        sys.exit(f"topk_large_k: CUDA error {err}")
    return s, i


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(key, this, other, reps):
    """Times of ``this`` and ``other`` in the order other, this, this, other."""
    out = {f"{key}_ms": [], f"this_vs_{key}_ms": []}
    for turn in ("other", "this", "this", "other"):
        fn = this if turn == "this" else other
        out[f"{key}_ms" if turn == "other" else f"this_vs_{key}_ms"].append(cuda_ms(fn, reps))
    return out


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
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.paged import PagedIndex
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import _build, topk_score

    if not torch.cuda.is_available():
        sys.exit("topk_large_k: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = []
    _build.build(("topk_score",))
    others = {}
    work = ROOT / "build" / "benchmarks" / "topk_large_k"
    if args.src:
        others["src"] = compile_other(Path(args.src).resolve(), work / "src")
    if args.cap0:
        others["cap0"] = compile_other(ROOT, work / "cap0", cap0=True)

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    emit(dict(card=smi.strip()))
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
        got = topk_score.topk_score_cuda(Dx, Qx, k=k,
                                         on_lists=lambda g0, c, pack: listed.update(c=c))
        row = dict(shape=name, n=Dx.shape[0], m=Dx.shape[1], B=Qx.shape[0], k=k)
        if listed:
            row["listed_share"] = float(listed["c"].double().mean()) / Dx.shape[0]
        for key, lib in others.items():
            o = dense(lib, Dx, Qx, k)
            row[f"bitwise_{key}"] = torch.equal(o[0], got[0]) and torch.equal(o[1], got[1])
            row.update(in_turns(key, lambda: topk_score.topk_score_cuda(Dx, Qx, k=k),
                                lambda lib=lib: dense(lib, Dx, Qx, k), args.reps))
        row["ms"] = cuda_ms(lambda: topk_score.topk_score_cuda(Dx, Qx, k=k), args.reps)
        emit(row)
    del D8, c64, c128, shapes
    st = PagedIndex.from_index(DenseIndex.build(D), page_rows=256).storage
    args_p = (st.pool, st.page_table, st.page_nvalid, st.page_offset, 0, st.n_slots, Q)
    for k in (10, 100, 2000):
        got = topk_score.topk_score_paged_cuda(*args_p, k=k, tail=st.tail)
        row = dict(shape="paged_f32", pages=st.n_slots, page_rows=st.page_rows, k=k)
        for key, lib in others.items():
            o = paged(lib, st, Q, k)
            row[f"bitwise_{key}"] = torch.equal(o[0], got[0]) and torch.equal(o[1], got[1])
            row.update(in_turns(key, lambda: topk_score.topk_score_paged_cuda(
                *args_p, k=k, tail=st.tail), lambda lib=lib: paged(lib, st, Q, k), args.reps))
        row["ms"] = cuda_ms(lambda: topk_score.topk_score_paged_cuda(*args_p, k=k, tail=st.tail),
                            args.reps)
        emit(row)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    if not all(v for r in lines for key, v in r.items() if key.startswith("bitwise_")):
        sys.exit("topk_large_k: a build differs from this one")


if __name__ == "__main__":
    main()
