"""Time the small calls' kernels on the card against another build of them,
in turns, and each kernel against the other path either side of its
switch.

    python src/repro_torch/benchmarks/small_calls.py [--src TREE] [--only pca|topk]
                                                     [--reps R] [--out PATH]

Builds this tree's kernels; with ``--src`` also TREE's ``pca_project.cu``
and ``topk_score.cu``, called through TREE's own wrappers
(``turns.load_other``). On random unit-norm rows it runs, for each shape,
this tree's call and TREE's on the same inputs, requires equal bits, and
times both in turns (``turns.in_turns``, R calls each, eager: host work
between the calls counts). Beside them: ``device_ms``, one call's device
time from a CUDA graph (``turns.graph_ms``), for this tree and TREE; the
library call's time (``matmul``, or ``matmul`` + ``topk`` over the live
rows), eager and in a graph; and where the shape could take the other
kernel, this tree's call forced onto it (``alt_*``: ``pca_project``'s other
path, the top-k's other plan), bitwise and timed the same way, which is
what places each switch.

Shapes: ``pca_project`` on 1 to 4,096 rows at 768 -> 384 and 32 to 8,192
at 256 -> 128 (each side of ``project_path``'s switch), the full prunes
(262,144 and 100,000 x 768 -> 384; 1,000,448 x 256 -> 128), f32, and the
int8 epilogue at 64 and 262,144 rows; the top-k on few rows (the int8
shortlist's 3,183-row rescore, the cascade's 2,560-row rescore, a
4,096-row delta with n_valid 1,808 as a host int and a device tensor, at k
10 and 100, f32 and int8; 20 pages of 256 rows with ids_pool; a 4,096-row
delta at B 1, k 100, m 128), 12,800 to 60,000 rows at k 10 and 100 (each
side of ``chunk_plan``'s switch), and the full index (8,841,823 x 384 at k
10 and 100, f32 and int8), B 32 unless named. Prints the card's name and
power limit, then one JSON line a shape; ``--out`` writes them too. Exits 1
if a build or a path differs.
"""
import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[3]


def forced_path(path: str):
    """A context in which every projection takes ``path``."""
    from repro_torch.kernels import pca_project
    return mock.patch.object(pca_project, "project_path", lambda n, m, sms: path)


def forced_plan(upc: int):
    """A context in which every top-k takes the unit kernel's plan (upc 1)
    or the chunk kernel's (upc 8)."""
    from repro_torch.kernels import topk_score

    def plan(big_chunks, units, B, sms, qn=None):
        if upc == 1:
            return topk_score.unit_plan(units, B)
        return topk_score.items_plan(big_chunks, B, sms, qn)
    return mock.patch.object(topk_score, "chunk_plan", plan)


def same(a, b):
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def measure(row, this, other, library, reps, graphs, alt=None):
    """Bitwise checks and times of one shape into ``row``; ``alt`` is a
    context that forces this tree's call onto the other kernel."""
    from repro_torch.benchmarks import turns
    got = this()
    if other is not None:
        row["bitwise"] = same(got, other())
        row["this_ms"], row["other_ms"] = turns.in_turns(this, other, reps)
    row["ms"] = turns.cuda_ms(this, reps)
    row["library_ms"] = turns.cuda_ms(library, reps)
    if graphs:
        row["device_ms"] = turns.graph_ms(this, reps)
        row["library_device_ms"] = turns.graph_ms(library, reps)
        if other is not None:
            row["other_device_ms"] = turns.graph_ms(other, reps)
    if alt is not None:
        with alt:
            row["alt_bitwise"] = same(got, this())
            row["alt_ms"] = turns.cuda_ms(this, reps)
            if graphs:
                row["alt_device_ms"] = turns.graph_ms(this, reps)
    return row


def pca_rows(other, reps, emit):
    import torch
    from repro_torch.kernels import _build, pca_project
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(n, 768, 384) for n in (1, 32, 64, 128, 256, 1024, 1408, 1536, 1664, 1792,
                                      2048, 2816, 4096)]
    shapes += [(n, 256, 128) for n in (32, 2048, 4096, 4352, 4864, 4992, 6144, 8192)]
    shapes += [(262_144, 768, 384), (100_000, 768, 384), (1_000_448, 256, 128)]
    for n, d, m in shapes:
        D = torch.randn(n, d, generator=g, device=dev) / d ** 0.5
        W = torch.randn(d, m, generator=g, device=dev) / d ** 0.5
        small = n <= 8192
        quant = n in (64, 262_144)
        scale = (D[:4096] @ W).abs().amax(0).div(127.0).clamp_min(1e-6) if quant else None
        path = pca_project.project_path(n, m, sms)
        for sc in ((None, scale) if quant else (None,)):
            row = dict(kernel="pca_project" if sc is None else "pca_project_quant",
                       n=n, d=d, m=m, path=path)
            if sc is None:
                def this():
                    return pca_project.pca_project_cuda(D, W)

                def theirs():
                    return other.pca_project.pca_project_cuda(D, W)
            else:
                def this():
                    return pca_project.pca_project_quant_cuda(D, W, sc)

                def theirs():
                    return other.pca_project.pca_project_quant_cuda(D, W, sc)
            measure(row, this, None if other is None else theirs, lambda: torch.matmul(D, W),
                    reps if small else max(2, reps // 4), small,
                    forced_path("tiled" if path == "small" else "small") if small else None)
            emit(row)
        del D


def topk_rows(other, reps, emit):
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import _build, topk_score
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cuda = topk_score.topk_score_cuda

    def rows_of(n, m):
        return torch.randn(n, m, generator=g, device=dev) / m ** 0.5

    def one(name, D, Q, k, *, n_valid=None, row_ids=None, graphs=True):
        n = D.shape[0]
        nv = int(n_valid) if n_valid is not None else n
        live = D[:nv] if row_ids is None else D[row_ids >= 0]
        plan = topk_score.dense_plan(n, Q.shape[0], sms)
        row = dict(kernel="topk_score", shape=name, n=n, m=D.shape[1], B=Q.shape[0], k=k,
                   store=str(D.dtype).split(".")[1], plan=plan._asdict())
        if n_valid is not None:
            row["n_valid"] = nv
            row["n_valid_tensor"] = isinstance(n_valid, torch.Tensor)
        measure(row, lambda: cuda(D, Q, k=k, n_valid=n_valid, row_ids=row_ids),
                None if other is None else
                lambda: other.topk_score.topk_score_cuda(D, Q, k=k, n_valid=n_valid,
                                                         row_ids=row_ids),
                lambda: torch.topk(Q @ live.float().T, k), reps, graphs,
                forced_plan(8 if plan.upc == 1 else 1) if n <= 100_000 else None)
        emit(row)

    Q = torch.randn(32, 384, generator=g, device=dev)
    for name, n in (("shortlist", 3183), ("cascade_rescore", 2560)):
        D = rows_of(n, 384)
        ids = (torch.randperm(8_841_823, generator=g, device=dev)[:n].sort().values
               .to(torch.int32))
        ids[-36:] = -1
        q8, s8 = quantize_int8_per_dim(D)
        one(f"{name}_f32", D, Q, 10, row_ids=ids)
        if name == "cascade_rescore":
            one(f"{name}_int8", q8, (Q * s8).contiguous(), 10, row_ids=ids)
    D = rows_of(4096, 384)
    D[1808:] = 0
    q8, s8 = quantize_int8_per_dim(D[:1808])
    q8 = torch.cat([q8, torch.zeros(4096 - 1808, 384, dtype=torch.int8, device=dev)])
    for k in (10, 100):
        for store, Dx, Qx in (("f32", D, Q), ("int8", q8, (Q * s8).contiguous())):
            one(f"delta_{store}", Dx, Qx, k, n_valid=1808)
            one(f"delta_{store}_device_count", Dx, Qx, k,
                n_valid=torch.tensor(1808, dtype=torch.int32, device=dev))
    D128 = rows_of(4096, 128)
    q8, s8 = quantize_int8_per_dim(D128[:4000])
    q8 = torch.cat([q8, torch.zeros(96, 128, dtype=torch.int8, device=dev)])
    one("recsys_delta_b1_int8", q8, (Q[:1, :128] * s8).contiguous(), 100, n_valid=4000)
    # each side of the plan's switch (25,344 rows at B 32)
    for n in (12_800, 20_000, 25_344, 28_672, 32_768, 36_864, 45_000, 60_000):
        D = rows_of(n, 384)
        for k in (10, 100):
            one(f"rows_{n}_f32", D, Q, k)
    del D

    # 20 pages of 256 rows with ids_pool
    npages, R = 20, 256
    pool = rows_of(npages * R, 384).view(npages, R, 384)
    table = torch.arange(npages, dtype=torch.int32, device=dev)
    nvalid = torch.full((npages,), R, dtype=torch.int32, device=dev)
    offset = table * R
    ids = torch.randperm(npages * R, generator=g, device=dev).to(torch.int32).view(npages, R)
    ids.view(-1)[::10] = -1
    gathered = pool.reshape(-1, 384)

    def paged(mod, k):
        return lambda: mod.topk_score_paged_cuda(pool, table, nvalid, offset, 0, npages, Q,
                                                 k=k, ids_pool=ids)

    for k in (10, 100):
        plan = topk_score.paged_plan(npages, R, 32, sms)
        row = dict(kernel="topk_score_paged", shape="ids_pool", pages=npages, page_rows=R,
                   m=384, B=32, k=k, plan=plan._asdict())
        measure(row, paged(topk_score, k), None if other is None else paged(other.topk_score, k),
                lambda: torch.topk(Q @ gathered.T, k), reps, True,
                forced_plan(8 if plan.upc == 1 else 1))
        emit(row)
    del pool, gathered

    # the full index: the chunk kernel's plan, unchanged
    D = rows_of(8_841_823, 384)
    for k in (10, 100):
        one("msmarco_f32", D, Q, k, graphs=False)
    q8, s8 = quantize_int8_per_dim(D)
    del D
    for k in (10, 100):
        one("msmarco_int8", q8, (Q * s8).contiguous(), k, graphs=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None, help="another source tree to compare with")
    ap.add_argument("--only", choices=("pca", "topk"), default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.benchmarks import turns
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("small_calls: needs a CUDA device")
    _build.build()
    other = None
    if args.src:
        names = {"pca": ("pca_project",), "topk": ("topk_score",)}.get(
            args.only, ("pca_project", "topk_score"))
        tree = Path(args.src).resolve()
        other = turns.load_other(tree, ROOT / "build" / "benchmarks" / "small_calls" / tree.name,
                                 names)
    lines = []

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    emit(dict(card=turns.card(), other=args.src))
    if args.only in (None, "pca"):
        pca_rows(other, args.reps, emit)
    if args.only in (None, "topk"):
        topk_rows(other, args.reps, emit)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    if not all(v for r in lines for key, v in r.items() if key.endswith("bitwise")):
        sys.exit("small_calls: a build or path differs")


if __name__ == "__main__":
    main()
