#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printing one JSON line:
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: every kernel of ``src/repro_torch/csrc`` with nvcc for sm_90a,
     with ptxas's registers, shared memory and spills;
  3. kernels vs their plain versions on edge cases (ragged n, k > n,
     n_valid mid-chunk, ties across chunks, row_ids out of order and
     masked, m not a multiple of 16, f32/bf16/int8, k in {10, 100, 1000};
     gram exactly symmetric);
  4. the main path at full width: an MS MARCO-sized corpus (8,841,823 x 768,
     27.2 GB f32) drawn on the card, PCA fit (gram kernel), pruning at
     cutoff 0.5 to m = 384 (pca_project kernel), int8 by the two-pass
     absmax build and by the fused epilogue (pca_project_quant kernel),
     batches of 32 queries through search_projected on the f32 and int8
     indexes (topk_score kernel) and an exact f32 rescore of the int8
     shortlist (topk_score, row_ids mode); each kernel is compared with its
     plain version and timed at the shapes this path gives it;
  5. the Table-1 protocol on make_dataset("tasb", n_docs=100_000, d=768) at
     cutoffs {0.25, 0.5, 0.75}, checked against the CPU path (plain
     versions, the card's PCA state carried across) at 0.5;
  6. a pipeline_depth=3 RetrievalServer over the full-size int8 and f32
     indexes: closed and open loop, replies checked against direct
     search_projected calls.

Phases 4-6 are the main path: every launch counter is zeroed just before
phase 4 and read just after phase 6; launches made only to compare or time a
kernel are not counted. Then one line {"kernels": [...]}, the nvidia-smi
line, and last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero without the last line; so does a machine without a CUDA device.
"""
import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_DOCS = 8_841_823          # MS MARCO passage corpus rows (the paper's corpus)
DIM = 768                   # TAS-B / ANCE / Contriever width
CUTOFF = 0.5                # m = 384
BATCH = 32                  # serving batch
K = 10
SEARCH_BATCHES = 8
SHORTLIST_K = 100
PROTOCOL_DOCS = 100_000
PROTOCOL_DEPTH = 1000       # benchmarks/common.py:24
SERVER_CLOSED = 256
SERVER_OPEN = 512
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peaks (700 W)
FP32_FLOP_PER_S = 67e12
TOL = 1e-5                  # tests/test_kernels.py:126
# gram over 8.8M rows: max |kernel - G64| / max |G64|, G64 the plain
# version's product in fp64. The kernel's longest fp32 chain is 16,384 rows
# plus a 540-term sum of partials; it measured 1.5e-6 (PERF.md).
GRAM_TOL = 1e-5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps=3):
    """Mean device time of ``fn`` over ``reps`` launches after one warmup."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Counters:
    """The kernels' launch counters: zeroed before the main path, read
    after it; ``uncounted`` restores them around compare/timing launches.
    ``topk_score`` counts per mode (storage dtype, or row_ids), both its
    calls and the CUDA launches its C entry reports."""

    def __init__(self):
        from repro_torch.kernels.gram import gram_cuda
        from repro_torch.kernels.pca_project import pca_project_cuda, pca_project_quant_cuda
        from repro_torch.kernels.topk_score import topk_score_cuda
        self.fns = {"gram": gram_cuda, "pca_project": pca_project_cuda,
                    "pca_project_quant": pca_project_quant_cuda}
        self.topk = topk_score_cuda

    def read(self):
        out = {name: fn.launches for name, fn in self.fns.items()}
        for mode, v in self.topk.launches.items():
            out[f"topk_score_{mode}"] = v
            out[f"topk_score_{mode}_cuda"] = self.topk.cuda_launches[mode]
        return out

    def restore(self, values):
        for name, fn in self.fns.items():
            fn.launches = values[name]
        for mode in self.topk.launches:
            self.topk.launches[mode] = values[f"topk_score_{mode}"]
            self.topk.cuda_launches[mode] = values[f"topk_score_{mode}_cuda"]

    def zero(self):
        self.restore(dict.fromkeys(self.read(), 0))

    @contextlib.contextmanager
    def uncounted(self):
        saved = self.read()
        try:
            yield
        finally:
            self.restore(saved)


def compare_topk(s_ref, i_ref, s_got, i_got, what):
    """Scores within TOL; ids equal except where the plain version's
    neighbouring scores lie within TOL (another sum order may swap them),
    or, in the last slot, where the doc from past the cut scores within
    TOL of the one it displaced. Returns (max_abs_err, ids_equal,
    near_ties)."""
    import torch
    s_ref, i_ref, s_got, i_got = (x.cpu() for x in (s_ref, i_ref, s_got, i_got))
    finite = torch.isfinite(s_ref)
    if not torch.equal(finite, torch.isfinite(s_got)):
        raise AssertionError(f"{what}: -inf pads differ")
    delta = (s_ref[finite] - s_got[finite]).abs()
    err = float(delta.max()) if finite.any() else 0.0
    if bool((delta > TOL + TOL * s_ref[finite].abs()).any()):
        raise AssertionError(f"{what}: score error {err}")
    near = 0
    for b, j in (i_ref != i_got).nonzero().tolist():
        k = s_ref.shape[1]
        nb = [abs(float(s_ref[b, j] - s_ref[b, jj])) <= TOL
              for jj in (j - 1, j + 1) if 0 <= jj < k]
        at_cut = j == k - 1 and abs(float(s_got[b, j] - s_ref[b, j])) <= TOL
        if not (any(nb) or at_cut):
            raise AssertionError(f"{what}: id mismatch at ({b}, {j}): "
                                 f"{i_ref[b, max(j-1, 0):j+2].tolist()} vs "
                                 f"{i_got[b, max(j-1, 0):j+2].tolist()}")
        near += 1
    return err, near == 0, near


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, sms=props.multi_processor_count,
         memory_gb=props.total_memory / 1e9, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    for source, report in reports.items():
        for fn in _build.ptxas_summary(report):
            mangled = fn.pop("function")
            name = re.search(r"\d+([a-z][a-z_]*_kernel)", mangled)
            targs = re.search(r"_kernelI(\w+?)EEv", mangled)
            emit("build", source=f"src/repro_torch/csrc/{source}.cu",
                 kernel=(name.group(1) if name else mangled)
                 + (f"<{targs.group(1)}>" if targs else ""), **fn)
    emit("build", seconds=secs, sources=list(reports))


def phase_edge_cases():
    import torch
    from repro_torch.core.quantization import quantize_int8_per_dim
    from repro_torch.kernels import gram, pca_project, topk_score
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    checks = []
    # m = 130 is not a multiple of 16: the chunk kernel's element-wise loader
    for n, m, B, k in [(1000, 64, 5, 10), (4097, 384, 32, 100), (3000, 48, 40, 1000),
                       (700, 16, 3, 1000), (1536, 384, 33, 10), (1300, 130, 7, 10),
                       (2100, 130, 33, 1000)]:
        # rows of unit norm, so scores are O(1) as on the main path: the
        # near-tie window TOL is absolute
        D, Q = randn(n, m) / m ** 0.5, randn(B, m)
        # shuffled row ids with a few masked (-1) rows
        row_ids = torch.randperm(n, generator=g, device=dev).to(torch.int32) + 1000
        row_ids[torch.randperm(n, generator=g, device=dev)[:n // 10]] = -1
        for store in ("f32", "bf16", "int8"):
            Dx, Qx = D, Q
            if store == "bf16":
                Dx = D.to(torch.bfloat16)
            elif store == "int8":
                Dx, scale = quantize_int8_per_dim(D)
                Qx = (Q * scale[None, :]).contiguous()
            for mode, kw in (("plain", {}), ("n_valid", {"n_valid": n - 300}),
                             ("row_ids", {"row_ids": row_ids})):
                got = topk_score.topk_score_cuda(Dx, Qx, k=k, **kw)
                want = topk_score.topk_score_plain(Dx, Qx, k=k, **kw)
                err, eq, near = compare_topk(*want, *got,
                                             f"topk {store} {mode} n={n} m={m} k={k}")
                checks.append(dict(kernel="topk_score", n=n, m=m, B=B, k=k,
                                   store=store, mode=mode, max_abs_err=err,
                                   ids_equal=eq, near_ties=near))
    # every row tied, across chunks: ids exactly 0..k-1
    row = randn(32)
    D = row[None, :].repeat(2000, 1).contiguous()
    Q = torch.stack([row, 2 * row]).contiguous()
    for k in (10, 100, 1000):
        _, ids = topk_score.topk_score_cuda(D, Q, k=k)
        if not bool((ids.cpu() == torch.arange(k)[None, :]).all()):
            raise AssertionError(f"all-tied rows: ids are not 0..{k - 1}")
        checks.append(dict(kernel="topk_score", case="all_tied", k=k, ids_equal=True))
    # row_ids out of order; the smaller tied id sits in a later chunk
    D = torch.zeros(1500, 16, device=dev)
    D[:, 0] = torch.linspace(0.5, 2.0, 1500, device=dev)
    D[3, 0] = D[1200, 0] = 5.0
    ids = torch.randperm(1500, generator=g, device=dev).to(torch.int32) + 100
    ids[3], ids[1200], ids[10] = 50, 7, -1
    Q = torch.zeros(2, 16, device=dev)
    Q[:, 0] = 1.0
    for k in (1, 10, 100):
        s1, i1 = topk_score.topk_score_cuda(D, Q, k=k, row_ids=ids)
        s2, i2 = topk_score.topk_score_plain(D, Q, k=k, row_ids=ids)
        if int(i1[0, 0]) != 7 or not torch.equal(i1.cpu(), i2.cpu()):
            raise AssertionError("row_ids: min-id tie-break or ids differ")
        checks.append(dict(kernel="topk_score", case="row_ids_tie", k=k,
                           max_abs_err=float((s1 - s2).abs().max()), ids_equal=True))
    # gram and pca_project: ragged shapes, f32 and bf16; n = 10 is one row
    # range (no second pass); the mirrored result is exactly symmetric
    for n, d, dtype in [(3001, 200, torch.float32), (5000, 768, torch.bfloat16),
                        (10, 300, torch.float32)]:
        D = randn(n, d).to(dtype)
        got, want = gram.gram_cuda(D), gram.gram_plain(D)
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > 1e-5 or not torch.equal(got, got.T):
            raise AssertionError(f"gram {dtype}: relative error {rel}, or not symmetric")
        checks.append(dict(kernel="gram", n=n, d=d, dtype=str(dtype), rel_err=rel))
        W = randn(d, 130)
        got = pca_project.pca_project_cuda(D, W)
        want = pca_project.pca_project_plain(D, W)
        rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        if rel > (1e-2 if dtype == torch.bfloat16 else 1e-5):
            raise AssertionError(f"pca_project {dtype}: relative error {rel}")
        checks.append(dict(kernel="pca_project", n=n, d=d, m=130, dtype=str(dtype),
                           rel_err=rel))
        if dtype == torch.float32:
            scale = (want.abs().amax(0) / 127.0).contiguous()
            q1 = pca_project.pca_project_quant_cuda(D, W, scale).int()
            q2 = pca_project.pca_project_quant_plain(D, W, scale).int()
            diff = (q1 - q2).abs()
            frac = float((diff != 0).float().mean())
            if int(diff.max()) > 1 or frac > 1e-3:
                raise AssertionError(f"pca_project_quant: {frac} differ")
            checks.append(dict(kernel="pca_project_quant", n=n, d=d, m=130,
                               max_abs_err=int(diff.max()), frac_differ=frac))
    torch.cuda.synchronize()
    emit("edge_cases", checks=len(checks),
         near_ties=sum(c.get("near_ties", 0) for c in checks), results=checks)


def phase_main_path(counters, rows, n_docs):
    """Full-width corpus, fit, prune, int8, search and rescore. Returns the
    indexes, pruner and host queries for the server phase."""
    import numpy as np
    import torch
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.data.synthetic import corpus_on_device
    from repro_torch.kernels import gram, ops, pca_project, topk_score

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    D = corpus_on_device("tasb", n_docs=n_docs, d=DIM, seed=0, device=dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    pruner = StaticPruner(cutoff=CUTOFF).fit(D)               # gram kernel
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    m = pruner.kept_dims
    W, _ = pruner.projection()
    t0 = time.perf_counter()
    pruned = pruner.prune_index(D)                            # pca_project kernel
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    index_f32 = DenseIndex.build(pruned)
    t0 = time.perf_counter()
    index_int8 = DenseIndex.build(pruned, quantize_int8=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = ops.pca_project_quant(D, W, index_int8.scale)     # fused int8 build
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    diff = (fused.view(torch.uint8) != index_int8.vectors.view(torch.uint8))
    frac_fused = float(diff.float().mean())
    del diff

    # queries: perturbed corpus rows, L2-normalised
    g = torch.Generator(device=dev).manual_seed(2)
    nq = SEARCH_BATCHES * BATCH + SERVER_CLOSED + SERVER_OPEN
    rows_q = torch.randint(0, n_docs, (nq,), generator=g, device=dev)
    Qall = D[rows_q] + 0.5 / DIM ** 0.5 * torch.randn(nq, DIM, generator=g, device=dev)
    Qall = Qall / Qall.norm(dim=1, keepdim=True)
    Qs = Qall[:SEARCH_BATCHES * BATCH]

    results = {}
    t0 = time.perf_counter()
    for name, index in (("f32", index_f32), ("int8", index_int8)):
        results[name] = [index.search_projected(Qs[i:i + BATCH], W, k=K)
                         for i in range(0, len(Qs), BATCH)]
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    # exact f32 rescore of one batch's int8 shortlist (row_ids mode)
    qb = Qs[:BATCH]
    _, short = index_int8.search_projected(qb, W, k=SHORTLIST_K)
    short_ids = torch.unique(short[short >= 0]).to(torch.int32)   # ascending
    D_short = index_f32.vectors[short_ids.long()].contiguous()
    qhat = (qb @ W).contiguous()
    rescored = ops.topk_score(D_short, qhat, k=K, row_ids=short_ids)
    torch.cuda.synchronize()
    agree = float((rescored[1].cpu() == results["f32"][0][1].cpu()).float().mean())

    emit("main_path", n=n_docs, d=DIM, m=m, gen_s=t_gen, fit_s=t_fit, prune_s=t_prune,
         quantize_s=t_quant, fused_quant_s=t_fused, search_s=t_search,
         f32_gb=index_f32.nbytes / 1e9, int8_gb=index_int8.nbytes / 1e9,
         fused_vs_two_pass_frac_differ=frac_fused,
         rescore_vs_f32_top10_agree=agree,
         eigenvalue_top3=pruner.state.eigenvalues[:3].tolist())
    if frac_fused > 1e-3:
        raise AssertionError(f"fused int8 build differs on {frac_fused} of entries")

    with counters.uncounted():
        # each kernel against its plain version, and its time, at the shapes
        # this path gave it
        # gram: the plain version run in one fp32 product sums 8.8M rows in
        # one cuBLAS call and is itself off by 2.6e-4 of max |G| (measured,
        # PERF.md). So the kernel is held against the plain version's
        # arithmetic in fp64, over row blocks; the fp32 plain version's own
        # distance from it is printed beside.
        G = gram.gram_cuda(D)
        Gp = gram.gram_plain(D)
        n, d = D.shape
        G64 = torch.zeros((d, d), dtype=torch.float64, device=dev)
        for i in range(0, n, 1 << 20):
            c = D[i:i + (1 << 20)].double()
            G64 += c.T @ c
        del c
        g64 = float(G64.abs().max())
        g_err = float((G.double() - G64).abs().max())
        g_rel = g_err / g64
        plain_rel = float((Gp.double() - G64).abs().max()) / g64
        kernel_vs_plain = float((G - Gp).abs().max()) / float(Gp.abs().max())
        del G64
        emit("gram_check", rel_err_vs_f64=g_rel, plain_f32_rel_err_vs_f64=plain_rel,
             rel_err_vs_plain_f32=kernel_vs_plain, tolerance=GRAM_TOL)
        if g_rel > GRAM_TOL:
            raise AssertionError(f"gram: relative error {g_rel} vs the fp64 Gram")
        rows["gram"] = dict(
            shape=[n, d], max_abs_err=g_err, rel_err=g_rel,
            plain_f32_rel_err_vs_f64=plain_rel, rel_err_vs_plain_f32=kernel_vs_plain,
            ms=cuda_ms(lambda: gram.gram_cuda(D)),
            plain_ms=cuda_ms(lambda: gram.gram_plain(D)),
            library_ms=cuda_ms(lambda: torch.matmul(D.T, D)),
            # G is symmetric: the function needs d (d + 1) / 2 entries of
            # 2 n FLOP each
            bound=bound(4 * n * d + 4 * d * d, n * d * (d + 1)))
        del G, Gp

        blk = D[:262144]                                  # prune_index's block
        Wc = W.contiguous()
        p1 = pca_project.pca_project_cuda(blk, Wc)
        p2 = pca_project.pca_project_plain(blk, Wc)
        p_err = float((p1 - p2).abs().max())
        if not torch.equal(p1, pruned[:262144]) or p_err > 1e-4:
            raise AssertionError(f"pca_project: error {p_err}")
        nb = blk.shape[0]
        rows["pca_project"] = dict(
            shape=[nb, d, m], max_abs_err=p_err,
            ms=cuda_ms(lambda: pca_project.pca_project_cuda(blk, Wc), reps=10),
            plain_ms=cuda_ms(lambda: pca_project.pca_project_plain(blk, Wc), reps=10),
            library_ms=cuda_ms(lambda: torch.matmul(blk, Wc), reps=10),
            bound=bound(4 * nb * d + 4 * d * m + 4 * nb * m, 2 * nb * d * m),
            calls_per_prune=-(-n // 262144))

        sc = index_int8.scale
        qp = pca_project.pca_project_quant_plain(D[:1 << 20], Wc, sc)
        qd = (fused[:1 << 20].int() - qp.int()).abs()
        q_frac = float((qd != 0).float().mean())
        q_max = int(qd.max())
        if q_max > 1 or q_frac > 1e-3:
            raise AssertionError(f"pca_project_quant: {q_frac} differ")
        del qp, qd
        rows["pca_project_quant"] = dict(
            shape=[n, d, m], max_abs_err=q_max, frac_differ=q_frac,
            ms=cuda_ms(lambda: pca_project.pca_project_quant_cuda(D, Wc, sc)),
            # the plain version over all n rows in 2^20-row blocks: at once
            # its f32 temporaries would not fit beside the corpus
            plain_ms=cuda_ms(lambda: [pca_project.pca_project_quant_plain(
                D[i:i + (1 << 20)], Wc, sc) for i in range(0, n, 1 << 20)]),
            library_ms=None,
            bound=bound(4 * n * d + 4 * d * m + 4 * m + n * m, 2 * n * d * m))
        del fused

        from repro_torch.core.index import project_queries
        for name, index in (("f32", index_f32), ("int8", index_int8)):
            q = project_queries(qb, Wc, scale=index.scale).contiguous()
            got = results[name][0]
            want = topk_score.topk_score_plain(index.vectors, q, k=K)
            err, eq, near = compare_topk(*want, *got, f"topk {name} main path")
            item = index.vectors.element_size()
            rows[f"topk_score_{name}"] = dict(
                shape=[n, m, BATCH, K], store=name, max_abs_err=err, ids_equal=eq,
                near_ties=near,
                ms=cuda_ms(lambda: topk_score.topk_score_cuda(index.vectors, q, k=K), reps=10),
                plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(index.vectors, q, k=K),
                                 reps=2),
                library_ms=None,
                matmul_topk_ms=(cuda_ms(lambda: torch.topk(q @ index.vectors.T, K), reps=2)
                                if item == 4 else None),
                bound=bound(item * n * m + 4 * BATCH * m + 8 * BATCH * K,
                            2 * BATCH * n * m))
        want = topk_score.topk_score_plain(D_short, qhat, k=K, row_ids=short_ids)
        err, eq, near = compare_topk(*want, *rescored, "topk row_ids")
        U = D_short.shape[0]
        rows["topk_score_row_ids"] = dict(
            shape=[U, m, BATCH, K], max_abs_err=err, ids_equal=eq, near_ties=near,
            ms=cuda_ms(lambda: topk_score.topk_score_cuda(D_short, qhat, k=K,
                                                          row_ids=short_ids), reps=20),
            plain_ms=cuda_ms(lambda: topk_score.topk_score_plain(D_short, qhat, k=K,
                                                                 row_ids=short_ids), reps=20),
            library_ms=None,
            bound=bound(4 * U * m + 4 * U + 4 * BATCH * m + 8 * BATCH * K,
                        2 * BATCH * U * m))
    del D, pruned
    torch.cuda.empty_cache()
    emit("main_path_vs_plain", **{k: {kk: vv for kk, vv in v.items()}
                                  for k, v in rows.items()})
    return index_f32, index_int8, pruner, Qall[SEARCH_BATCHES * BATCH:].cpu().numpy()


def phase_protocol(n_docs):
    import numpy as np
    import torch
    from repro_torch.convert import pca_state_from_numpy
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.metrics import evaluate_run, wilcoxon_significant
    from repro_torch.core.pruning import StaticPruner
    from repro_torch.data.synthetic import make_dataset

    t0 = time.perf_counter()
    ds = make_dataset("tasb", n_docs=n_docs, d=DIM, seed=0)
    t_data = time.perf_counter() - t0
    metrics = ("nDCG@10", "MRR@10", "AP")

    def run(device, cutoff, state=None):
        D = torch.as_tensor(ds.docs, device=device)
        pruner = None
        if cutoff is not None:
            pruner = StaticPruner(cutoff=cutoff)
            if state is None:
                pruner.fit(D)
            else:
                pruner.state = state
        fitted[cutoff] = pruner
        Dx = pruner.prune_index(D) if pruner else D
        index = DenseIndex.build(Dx)
        out = {}
        for qs, Q in ds.queries.items():
            Qt = torch.as_tensor(Q, device=device)
            Qx = pruner.transform_queries(Qt) if pruner else Qt
            s, ids = index.search(Qx, k=PROTOCOL_DEPTH)
            ids = ids.cpu().numpy()
            out[qs] = (s.cpu(), ids, evaluate_run(
                {i: ids[i].tolist() for i in range(len(ids))}, ds.qrels[qs],
                metrics=metrics))
        return out

    fitted = {}
    t0 = time.perf_counter()
    systems = {c: run("cuda", c) for c in (None, 0.25, 0.5, 0.75)}
    t_card = time.perf_counter() - t0
    table = {}
    for c in (0.25, 0.5, 0.75):
        for qs in ds.queries:
            for name in metrics:
                base = systems[None][qs][2][name]
                got = systems[c][qs][2][name]
                sig, p = wilcoxon_significant(base, got)
                table[f"{int(c * 100)}%/{qs}/{name}"] = dict(
                    value=float(got.mean()), baseline=float(base.mean()),
                    delta=float(got.mean() - base.mean()), significant=sig)
    # the same protocol at cutoff 0.5 on the CPU path (plain versions), with
    # the card's fitted PCA carried across: eigenvectors of near-equal
    # eigenvalues are not unique, so two fits may keep different subspaces
    st = fitted[0.5].state
    t0 = time.perf_counter()
    cpu = run("cpu", 0.5, state=pca_state_from_numpy(
        st.components.cpu().numpy(), st.eigenvalues.cpu().numpy(),
        st.mean.cpu().numpy(), st.n_samples, st.centered, device="cpu"))
    t_cpu = time.perf_counter() - t0
    worst = {}
    for qs in ds.queries:
        s_c, i_c, m_c = cpu[qs]
        s_g, i_g, m_g = systems[0.5][qs]
        compare_topk(s_c[:, :K], torch.as_tensor(i_c[:, :K]),
                     s_g[:, :K], torch.as_tensor(i_g[:, :K]), f"protocol {qs}")
        for name in metrics:
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(m_c[name] - m_g[name]).max()))
    emit("protocol", n_docs=n_docs, d=DIM, depth=PROTOCOL_DEPTH,
         data_s=t_data, card_s=t_card, cpu_check_s=t_cpu,
         card_vs_cpu_max_metric_diff=worst, table=table)


def phase_server(counters, index_f32, index_int8, pruner, Q):
    import numpy as np
    import torch
    from repro_torch.launch.serve import RetrievalServer, _drive, _drive_open, _lat_summary
    W, mean = pruner.projection()
    for name, index in (("int8", index_int8), ("f32", index_f32)):
        server = RetrievalServer(index, pruner, k=K, max_batch=BATCH, pipeline_depth=3)
        try:
            server.warmup()
            wall, lat = _drive(server, Q[:SERVER_CLOSED])
            closed = dict(qps=SERVER_CLOSED / wall, **_lat_summary(lat),
                          **server.worker_stats())
            rate = 2000.0
            res = _drive_open(server, Q[SERVER_CLOSED:], rate=rate, collect=True)
            opened = {k: v for k, v in res.items() if k != "results"}
            opened.update(server.worker_stats())
        finally:
            server.close()
        # replies vs direct search_projected on the same 32-row batches
        tape = Q[SERVER_CLOSED:]
        mismatch = off_scores = 0
        with counters.uncounted():
            for i in range(0, len(tape), BATCH):
                q = torch.as_tensor(tape[i:i + BATCH], device="cuda")
                pad = BATCH - q.shape[0]
                if pad:
                    q = torch.cat([q, q.new_zeros(pad, q.shape[1])])
                s, ids = index.search_projected(q, W, k=K, mean=mean)
                s, ids = s.cpu(), ids.cpu()
                for j, (rs, ri) in enumerate(res["results"][i:i + BATCH]):
                    if not np.array_equal(ri, ids[j].numpy()):
                        mismatch += 1
                    if not np.allclose(rs, s[j].numpy(), rtol=TOL, atol=TOL):
                        off_scores += 1
        if mismatch or off_scores:
            raise AssertionError(f"server {name}: {mismatch} replies' ids and "
                                 f"{off_scores} replies' scores differ from "
                                 f"direct search_projected")
        emit("server", index=name, pipeline_depth=3, batch=BATCH, k=K,
             closed_loop=closed, open_loop=opened, replies_checked=len(tape))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=N_DOCS,
                    help="main-path corpus rows (default: MS MARCO's)")
    ap.add_argument("--protocol-docs", type=int, default=PROTOCOL_DOCS,
                    help="corpus rows of the Table-1 protocol check")
    args = ap.parse_args()
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"the root of a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    smi = phase_device()
    sys.path.insert(0, src)
    import torch
    import repro_torch  # noqa: F401  (sets the fp32 policy)
    phase_build()
    phase_edge_cases()
    counters = Counters()
    rows = {}
    counters.zero()
    t0 = time.perf_counter()
    index_f32, index_int8, pruner, Q = phase_main_path(counters, rows, args.n_docs)
    phase_protocol(args.protocol_docs)
    phase_server(counters, index_f32, index_int8, pruner, Q)
    torch.cuda.synchronize()
    launches = counters.read()
    emit("main_path_launches", seconds=time.perf_counter() - t0, **launches)
    on_path = ("gram", "pca_project", "pca_project_quant", "topk_score_f32",
               "topk_score_int8", "topk_score_row_ids")
    missing = [k for k in on_path if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    def entry(name, row, source, replaces, counter):
        b_ms, b_by = row["bound"]
        extra = ({"cuda_launches": launches[counter + "_cuda"]}
                 if counter + "_cuda" in launches else {})
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[counter], **extra,
                    max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=row["library_ms"],
                    shape=row["shape"],
                    **{k: v for k, v in row.items()
                       if k in ("ids_equal", "near_ties", "rel_err",
                                "plain_f32_rel_err_vs_f64", "rel_err_vs_plain_f32",
                                "frac_differ", "matmul_topk_ms")})
    csrc = "src/repro_torch/csrc/"
    topk = ("src/repro/kernels/topk_score.py:283", csrc + "topk_score.cu")
    kernels = [
        entry("gram", rows["gram"], csrc + "gram.cu",
              "src/repro/kernels/gram.py:41", "gram"),
        entry("pca_project", rows["pca_project"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:56", "pca_project"),
        entry("pca_project_quant", rows["pca_project_quant"], csrc + "pca_project.cu",
              "src/repro/kernels/pca_project.py:79", "pca_project_quant"),
        entry("topk_score", rows["topk_score_f32"], topk[1], topk[0], "topk_score_f32"),
        entry("topk_score_int8", rows["topk_score_int8"], topk[1], topk[0],
              "topk_score_int8"),
        entry("topk_score_row_ids", rows["topk_score_row_ids"], topk[1], topk[0],
              "topk_score_row_ids"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # make_dataset keys its generators on hash(str): pin the hash seed so the
    # protocol's dataset is the same from run to run
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    main()
