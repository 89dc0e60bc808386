"""Time one 64-row append to a paged index at full width on the card.

    python src/repro_torch/benchmarks/paged_append.py [--src SRC] [--n-docs N]
                                                      [--dim M] [--appends A]

Builds an f32 and an int8 index of N random rows of width M on the card
(no fit: an append's cost depends on the page count and the width, not on
the values), pages each in 256-row pages sealing at 4,096 rows, then times
A appends of 64 rows (host clock around ``PagedIndex.append_with_ops``,
which ends in a synchronise) after three warm-up appends. Prints one JSON
line with the median and 90th percentile, how many appends widened an
int8 scale (a requantisation of the open extent), and the card's name and
power limit.
``--src`` names the source tree whose ``repro_torch`` is imported, so two
trees can be timed in turns on one card.
"""
import argparse
import json
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="source tree holding repro_torch (default: this one)")
    ap.add_argument("--n-docs", type=int, default=8_841_823)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--appends", type=int, default=40)
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, args.src)
    else:
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.paged import PagedIndex

    if not torch.cuda.is_available():
        sys.exit("paged_append: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, m = args.n_docs, args.dim
    rows = np.random.default_rng(0).standard_normal(
        (args.appends + 3, 64, m)).astype(np.float32) / m ** 0.5
    out = {}
    for store in ("f32", "int8"):
        if store == "f32":
            base = DenseIndex(torch.randn(n, m, generator=g, device=dev) / m ** 0.5)
        else:
            base = DenseIndex(torch.randint(-127, 128, (n, m), generator=g, device=dev,
                                            dtype=torch.int8),
                              scale=torch.rand(m, generator=g, device=dev) / 127 / m ** 0.5)
        pg = PagedIndex.from_index(base, page_rows=256, seal_rows=4096)
        del base
        times, widens = [], 0
        for i, blk in enumerate(rows):
            t0 = time.perf_counter()
            pg, ops = pg.append_with_ops(blk)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
                widens += any(op[0] == "widen" for op in ops)
        out[store] = dict(append_ms_median=float(np.median(times)),
                          append_ms_p90=float(np.percentile(times, 90)),
                          widening_appends=widens, pages=pg.total_pages)
        del pg
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps(dict(src=args.src or "this tree", n_docs=n, dim=m, block=64,
                          appends=args.appends, card=smi.stdout.strip(), **out)),
          flush=True)


if __name__ == "__main__":
    main()
