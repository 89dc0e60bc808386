"""Time the store's load path and its durable append on the card's machine.

    python src/repro_torch/benchmarks/store_io.py [--src SRC] [--n-docs N]
                                                  [--dim M] [--reps R]
                                                  [--appends A] [--dir DIR]

Writes an int8 store of N random rows of width M (``save_index`` of an
index drawn on the card, 262,144-row chunks) under DIR, then, in turns for
R rounds with the page cache warm:
  * ``load``: ``DenseIndex.load`` onto the card, ending in a synchronise;
  * ``read_mmap``: the read side alone, each memory-mapped chunk copied
    into two pinned 64 MiB buffers in turn (no device copy);
  * ``read_file``: the same bytes read with ``readinto`` from the file
    into the same buffers;
  * ``h2d``: the device side alone, the buffers' bytes copied to the card
    in 64 MiB pieces.
Each is reported in GB/s (the index's bytes over the median time). Then
one ``load`` with the page cache dropped (``posix_fadvise``), and A
durable appends of 64 int8 rows to a delta segment (``IndexStore.append``:
the blob, the manifest swap and three fsyncs), timed as they are and with
the fsync calls replaced by no-ops, which isolates what durability costs.
Prints one JSON line with the card's name and power limit. ``--src`` names
the source tree whose ``repro_torch`` is imported, so two trees can be
timed in turns on one card.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="source tree holding repro_torch (default: this one)")
    ap.add_argument("--n-docs", type=int, default=8_841_823)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--appends", type=int, default=100)
    ap.add_argument("--dir", default=os.path.join("build", "store_io"))
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, args.src)
    else:
        from pathlib import Path
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch
    from repro_torch.core import store as store_mod
    from repro_torch.core.index import DenseIndex
    from repro_torch.core.store import save_index

    if not torch.cuda.is_available():
        sys.exit("store_io: needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, m = args.n_docs, args.dim
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    path = os.path.join(args.dir, "int8")
    idx = DenseIndex(torch.randint(-127, 128, (n, m), generator=g, device=dev,
                                   dtype=torch.int8),
                     scale=torch.rand(m, generator=g, device=dev) / 127)
    st = save_index(path, idx)
    files = [os.path.join(path, c["file"]) for c in st.manifest["chunks"]]
    nbytes = n * m
    stage = 64 << 20
    ring = [torch.empty(stage, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    views = [b.numpy() for b in ring]
    dbuf = torch.empty(nbytes, dtype=torch.uint8, device=dev)

    def load():
        out = DenseIndex.load(st)
        torch.cuda.synchronize()
        assert torch.equal(out.vectors, idx.vectors)

    def read_mmap():
        i = 0
        for f in files:
            flat = np.load(f, mmap_mode="r").reshape(-1)
            for lo in range(0, flat.size, stage):
                part = flat[lo:lo + stage]
                views[i % 2][:part.size] = part
                i += 1

    def read_file():
        i = 0
        for f in files:
            offset = np.load(f, mmap_mode="r").offset
            with open(f, "rb", buffering=0) as fh:
                fh.seek(offset)
                while True:
                    got = fh.readinto(memoryview(views[i % 2]))
                    i += 1
                    if not got:
                        break

    def h2d():
        for lo in range(0, nbytes, stage):
            hi = min(lo + stage, nbytes)
            dbuf[lo:hi].copy_(ring[(lo // stage) % 2][:hi - lo], non_blocking=True)
        torch.cuda.synchronize()

    runs = {"load": load, "read_mmap": read_mmap, "read_file": read_file, "h2d": h2d}
    times = {k: [] for k in runs}
    for fn in runs.values():                       # warm the page cache
        fn()
    for r in range(args.reps):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for name in order:
            t0 = time.perf_counter()
            runs[name]()
            times[name].append(time.perf_counter() - t0)
    out = {k: dict(gb_per_s=nbytes / float(np.median(v)) / 1e9,
                   s_median=float(np.median(v))) for k, v in times.items()}
    for f in os.listdir(path):
        fd = os.open(os.path.join(path, f), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    t0 = time.perf_counter()
    load()
    out["load_cold"] = dict(gb_per_s=nbytes / (time.perf_counter() - t0) / 1e9,
                            s=time.perf_counter() - t0)
    del dbuf, idx
    torch.cuda.empty_cache()

    # durable appends, as they are and with fsync made a no-op
    blocks = np.random.default_rng(0).integers(-127, 128, (args.appends, 64, m),
                                               dtype=np.int8)
    app = {}
    real = (store_mod.fsync_file, store_mod.fsync_dir, store_mod.write_json_fsync)

    def write_json(p, obj):
        with open(p, "w") as f:
            json.dump(obj, f)

    for mode in ("durable", "no_fsync", "durable_again"):
        seg = st.add_delta(scale=np.ones(m, np.float32), capacity=args.appends * 64)
        if mode == "no_fsync":
            store_mod.fsync_file = store_mod.fsync_dir = lambda p: None
            store_mod.write_json_fsync = write_json
        ts = []
        try:
            for b in blocks:
                t0 = time.perf_counter()
                st.append(b, segment=seg)
                ts.append((time.perf_counter() - t0) * 1e3)
        finally:
            store_mod.fsync_file, store_mod.fsync_dir, store_mod.write_json_fsync = real
        app[mode] = dict(ms_median=float(np.median(ts)),
                         ms_p90=float(np.percentile(ts, 90)))
    app["manifest_chunks_at_end"] = len(st.manifest["chunks"])
    shutil.rmtree(args.dir)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps(dict(src=args.src or "this tree", n_docs=n, dim=m, reps=args.reps,
                          bytes=nbytes, card=smi.stdout.strip(), **out,
                          append_64_rows=app)), flush=True)


if __name__ == "__main__":
    main()
