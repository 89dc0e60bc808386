"""Find a cell's knee: the highest swept rate the server sustains.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 1000,2000,...

Builds the cell's deployment once, then drives one open-loop window at each
rate in turn (the cell's traffic mix, arrivals from ``--seed``) and prints
a JSON line a rate: the share answered, p50 / p95, the live queries a
batch, and the backlog (requests submitted and not yet answered) at the
window's middle and at its end. A rate is sustained when every request is
answered, the backlog at the end is no larger than at the middle, or than
what the server holds in flight (``max_batch`` x ``pipeline_depth``), and
the median latency is at most ``SLOW`` times the first (lowest) rate's: a
queue that grows in bursts and drains before the window's end passes the
backlog test, not this one. The last line names the knee, the highest rate
sustained with every lower rate sustained too. Sweep two seeds and take the
lower knee. No correctness check runs here; the cell's runs make it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

SLOW = 1.5   # a sustained rate's p50 against the lowest rate's


def backlog(submit, done, t) -> int:
    return int((submit <= t).sum() - (done <= t).sum())


def main(argv=None) -> int:
    import numpy as np
    import torch

    from bench import data, harness, traffic
    from bench.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]

    cell = load_cell(args.workload)
    device = harness.devices(cell)
    import repro_torch  # noqa: F401  (the program's fp32 policy)
    gen = data.generator(args.seed, device)
    dep, D = harness.build(cell, gen, device)
    most = traffic.count(max(rates), args.seconds)
    tape = data.queries(D, most, float(cell.traffic["query_noise"]), gen).cpu().numpy()
    del D
    torch.cuda.empty_cache()
    server, _ = harness.start_server(cell, dep)
    in_flight = int(cell.server["max_batch"]) * int(cell.server["pipeline_depth"])
    harness.settle()
    knee, base, held = None, None, True
    try:
        for i, rate in enumerate(rates):
            offsets = traffic.arrivals(cell.traffic, rate, args.seconds, args.seed + i)
            server.reset_stats()
            drove = harness.drive(server, tape[:len(offsets)], offsets)
            t0, done = drove["t0"], drove["done"]
            answered = int((~np.isnan(done)).sum())
            lat = np.where(np.isnan(done), np.inf, done - (t0 + offsets)) * 1e3
            mid = backlog(drove["submit"], done, t0 + args.seconds / 2)
            end = backlog(drove["submit"], done, t0 + args.seconds)
            p50 = float(np.percentile(lat, 50))
            base = p50 if base is None else base
            ok = answered == len(offsets) and end <= max(mid, in_flight) and p50 <= SLOW * base
            sizes = np.array([b for b, _, _ in server.batch_log])
            buckets = {f"<={c}": int(((sizes <= c) & (sizes > (0 if c == 8 else c // 2))).sum())
                       for c in (8, 16, 32)}
            held &= ok
            knee = rate if held else knee
            print(json.dumps(dict(rate=rate, sent=len(offsets), answered=answered,
                                  p50_ms=p50,
                                  p95_ms=float(np.percentile(lat, 95)),
                                  mean_batch=server.worker_stats()["mean_batch"],
                                  batches=buckets, backlog_mid=mid, backlog_end=end,
                                  sustained=ok)),
                  flush=True)
    finally:
        server.close()
    print(json.dumps(dict(workload=cell.name, knee=knee,
                          device=torch.cuda.get_device_name(device),
                          power=harness.power_limit())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
