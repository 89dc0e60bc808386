"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
comparison read beside its limit. The same checks end standard error.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; any other failure exits 1; a run that finds JAX or the
JAX package loaded after its window exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bench import harness, imports_check

    now, age = time.perf_counter(), harness.process_age()
    t_start = now - age if age is not None else T_START
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               t_start=t_start)
    except harness.RunError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2 if isinstance(e, harness.NoDevice) else 1
    except Exception:   # noqa: BLE001 — report and fail without a result
        traceback.print_exc()
        return 1
    breaches = imports_check.loaded()
    if breaches:
        print(f"bench: JAX or the JAX package is loaded: {breaches}", file=sys.stderr)
        return 3
    scanned = imports_check.scan(ROOT / "bench")
    if scanned:
        print("bench: " + "; ".join(scanned), file=sys.stderr)
        return 3
    print(json.dumps(out, allow_nan=False), flush=True)
    print_checks(out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
