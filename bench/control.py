"""The comparison's control: the reference itself, put in the program's place
one precision below what the configuration states, must come out not
correct; so must a fit over half the corpus's rows.

    python3 bench/control.py --workload <cell> --seeds 1,2,3

For an f32 configuration the control runs the whole reference (fit,
projection, scores) in TF32 (operands rounded to 10 mantissa bits, fp32
accumulation). An int8 configuration has two: int4 (±7) storage, and the
int8 index fitted, built and scored in TF32. The fault ``half_rows`` is the
fp64 reference fitted over the first half of the rows and searched in fp64:
its search matches a reference under its own ``W_m``, so only the fit's
numbers can catch it. Each side's top-k lists for the cell's depth, for a
sample of the cell's queries drawn from each seed, are judged against the
fp64 reference by ``compare.py`` with the configuration's limits, and its
``W_m`` against the fp64 spectrum; one JSON line a seed and a side gives the
readings. The benchmark's own runs never run it; it sets the limits' upper
readings (PERF.md). Needs no program: it imports nothing of it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT)]

SAMPLE = 512
CONTROLS = {
    "float32": {"tf32": dict(precision="tf32", store="float32")},
    "int8": {"int4": dict(precision="fp64", store="int4"),
             "tf32": dict(precision="tf32", store="int8")},
}


def readings(cell, seed: int, device, sample: int = SAMPLE) -> list[dict]:
    """One verdict a side (each control, then ``half_rows``) for ``seed``."""
    import numpy as np

    from bench import compare, data
    from bench.reference import Reference, Spectrum, fit

    cfg, k, m = cell.config, int(cell.traffic["k"]), int(cell.config["m"])
    store = cfg["store"]
    gen = data.generator(seed, device)
    D = data.corpus(cfg, gen, device)
    Q = data.queries(D, sample, float(cell.traffic["query_noise"]), gen)
    spectrum = Spectrum(D)
    sides = {name: (how, fit(D, m, precision=how["precision"]))
             for name, how in CONTROLS[store].items()}
    sides["half_rows"] = (dict(precision="fp64", store=store), fit(D[: D.shape[0] // 2], m))
    out = []
    for name, (how, W) in sides.items():
        side = Reference(D, W, **how)
        s, i = side.topk(Q, k)
        # scores as the side computed them: fp64 ones rounded to f32 would tie
        s, i = s.cpu().numpy(), i.cpu().numpy().astype(np.int64)
        del side
        ref = Reference(D, W, store=store)
        values = dict(unanswered=0.0, **compare.readings(s, i, Q, ref, k),
                      **spectrum.readings(W))
        del ref
        correct, checks = compare.verdict(values, cfg["limits"])
        out.append(dict(seed=seed, side=name, how=how, correct=correct, checks=checks))
    return out


def main(argv=None) -> int:
    import torch

    from bench.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        for out in readings(cell, seed, device):
            print(json.dumps(dict(workload=cell.name, **out), default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
