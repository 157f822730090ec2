"""The control of a cell's comparison: the plain reference put in the
program's place with one stated guarantee broken, every read pair of the
sample typed (it types every other pair).  Prints, per seed, the
numbers check.py compares beside the cell's limits; each has to exceed
its limit.  Nothing of the program runs.

    python benchmark/control.py --workload <cell> --seeds 1,2,3
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def readings(cfg, mix, seed, n_samples):
    import check
    import gen
    import reference

    specs = gen.catalog_specs(cfg)
    genes = [reference.RefGene(g, s) for g, s in specs.items()]
    placer = reference.Placer(genes)
    worst = dict.fromkeys(check.NAMES, 0.0)
    for i in range(n_samples):
        _, r1, r2 = gen.draw_sample(specs, mix, seed, i)
        want = reference.type_sample(genes, placer, r1, r2)
        half = reference.type_sample(genes, placer, r1[::2], r2[::2])
        got = check.numbers(half, want)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst


def main(argv=None):
    import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _, cell, cfg, mix, _ = run.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        got = readings(cfg, mix, seed, mix["check_samples"])
        print(json.dumps(dict(workload=cell["name"], seed=seed, control={
            k: dict(value=got[k], limit=v)
            for k, v in cfg["limits"].items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
