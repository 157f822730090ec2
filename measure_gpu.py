#!/usr/bin/env python3
"""Production path against host-engine path on one NVIDIA GPU.

    python3 measure_gpu.py [--runs N] [--profile-only]
                           [--device-verify auto|on|off|on,off]

The same two genes as chip_smoke.py (the 60-allele toy and the
3,600-allele scale panel), both paths of hgtpu_torch.pipeline.type_reads
(the production path, "auto" on CUDA, and the host engine,
device_typing="off"), each with the aligner's device verify as
--device-verify says ("auto", the default, is on for CUDA: the banded DP
kernel scores the rank-0 proposals beside the native verifier; a comma
list runs each setting, in turns with the others).  After two warm-up
runs per variant (path and device-verify setting) and gene, N timed runs
per gene (default 7) with the variants in turns (forward, then
backward, ...); host clock around type_reads ending in a synchronise;
TRACE.reset() before each.  Prints per gene and variant the median, best
and worst wall, reads/s at the median, each TRACE stage's median over the
runs (rescue.align and the verify.* stages always among them: with device
verify on, verify.dp_codes, verify.dp_pad, verify.device_dp and
verify.dp_apply are its host side and its launch) and the (E, W) shapes
of the DP launches in the last run.  Then one run each of
prod-scale, prod-toy and host-scale per setting under torch.profiler
(CPU + CUDA): device busy share (the kernel events' device time over the
wall; summing key_averages() would count each kernel twice, under its
aten op too) and the largest device items.  nvidia-smi's name, power
limit, SM clock and draw open and close each part.  Needs one CUDA card;
builds the kernels like chip_smoke.py.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("measure_gpu: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from chip_smoke import build_gene, reads_of
    from hgtpu_torch.utils.trace import TRACE
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.ops import banded_dp as tdp
    from hgtpu_torch.ops import cuda_lib
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions

    n_runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 7
    dvs = sys.argv[sys.argv.index("--device-verify") + 1].split(",") \
        if "--device-verify" in sys.argv else ["auto"]
    dev = torch.device("cuda")
    cuda_lib.build()
    cuda_lib.load()
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                   capture_output=True)
    print(smi(), flush=True)
    toy = build_gene(60, 3000, scale=False)
    t1, t2 = reads_of(toy, toy.allele_names[:4], seed=0)
    big = build_gene(3600, 3500, scale=True)
    b1, b2 = reads_of(big, [big.allele_names[123], big.allele_names[2047]],
                      seed=1)
    cells = {"toy": (toy, t1, t2, {dv: GeneAligner(toy, device=dev,
                                                   device_verify=dv)
                                   for dv in dvs}),
             "scale": (big, b1, b2, {dv: GeneAligner(big, device=dev,
                                                     device_verify=dv)
                                     for dv in dvs})}
    paths = {"host": TypingOptions(simulation=True, device_typing="off"),
             "prod": TypingOptions(simulation=True)}
    variants = [(path, dv) for path in paths for dv in dvs]
    dp_shapes = []
    real_costs = tdp.BandedDPTables.costs

    def dp_spy(self, reads, *args, **kw):
        dp_shapes.append(tuple(reads.shape))
        return real_costs(self, reads, *args, **kw)

    tdp.BandedDPTables.costs = dp_spy

    def run(cell, variant):
        path, dv = variant
        gene, r1, r2, als = cells[cell]
        TRACE.reset()
        del dp_shapes[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        type_reads(gene, r1, r2, paths[path], aligner=als[dv])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, TRACE.summary(), list(dp_shapes)

    def name(variant):
        return "%s dv=%s" % variant

    for cell in cells:
        for v in variants:
            run(cell, v)
            run(cell, v)
    for cell in ([] if "--profile-only" in sys.argv else cells):
        n = len(cells[cell][1]) + len(cells[cell][2])
        walls = {v: [] for v in variants}
        stages = {v: {} for v in variants}
        last = {}
        for i in range(n_runs):
            for v in (variants if i % 2 == 0 else variants[::-1]):
                w, st, shapes = run(cell, v)
                walls[v].append(w)
                for k, x in st.items():
                    stages[v].setdefault(k, []).append(x["s"])
                last[v] = shapes
        for v, ws in walls.items():
            med = statistics.median(ws)
            print(cell, name(v), json.dumps(dict(
                reads=n, median_s=med, best_s=min(ws), worst_s=max(ws),
                reads_s=n / med, walls=ws)), flush=True)
            # each stage's median over the runs (a stage a run skipped
            # counts 0 there)
            st = {k: statistics.median(x + [0.0] * (n_runs - len(x)))
                  for k, x in stages[v].items()}
            top = sorted(st.items(), key=lambda kv: -kv[1])[:14]
            top += [(k, st[k]) for k in sorted(st)
                    if (k == "rescue.align" or k.startswith("verify."))
                    and k not in dict(top)]
            print("  stages (median of the runs):",
                  ", ".join("%s %.4f" % kv for kv in top), flush=True)
            print("  DP launches (last run), (E, W):", last[v], flush=True)
    print(smi(), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for cell, v in [(c, (p, dv)) for dv in dvs
                    for c, p in (("scale", "prod"), ("toy", "prod"),
                                 ("scale", "host"))]:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w, _st, _shapes = run(cell, v)
        kern = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time for e in kern) / 1e6
        by = {}
        for e in kern:
            t, c = by.get(e.name, (0.0, 0))
            by[e.name] = (t + e.device_time / 1e3, c + 1)
        items = sorted(by.items(), key=lambda kv: -kv[1][0])
        print("profile %s %s: wall %.4f s, device busy %.4f s (%.1f %%), "
              "%d kernels" % (cell, name(v), w, busy, 100 * busy / w,
                              len(kern)), flush=True)
        for k, (t, c) in items[:14]:
            print("   %9.3f ms %6d  %s" % (t, c, k[:110]), flush=True)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
