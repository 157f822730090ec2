"""One run of one benchmark cell of hgtpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(configs/<file>.json, naming the system module under systems/ that
builds and calls the program) under a traffic mix (mixes/<name>.json).
One client types samples back to back, as a lab types a cohort: the next
sample starts when the previous call has returned and synchronised.

Set-up (timed as setup_s, from process start to the first timed sample):
the program's catalogs (cached under benchmark/.cache/, keyed by the
configuration, the program's catalog builder sources, the system module
and the generator that lays the catalogs out), the system on
cuda:0, WARMUP samples of the cell's own shapes (the first pays the
program's table builds), then a pool of distinct samples, POOL_FACTOR
times as many as the last warm-up's time fits into the window.  The
window lasts --seconds and types only samples of the pool; a sample that
starts before the deadline finishes, and the window ends at the last
completion.  Objects made in set-up are frozen out of the collector
for the window, and BLAS, OpenMP and torch's intra-op pool keep one
thread each.

After the window the program's state is freed and the plain reference
(reference.py) types a sample of the window's samples drawn from the
seed, the one with the most reads among them; check.py compares.  With
--trace 1 the run reports the per-layer metrics (layer_metrics/<name>.py)
from the program's TRACE spans over the whole window and a torch.profiler
trace over the first `profile_samples` samples.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "hgtpu")
WARMUP = 2          # the first call builds the program's tables
POOL_FACTOR = 3     # the fastest samples run ~0.6x the median's time


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)


class CellError(RuntimeError):
    pass


def load_cell(name, bench_path=None):
    """(BENCHMARK.json, cell entry, configuration dict, mix dict)."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError("no cell %r in %s" % (name, bench_path))
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = os.path.dirname(os.path.abspath(bench_path))
    with open(os.path.join(base, configs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(base, "benchmark", "mixes",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return bench, cell, cfg, mix, os.path.join(base, "benchmark")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_key(cfg, *files):
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for path in sorted(files):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:20]


def cached(path, make):
    """make()'s value, pickled at path by this benchmark's own earlier
    run in this checkout, or made and stored now."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    value = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return value


def program_sources():
    import hgtpu_torch

    pkg = os.path.dirname(os.path.abspath(hgtpu_torch.__file__))
    db = os.path.join(pkg, "db")
    return [os.path.join(db, f) for f in os.listdir(db) if f.endswith(".py")]


def build_native():
    """The native verifier and the CUDA kernels, built when missing."""
    if not os.path.exists(os.path.join(ROOT, "native",
                                       "libhgtpu_native.so")):
        subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "native")],
                       check=True, stdout=subprocess.DEVNULL)
    from hgtpu_torch.ops import cuda_lib

    cuda_lib.build()


def p90(values):
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def run(args, device="cuda", bench_path=None, fault=None):
    """One run; returns (result line, readings, run info, limits).
    `device` and `fault` serve the tests: a CPU device, and a function
    that wraps the system's call to break it underneath the harness."""
    import numpy as np

    bench, cell, cfg, mix, where = load_cell(args.workload, bench_path)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    import torch

    if device == "cuda":
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise CellError("needs %d CUDA device(s), found %s"
                            % (cell["chips"], torch.cuda.device_count()
                               if torch.cuda.is_available() else 0))
        build_native()
    import gen
    import check
    import reference

    system = load_module(os.path.join(where, "systems",
                                      cfg["system"] + ".py"),
                         "bench_system_" + cfg["system"])
    specs = gen.catalog_specs(cfg)
    key = cache_key(cfg, *program_sources(),
                    os.path.join(where, "systems", cfg["system"] + ".py"),
                    os.path.join(HERE, "gen.py"))
    catalog = cached(os.path.join(CACHE, "program-%s.pkl" % key),
                     lambda: system.catalog(cfg, specs))
    dev = torch.device(device + ":0" if device == "cuda" else device)
    typer = system.System(catalog, cfg, dev)
    if fault is not None:
        typer = fault(typer)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    warm = []
    for i in range(WARMUP):
        _, r1, r2 = gen.draw_sample(specs, mix, args.seed, i, salt=1)
        t = time.perf_counter()
        typer(r1, r2)
        sync()
        warm.append(time.perf_counter() - t)
    n_pool = int(math.ceil(POOL_FACTOR * args.seconds
                           / max(warm[-1], 1e-3))) + 2
    pool = gen.Pool(specs, mix, args.seed)
    pool.fill(n_pool)
    # what set-up made lives through the window: the pool's (name, read)
    # tuples, millions on a capture-depth cell, stay out of the
    # collector's full passes, which would walk them all
    gc.freeze()

    rec = None
    prof = None
    if args.trace:
        import spans
        import hgtpu_torch.ops.placement as placement
        from hgtpu_torch.utils.trace import TRACE

        rec = spans.Recorder()
        rec.install(TRACE, placement)
    n_prof = mix["profile_samples"] if args.trace else 0

    results, times = [], []
    failed = 0
    first_failure = None
    gc_s = [0.0, None]

    def gc_clock(phase, _info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        elif gc_s[1] is not None:
            gc_s[0] += time.perf_counter() - gc_s[1]
    gc.callbacks.append(gc_clock)
    sync()
    t_w0 = time.perf_counter()
    setup_s = time.time() - T_START
    deadline = t_w0 + args.seconds
    k = 0
    while time.perf_counter() < deadline:
        if k >= len(pool.samples):
            raise CellError("the pool of %d samples ran out inside the "
                            "window" % k)
        r1, r2 = pool.samples[k]
        if k == 0 and n_prof:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            rec.profiling = rec.k1_on = True
        rf = None
        if prof is not None:
            rf = torch.profiler.record_function("bench.sample")
            rf.__enter__()
        t = time.perf_counter()
        try:
            res = typer(r1, r2)
            sync()
        except Exception as e:      # a failed call counts; the run goes on
            print("sample %d failed: %r" % (k, e), file=sys.stderr)
            failed += 1
            if first_failure is None:
                first_failure = ("%s: %s" % (type(e).__name__, e))[:200]
            res = None
        times.append(time.perf_counter() - t)
        if rf is not None:
            rf.__exit__(None, None, None)
        results.append(None if res is None else
                       {g: check.as_dict(r) for g, r in res.items()})
        k += 1
        if prof is not None and k == n_prof:
            sync()
            prof.__exit__(None, None, None)
            rec.profiling = rec.k1_on = False
            prof_done, prof = prof, None
    t_w1 = time.perf_counter()
    gc.callbacks.remove(gc_clock)
    gc.unfreeze()
    if prof is not None:
        prof.__exit__(None, None, None)
        rec.profiling = rec.k1_on = False
        prof_done = prof
    window = t_w1 - t_w0
    n = len(times)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    bad = forbidden_modules()
    if bad:
        raise CellError("loaded after the window: %s" % ", ".join(bad))

    layer = {}
    breakdown = None
    dev_extra = {}
    if args.trace:
        rec.uninstall()
        import devtrace
        import peaks

        names = {s[0] for s in rec.spans} | {"bench.sample"}
        red = devtrace.reduce(prof_done, names)
        ctx = dict(spans=rec.spans, samples=n, window=(t_w0, t_w1),
                   profile=red, k1=rec.k1, profiled=min(n, n_prof),
                   peak=peaks.PEAKS.get(kind))
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            reader = load_module(os.path.join(where, "layer_metrics",
                                              m["name"] + ".py"),
                                 "bench_metric_" + m["name"])
            v = reader.read(ctx)
            if v is not None:
                layer[m["name"]] = dict(value=v, unit=m["unit"])
        if red is not None:
            dev_extra = dict(busy_s=red["busy_s"], window_s=red["window_s"])
            breakdown = dict(device_ops=red["device_ops"],
                             idle_gaps=red["idle_gaps"])

    # the reference runs with the program's state freed
    del typer, catalog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(
        np.random.SeedSequence([int(args.seed) & (2 ** 64 - 1), 7]))
    done = [i for i, r in enumerate(results) if r is not None]
    picked = []
    if done:
        longest = max(done, key=lambda i: len(pool.samples[i][0]))
        rest = [i for i in done if i != longest]
        take = min(mix["check_samples"] - 1, len(rest))
        picked = sorted([longest] + rng.choice(rest, take, replace=False)
                        .tolist())
    t_ref = time.perf_counter()
    genes = cached(os.path.join(CACHE, "reference-%s.pkl" % cache_key(
        cfg, os.path.join(HERE, "reference.py"),
        os.path.join(HERE, "gen.py"))),
        lambda: [reference.RefGene(g, s) for g, s in specs.items()])
    placer = reference.Placer(genes)
    readings = dict.fromkeys(check.NAMES, 0.0)
    for i in picked:
        r1, r2 = pool.samples[i]
        ref = reference.type_sample(genes, placer, r1, r2)
        got = check.numbers(results[i], ref)
        for name in readings:
            readings[name] = max(readings[name], got[name])
    ref_s = time.perf_counter() - t_ref
    correct = bool(picked) and failed == 0 and \
        check.verdict(readings, cfg["limits"])

    if args.trace:
        metrics = layer
    else:
        metrics = {"samples_per_s": dict(value=n / window,
                                         unit="samples/s"),
                   "setup_s": dict(value=setup_s, unit="s")}
        ends = {m["name"] for m in bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
        if "sample_p90_s" in ends:
            metrics["sample_p90_s"] = dict(value=p90(times),
                                           unit="s")
    device_out = dict(platform="gpu" if dev.type == "cuda" else "cpu",
                      kind=kind, count=cell["chips"],
                      memory_peak_bytes=peak, **dev_extra)
    out = dict(correct=correct, attempted=n, failed=failed,
               first_failure=first_failure, metrics=metrics,
               device=device_out)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: dict(value=readings[k], limit=v)
                       for k, v in cfg["limits"].items()}
    info = dict(samples=n, window_s=window, checked=picked,
                sample_s=[min(times), statistics.median(times), max(times)],
                sample_mean_s=statistics.fmean(times),
                sample_sd_s=statistics.stdev(times) if n > 1 else 0.0,
                gc_s=gc_s[0],
                reference_s=ref_s, warmup_s=warm, pool=len(pool.samples))
    return out, readings, info, cfg["limits"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: BLAS and OpenMP pools of one thread,
    # set before numpy or torch loads, so that a neighbour's load on the
    # host's shared cores stalls one thread and not a pool
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        out, readings, info, limits = run(args)
    except CellError as e:
        print("benchmark: %s" % e, file=sys.stderr)
        return 2
    import check

    print("run: %s" % json.dumps(info), file=sys.stderr)
    for line in check.lines(readings, limits):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
