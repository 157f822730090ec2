#!/usr/bin/env python3
"""Quickest proof that hgtpu_torch starts, and is right, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives both of the port's typing paths through
hgtpu_torch.pipeline.type_reads and checks them phase by phase:

  * the production path ("auto" on CUDA, the main path): the place pass
    on kernel K1, the spell pass, the host pileup merge, the count pass
    (pileup gate, compatibility products, class dedup), the host
    rescue of the punt mask with the device fold on kernel K2, the
    staged EM;
  * the host-engine path (device_typing="off"): placement on K1, host
    verify, haplotypes, the device fold on K2, the staged EM.

Phases:

  card       nvidia-smi's name and power limit
  build      nvcc builds the kernels from hgtpu_torch/csrc (and make
             builds the native verifier); build time and ptxas report
  K1         placement scores (wgmma), kernel vs plain torch on the card:
             the host path's shape (N = 8192, m = 128) and the place
             pass's (N = 7,168 reads of m = 100 against the scale panel's
             pwm_ext, P + 100 rows); exact; times beside the plain
             version's.  Exact at m = 1024 too; place_scan_batch buffers
             on the card vs the CPU
  warm-up    one run of each path and gene on the card, recording every
             K1 and K2 call (the place pass, the fused spell, the
             rescue's realignment, both folds) and compat_mxu's products
  K1, K2     every distinct operand shape recorded in the warm-ups,
             kernel vs plain on the recorded operands, exact (K1) and
             bitwise (K2); K2 timed at the largest H x K
  compat     compat_mxu's product at prod-scale's shape (bf16 operands,
             float32 output) equals the float64 product: exact counts
  toy/scale  host-engine path: 60-allele gene (4 truths) and the
             3,600-allele / 3.5 kb panel (het pair, ~13 k reads); equal
             to the CPU host-fold run, truths on top; warm wall, reads/s
  prod-toy   production path on the toy (fused spelling branch) and the
  prod-scale scale panel (tiered branch): routed through
             type_reads_device; equal to the CPU host-fold run (cmpt and
             exon cmpt exact, primary cmpt exact on a type_primary_exons
             run, num_reads, num_pairs and counts exact, prob within 1e-9
             with the same ranking); truths on top; warm wall, reads/s,
             punt count, TRACE stages
  proof      launch counts of each path's runs (counts set to 0 just
             before the path, read just after): K1 > 0 on both paths, K2
             > 0 on the host path and on prod-scale whenever its rescue
             reached the fold; jax never imported

Every failure raises: nothing is caught and carried on, and there is no
CPU fallback.  Exits non-zero without a CUDA device or without the repo
beside it.  The last three lines of standard output are the kernels'
JSON record, the card's name and power limit, and the device JSON.
Each kernel's record holds ms / plain_ms at the shape in `shape` (K1 at
the host path's N = 8192, m = 128, as since it was first timed; K2 at
the largest H x K), K1's place-pass time as place_ms / place_plain_ms
(`place_shape`), and max_abs_err over every shape checked
(`shapes_checked` distinct shapes from the paths).
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

STAGES = ("device.place", "device.spell", "device.countB", "device.rescue",
          "device.merge", "type.em")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def build_gene(n_alleles, length, scale):
    from synth import make_gene_msa, make_hla_scale_msa
    from hgtpu.db import build_gene_ref

    spec = make_hla_scale_msa(n_alleles=n_alleles, length=length) if scale \
        else make_gene_msa(seed=11, n_alleles=n_alleles, length=length)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


def reads_of(gene, truths, seed):
    from hgtpu.sim import simulate_reads

    r1, r2, _ = simulate_reads(gene, truths, simulate_interval=1, seed=seed)
    return [(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2]


FIELDS = ("cmpt", "exon_cmpt", "primary_exon_cmpt", "counts", "prob",
          "num_reads", "num_pairs")


def same_result(a, b, what):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, dict):
            x, y = list(x.items()), list(y.items())
        if x != y:
            raise AssertionError("%s: %s differs between the card and the "
                                 "CPU host-fold run" % (what, f))


def same_production(a, b, what):
    """tests/test_production.py's contract of the production path
    against the host engine: class dicts, read and pair counts and the
    ranked counts exact, prob within 1e-9 with the same ranking.  The
    primary-exon cmpt is filled only with type_primary_exons (as in
    hgtpu), and is held on a run of its own."""
    for f in ("cmpt", "exon_cmpt", "counts", "num_reads", "num_pairs"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError("%s: %s differs from the CPU host-fold run"
                                 % (what, f))
    if a.primary_exon_cmpt:
        raise AssertionError("%s: primary cmpt without type_primary_exons"
                             % what)
    pa, pb = dict(a.prob), dict(b.prob)
    if set(pa) != set(pb) or [x for x, _ in a.prob] != [x for x, _ in b.prob]:
        raise AssertionError("%s: prob ranking differs" % what)
    err = max((abs(pa[x] - pb[x]) for x in pa), default=0.0)
    if err >= 1e-9:
        raise AssertionError("%s: prob differs by %g" % (what, err))
    return err


def check_probs(res, what):
    import numpy as np

    p = np.array([v for _, v in res.prob], dtype=np.float64)
    if not (len(p) and np.isfinite(p).all() and abs(p.sum() - 1.0) < 1e-6):
        raise AssertionError("%s: bad abundance vector %s" % (what, p[:8]))


def check_truths(res, truths, what):
    check_probs(res, what)
    if len(truths) == 2:
        top2 = res.prob[:2]
        if {a for a, _ in top2} != set(truths) \
                or not all(0.3 <= p <= 0.7 for _, p in top2):
            raise AssertionError("%s: top 2 %s, want %s at 0.3-0.7"
                                 % (what, top2, truths))
    elif res.prob[0][0] not in truths:
        raise AssertionError("%s: top call %s is not a truth allele"
                             % (what, res.prob[0][0]))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hgtpu_torch")):
        sys.stderr.write("chip_smoke: hgtpu_torch is not beside this "
                         "script\n")
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    dev = torch.device("cuda")

    # ---- 1. card ---- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: %s (%s, %d device)" % (smi, torch.cuda.get_device_name(0),
                                      torch.cuda.device_count()))
    log("torch %s, cuda %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))

    # ---- 2. build ---- #
    make = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True)
    log("build: native verifier make rc=%d" % make.returncode)
    from hgtpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    build_s = time.perf_counter() - t0
    cuda_lib.load()
    log("build: kernels %s in %.1f s" % (os.path.basename(lib_path), build_s))
    with open(lib_path + ".log") as f:
        for line in f:
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill", "wgmma")):
                log("  ptxas: " + line.strip())

    from hgtpu.utils.trace import TRACE
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.ops import placement as tplace
    from hgtpu_torch.ops.compat_kernel import and_reduce, and_reduce_plain
    from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                                  placement_scores_plain)
    from hgtpu_torch.parallel import e2e, production
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions
    from hgtpu_torch.typer import device_count

    host_opts = TypingOptions(simulation=True, device_typing="off")
    prod_opts = TypingOptions(simulation=True)      # "auto": CUDA -> prod

    t0 = time.perf_counter()
    big = build_gene(3600, 3500, scale=True)
    truths = [big.allele_names[123], big.allele_names[2047]]
    b1, b2 = reads_of(big, truths, seed=1)
    n_big = len(b1) + len(b2)
    log("setup: scale panel A=%d P=%d, %d reads (%.1f s)"
        % (big.n_alleles, len(big.backbone), n_big,
           time.perf_counter() - t0))
    big_gpu = GeneAligner(big, device=dev)
    big_cpu = GeneAligner(big, device="cpu")
    kernels = {}

    # ---- 3. K1 ---- #
    m = big_gpu.pad_len
    seqs = [s for _, s in b1[:4096]] + [s for _, s in b2[:4096]]
    reads = tplace.encode_reads(seqs, m)
    reads_d = torch.from_numpy(reads).to(dev)
    ext_d = big_gpu._pwm_ext(m)
    got = placement_scores(ext_d, reads_d)
    want = placement_scores_plain(ext_d, reads_d)
    torch.cuda.synchronize()
    err1 = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("K1 kernel != plain, max abs err %g" % err1)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int32)
    args = dict(top_k=big_gpu.top_k, shifts=big_gpu._scan_shifts,
                k_mm=big_gpu._SCAN_KMM, lb_pad=big_gpu._LB_PAD)
    match_d, bb_d = big_gpu._scan_tables()
    scan_gpu = tplace.place_scan_batch(ext_d, match_d, bb_d, reads_d,
                                       lens.to(dev), **args).cpu()
    match_c, bb_c = big_cpu._scan_tables()
    scan_cpu = tplace.place_scan_batch(big_cpu._pwm_ext(m), match_c, bb_c,
                                       torch.from_numpy(reads), lens, **args)
    if not torch.equal(scan_gpu, scan_cpu):
        raise AssertionError("K1: place_scan_batch buffers differ between "
                             "the card and the CPU")
    k1_ms = cuda_ms(lambda: placement_scores(ext_d, reads_d))
    k1_plain_ms = cuda_ms(lambda: placement_scores_plain(ext_d, reads_d))
    n1, P1 = got.shape
    log("K1: placement_scores N=%d m=%d P1=%d exact (max abs err %g); "
        "kernel %.4f ms (%.1f TFLOP/s, output %.0f GB/s), plain %.4f ms; "
        "place_scan_batch buffers exact"
        % (n1, m, P1, err1, k1_ms, 2 * n1 * 5 * m * P1 / k1_ms / 1e9,
           n1 * P1 * 4 / k1_ms / 1e6, k1_plain_ms))
    del got, want
    # the production place pass's shape: the scale typer's pwm_ext (the
    # PWM plus read_len zero rows), one mate batch as count_classes pads
    # it (6,511 pairs -> 7,168 rows), m = 100 (the wrapper pads to 112)
    st_big = production._shared_sharded_typer(big, prod_opts, dev, 100)
    pwm_p = st_big._tables[0]
    codes_p = st_big._pad(st_big.encode([s for _, s in b1]), True)
    reads_p = torch.from_numpy(codes_p).to(dev)
    got = placement_scores(pwm_p, reads_p)
    want = placement_scores_plain(pwm_p, reads_p)
    torch.cuda.synchronize()
    err_p = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("K1 kernel != plain at the place pass's shape, "
                             "max abs err %g" % err_p)
    kp_ms = cuda_ms(lambda: placement_scores(pwm_p, reads_p))
    kp_plain_ms = cuda_ms(lambda: placement_scores_plain(pwm_p, reads_p))
    np_, P1p = got.shape
    log("K1: place pass shape N=%d m=%d P1=%d exact (max abs err %g); "
        "kernel %.4f ms (%.1f TFLOP/s), plain %.4f ms"
        % (np_, reads_p.shape[1], P1p, err_p, kp_ms,
           2 * np_ * 5 * 112 * P1p / kp_ms / 1e9, kp_plain_ms))
    del got, want
    # long reads: the kernel rebuilds its Hankel tiles per 512 positions
    rng = np.random.default_rng(9)
    pwm_l = np.zeros((500 + 2 * 1024, 5), np.float32)
    pwm_l[1024 + np.arange(500), rng.integers(0, 4, 500)] = 1.0
    pwm_l = torch.from_numpy(pwm_l).to(dev)
    reads_l = torch.from_numpy(
        rng.integers(0, 6, (17, 1024)).astype(np.int8)).to(dev)
    if not torch.equal(placement_scores(pwm_l, reads_l),
                       placement_scores_plain(pwm_l, reads_l)):
        raise AssertionError("K1 kernel != plain at N=17 m=1024 P=500")
    log("K1: exact at N=17 m=1024 P=500")

    # ---- warm-up runs on the card (first-touch allocations, shared
    # state, the production typers' tables) with every K1 and K2 call
    # recorded: one operand set per distinct shape, per run ---- #
    toy = build_gene(60, 3000, scale=False)
    toy_truths = toy.allele_names[:4]
    t1, t2 = reads_of(toy, toy_truths, seed=0)
    n_toy = len(t1) + len(t2)
    toy_gpu = GeneAligner(toy, device=dev)
    seen = {"placement_scores": {}, "and_reduce": {}}
    gemms = []
    run_name = [None]

    def recorder(name, real):
        def spy(a, b):
            key = (name,) + tuple(b.shape) + tuple(a.shape)
            seen[name].setdefault(key, (a.clone(), b.clone(), set()))[2] \
                .add(run_name[0])
            return real(a, b)
        return spy

    def gemm_spy(x, links):
        if run_name[0] == "prod-scale":
            gemms.append((x.clone(), links))
        return real_gemm(x, links)

    real_gemm = e2e.count_product
    tplace.placement_scores = recorder("placement_scores", placement_scores)
    device_count.and_reduce = recorder("and_reduce", and_reduce)
    e2e.count_product = gemm_spy
    try:
        for name, gene, r1, r2, opts, aligner in (
                ("scale", big, b1, b2, host_opts, big_gpu),
                ("toy", toy, t1, t2, host_opts, toy_gpu),
                ("prod-toy", toy, t1, t2, prod_opts, toy_gpu),
                ("prod-scale", big, b1, b2, prod_opts, big_gpu)):
            run_name[0] = name
            TRACE.reset()
            t0 = time.perf_counter()
            type_reads(gene, r1, r2, opts, aligner=aligner)
            torch.cuda.synchronize()
            log("setup: %s warm-up run on the card %.2f s"
                % (name, time.perf_counter() - t0))
        warm_fold = "rescue.fold" in TRACE.summary()
    finally:
        tplace.placement_scores = placement_scores
        device_count.and_reduce = and_reduce
        e2e.count_product = real_gemm

    def runs_of(name, run):
        return [k for k, v in seen[name].items() if run in v[2]]

    for name in seen:
        for run in ("scale", "toy", "prod-toy", "prod-scale"):
            if not runs_of(name, run) and (
                    name == "placement_scores" or run in ("scale", "toy")
                    or (run == "prod-scale" and warm_fold)):
                raise AssertionError("the %s warm-up run never called %s"
                                     % (run, name))

    # every K1 shape the paths gave the kernel, held against the plain
    # version on the recorded operands
    err_seen = 0.0
    for key, (pwm_s, reads_s, runs) in sorted(seen["placement_scores"]
                                              .items()):
        got = placement_scores(pwm_s, reads_s)
        want = placement_scores_plain(pwm_s, reads_s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError("K1 kernel != plain at N=%d m=%d pwm rows "
                                 "%d (%s), max abs err %g"
                                 % (key[1:4] + (sorted(runs), err)))
        err_seen = max(err_seen, err)
        log("K1: N=%d m=%d pwm_ext rows=%d (runs %s) exact"
            % (key[1], key[2], key[3], ",".join(sorted(runs))))
    del got, want
    kernels["placement_scores"] = dict(
        name="placement_scores", route="cuda",
        source="hgtpu_torch/csrc/placement_scores.cu",
        replaces="hgtpu/ops/placement_pallas.py:48",
        max_abs_err=max(err1, err_p, err_seen), ms=k1_ms,
        plain_ms=k1_plain_ms, shape="N=%d m=%d P1=%d" % (n1, m, P1),
        place_ms=kp_ms, place_plain_ms=kp_plain_ms,
        place_shape="N=%d m=%d P1=%d" % (np_, reads_p.shape[1], P1p),
        shapes_checked=len(seen["placement_scores"]))

    # ---- 4. K2: every (H, K) the folds gave it, bitwise ---- #
    for key, (links_s, vars_s, runs) in sorted(seen["and_reduce"].items()):
        if not torch.equal(and_reduce(links_s, vars_s),
                           and_reduce_plain(links_s, vars_s)):
            raise AssertionError("K2 kernel != plain at H=%d K=%d W=%d (%s)"
                                 % (key[1:3] + (key[4], sorted(runs))))
        log("K2: H=%d K=%d W=%d V+1=%d (runs %s) bitwise equal"
            % (key[1], key[2], key[4], key[3], ",".join(sorted(runs))))
    links_d, vars_d, _ = max(seen["and_reduce"].values(),
                             key=lambda lv: lv[1].numel())
    k2_ms = cuda_ms(lambda: and_reduce(links_d, vars_d))
    k2_plain_ms = cuda_ms(lambda: and_reduce_plain(links_d, vars_d))
    H, K = vars_d.shape
    log("K2: and_reduce H=%d K=%d W=%d (V+1=%d): kernel %.4f ms, plain "
        "%.4f ms" % (H, K, links_d.shape[1], links_d.shape[0], k2_ms,
                     k2_plain_ms))
    kernels["and_reduce"] = dict(
        name="and_reduce", route="cuda",
        source="hgtpu_torch/csrc/and_reduce.cu",
        replaces="hgtpu/ops/compat_kernel.py:36",
        max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain_ms,
        shape="H=%d K=%d W=%d" % (H, K, links_d.shape[1]),
        shapes_checked=len(seen["and_reduce"]))
    del seen

    # ---- compat_mxu's product at prod-scale's shape: bf16 operands,
    # float32 output, equal to the float64 product (exact counts) ---- #
    x_g, links_g = max(gemms, key=lambda xl: xl[0].shape[0])
    got = real_gemm(x_g, links_g)
    want = x_g.double() @ links_g.double()
    if got.dtype != torch.float32 or not torch.equal(got.double(), want):
        raise AssertionError("compat_mxu's product is not exact at %s"
                             % (tuple(x_g.shape),))
    g_ms = cuda_ms(lambda: real_gemm(x_g, links_g), iters=5)
    log("compat: product [%d, %d] x [%d, %d] bf16 -> float32 equals the "
        "float64 product (max count %d); %.4f ms"
        % (tuple(x_g.shape) + tuple(links_g.shape)
           + (int(want.max()), g_ms)))
    del gemms, x_g, got, want

    # CPU host-fold references (plain versions, no launches)
    host_cpu = TypingOptions(simulation=True, device_counting="off",
                             device_typing="off")
    t0 = time.perf_counter()
    toy_ref = type_reads(toy, t1, t2, host_cpu,
                         aligner=GeneAligner(toy, device="cpu"))
    big_ref = type_reads(big, b1, b2, host_cpu, aligner=big_cpu)
    log("setup: CPU host-fold references %.1f s" % (time.perf_counter() - t0))

    def counts():
        return {"placement_scores": placement_scores.launches,
                "and_reduce": and_reduce.launches}

    def reset():
        placement_scores.launches = 0
        and_reduce.launches = 0

    # ---- host-engine path: counts cover exactly these two runs ---- #
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toy_res = type_reads(toy, t1, t2, host_opts, aligner=toy_gpu)
    torch.cuda.synchronize()
    toy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_res = type_reads(big, b1, b2, host_opts, aligner=big_gpu)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    host_launches = counts()

    # ---- 5. toy ---- #
    check_truths(toy_res, toy_truths, "toy")
    same_result(toy_res, toy_ref, "toy")
    log("toy: A=%d, %d reads, top %s %.4f; equals the CPU host-fold run; "
        "warm wall %.3f s, %.1f reads/s" % (
            toy.n_alleles, n_toy, toy_res.prob[0][0], toy_res.prob[0][1],
            toy_s, n_toy / toy_s))

    # ---- 6. scale ---- #
    check_truths(big_res, truths, "scale")
    same_result(big_res, big_ref, "scale")
    log("scale: A=%d, %d reads, top2 %s; equals the CPU host-fold run; "
        "warm wall %.3f s, %.1f reads/s" % (
            big.n_alleles, n_big,
            [(a, round(p, 4)) for a, p in big_res.prob[:2]],
            big_s, n_big / big_s))

    # ---- production path (the main path): counts cover these runs ---- #
    routed = []
    punts = []
    real_entry = production.type_reads_device
    real_count = ShardedTyper.count_classes

    def entry_spy(*a, **k):
        routed.append(k.get("device"))
        return real_entry(*a, **k)

    def count_spy(self, *a, **k):
        out = real_count(self, *a, **k)
        punts.append(int(out["punt"].sum()))
        return out

    production.type_reads_device = entry_spy
    ShardedTyper.count_classes = count_spy
    runs = {}
    try:
        reset()
        torch.cuda.synchronize()
        for name, gene, r1, r2, aligner in (
                ("prod-toy", toy, t1, t2, toy_gpu),
                ("prod-scale", big, b1, b2, big_gpu)):
            TRACE.reset()
            t0 = time.perf_counter()
            res = type_reads(gene, r1, r2, prod_opts, aligner=aligner)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name] = (res, wall, TRACE.summary(), punts[-1])
            if routed[-1:] != [dev] or len(routed) != len(runs):
                raise AssertionError("%s did not go through "
                                     "type_reads_device on the card" % name)
            if name == "prod-toy":
                toy_launches = counts()
        prod_launches = counts()
    finally:
        production.type_reads_device = real_entry
        ShardedTyper.count_classes = real_count
    scale_launches = {k: prod_launches[k] - toy_launches[k]
                      for k in prod_launches}

    # ---- 7. prod-toy / prod-scale ---- #
    for name, gene, want, tr, n_reads, branch in (
            ("prod-toy", toy, toy_ref, toy_truths, n_toy, "fused"),
            ("prod-scale", big, big_ref, truths, n_big, "tiered")):
        res, wall, stages, n_punt = runs[name]
        st = production._shared_sharded_typer(gene, prod_opts, dev, 100)
        # the tiered branch runs a place pass of its own; fused does not
        took = "tiered" if "device.place" in stages else "fused"
        if took != branch or (st._fused_H <= 8) != (branch == "fused"):
            raise AssertionError("%s took the %s branch, want %s"
                                 % (name, took, branch))
        check_truths(res, tr, name)
        err = same_production(res, want, name)
        # the primary-exon level: one more run with type_primary_exons
        primary = type_reads(gene, *((t1, t2) if gene is toy else (b1, b2)),
                             TypingOptions(simulation=True,
                                           type_primary_exons=True),
                             aligner=toy_gpu if gene is toy else big_gpu)
        if primary.primary_exon_cmpt != want.primary_exon_cmpt \
                or not primary.primary_exon_cmpt:
            raise AssertionError("%s: primary cmpt differs from the CPU "
                                 "host-fold run" % name)
        log("%s: A=%d, %d reads, %s spelling, top %s; equals the CPU "
            "host-fold run (prob max diff %.3g; primary cmpt exact, %d "
            "classes); warm wall %.3f s, %.1f reads/s; punts %d; stages %s"
            % (name, gene.n_alleles, n_reads, took,
               [(a, round(p, 4)) for a, p in res.prob[:len(tr[:2])]], err,
               len(primary.primary_exon_cmpt), wall, n_reads / wall, n_punt,
               {s: round(stages[s]["s"], 4) for s in STAGES
                if s in stages}))
        if name == "prod-scale":
            scale_fold = "rescue.fold" in stages

    # ---- 8. proof of path ---- #
    for name in kernels:
        if host_launches[name] <= 0:
            raise AssertionError("%s never launched on the host-engine path"
                                 % name)
        kernels[name]["launches"] = prod_launches[name]
    if toy_launches["placement_scores"] <= 0 \
            or scale_launches["placement_scores"] <= 0:
        raise AssertionError("K1 did not launch in both production runs")
    if scale_fold and scale_launches["and_reduce"] <= 0:
        raise AssertionError("the prod-scale rescue reached the fold but "
                             "K2 never launched")
    if prod_launches["and_reduce"] <= 0:
        raise AssertionError("K2 never launched on the production path")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log("proof: launches host path %s, production path %s (prod-scale %s; "
        "rescue reached the fold: %s); jax imported: no; native verifier "
        "loaded: %s" % (host_launches, prod_launches, scale_launches,
                        scale_fold, big_gpu.native is not None))
    log("wall: chip_smoke %.1f s" % (time.perf_counter() - t_start))

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    log(json.dumps({"kernels": [
        {k: kernels[n][k] for k in order
         + tuple(k for k in kernels[n] if k not in order)}
        for n in ("placement_scores", "and_reduce")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
