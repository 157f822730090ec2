#!/usr/bin/env python3
"""Quickest proof that hgtpu_torch starts, and is right, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — hgtpu_torch.pipeline.type_reads on the
host-engine slice: placement on kernel K1, host verify, haplotypes, the
device fold on kernel K2, the staged EM — and checks it phase by phase:

  card    nvidia-smi's name and power limit
  build   nvcc builds the kernels from hgtpu_torch/csrc (and make builds
          the native verifier); build time and ptxas report (registers,
          spill bytes, wgmma serialisation warnings)
  K1      placement scores (wgmma), kernel vs plain torch on the card,
          N = 8192 reads of m = 128 against the 3,600-allele panel's
          backbone; exact; time, TFLOP/s and output GB/s beside the plain
          version's time.  Exact at m = 1024 too (N = 17, P = 500).
          place_scan_batch buffers on the card vs the CPU; exact
  K2      and_reduce, kernel vs plain at the H x K the fold builds on the
          scale run (A = 3,600); bitwise
  toy     60-allele gene, 4 truth alleles: top call is a truth allele and
          the result equals the CPU host-fold run
  scale   3,600-allele / 3.5 kb panel, het truth pair, ~13 k reads: top 2
          are the pair at 0.3-0.7 each, the result equals the CPU
          host-fold run; warm wall time and reads/s
  proof   K1 and K2 launch counts from the toy + scale runs on the card
          are > 0, and jax was never imported

Every failure raises: nothing is caught and carried on, and there is no
CPU fallback.  Exits non-zero without a CUDA device or without the repo
beside it.  The last two lines of standard output are the kernels' JSON
record and the device JSON.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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


def check_probs(res, what):
    import numpy as np

    p = np.array([v for _, v in res.prob], dtype=np.float64)
    if not (len(p) and np.isfinite(p).all() and abs(p.sum() - 1.0) < 1e-6):
        raise AssertionError("%s: bad abundance vector %s" % (what, p[:8]))


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

    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.ops import placement as tplace
    from hgtpu_torch.ops.compat_kernel import and_reduce, and_reduce_plain
    from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                                  placement_scores_plain)
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions
    from hgtpu_torch.typer import device_count

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
    kernels["placement_scores"] = dict(
        name="placement_scores", route="cuda",
        source="hgtpu_torch/csrc/placement_scores.cu",
        replaces="hgtpu/ops/placement_pallas.py:48",
        max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain_ms)
    del got, want

    # warm-up scale run on the card; records the fold's K2 operands
    seen = []

    def spy(links, vars_):
        seen.append((links, vars_))
        return and_reduce(links, vars_)

    device_count.and_reduce = spy
    try:
        t0 = time.perf_counter()
        type_reads(big, b1, b2, TypingOptions(simulation=True),
                   aligner=big_gpu)
        torch.cuda.synchronize()
        log("setup: scale warm-up run on the card %.2f s"
            % (time.perf_counter() - t0))
    finally:
        device_count.and_reduce = and_reduce
    if not seen:
        raise AssertionError("the scale run never reached the device fold")

    # ---- 4. K2 ---- #
    links_d, vars_d = max(seen, key=lambda lv: lv[1].numel())
    got = and_reduce(links_d, vars_d)
    want = and_reduce_plain(links_d, vars_d)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 kernel != plain")
    k2_ms = cuda_ms(lambda: and_reduce(links_d, vars_d))
    k2_plain_ms = cuda_ms(lambda: and_reduce_plain(links_d, vars_d))
    H, K = vars_d.shape
    log("K2: and_reduce H=%d K=%d W=%d (V+1=%d) bitwise equal; kernel "
        "%.4f ms, plain %.4f ms" % (H, K, links_d.shape[1], links_d.shape[0],
                                    k2_ms, k2_plain_ms))
    kernels["and_reduce"] = dict(
        name="and_reduce", route="cuda",
        source="hgtpu_torch/csrc/and_reduce.cu",
        replaces="hgtpu/ops/compat_kernel.py:36",
        max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain_ms)

    # CPU host-fold references (plain versions, no launches)
    toy = build_gene(60, 3000, scale=False)
    toy_truths = toy.allele_names[:4]
    t1, t2 = reads_of(toy, toy_truths, seed=0)
    toy_gpu = GeneAligner(toy, device=dev)
    host = TypingOptions(simulation=True, device_counting="off")
    t0 = time.perf_counter()
    toy_ref = type_reads(toy, t1, t2, host, aligner=GeneAligner(toy,
                                                                device="cpu"))
    big_ref = type_reads(big, b1, b2, host, aligner=big_cpu)
    log("setup: CPU host-fold references %.1f s" % (time.perf_counter() - t0))
    # toy warm-up on the card (first-touch allocations, shared state)
    type_reads(toy, t1, t2, TypingOptions(simulation=True), aligner=toy_gpu)

    # ---- main path: counts cover exactly these two runs ---- #
    placement_scores.launches = 0
    and_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toy_res = type_reads(toy, t1, t2, TypingOptions(simulation=True),
                         aligner=toy_gpu)
    torch.cuda.synchronize()
    toy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_res = type_reads(big, b1, b2, TypingOptions(simulation=True),
                         aligner=big_gpu)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    launches = {"placement_scores": placement_scores.launches,
                "and_reduce": and_reduce.launches}

    # ---- 5. toy ---- #
    n_toy = len(t1) + len(t2)
    check_probs(toy_res, "toy")
    if toy_res.prob[0][0] not in toy_truths:
        raise AssertionError("toy: top call %s is not a truth allele"
                             % toy_res.prob[0][0])
    same_result(toy_res, toy_ref, "toy")
    log("toy: A=%d, %d reads, top %s %.4f; equals the CPU host-fold run; "
        "warm wall %.3f s, %.1f reads/s" % (
            toy.n_alleles, n_toy, toy_res.prob[0][0], toy_res.prob[0][1],
            toy_s, n_toy / toy_s))

    # ---- 6. scale ---- #
    check_probs(big_res, "scale")
    top2 = big_res.prob[:2]
    if {a for a, _ in top2} != set(truths) \
            or not all(0.3 <= p <= 0.7 for _, p in top2):
        raise AssertionError("scale: top 2 %s, want %s at 0.3-0.7"
                             % (top2, truths))
    same_result(big_res, big_ref, "scale")
    log("scale: A=%d, %d reads, top2 %s; equals the CPU host-fold run; "
        "warm wall %.3f s, %.1f reads/s" % (
            big.n_alleles, n_big, [(a, round(p, 4)) for a, p in top2],
            big_s, n_big / big_s))

    # ---- 7. proof of path ---- #
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError("%s never launched on the main path" % name)
        kernels[name]["launches"] = n
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log("proof: launches %s; jax imported: no; native verifier loaded: %s"
        % (launches, big_gpu.native is not None))

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    log(json.dumps({"kernels": [{k: kernels[n][k] for k in order}
                                for n in ("placement_scores",
                                          "and_reduce")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
