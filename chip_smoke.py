#!/usr/bin/env python3
"""Quickest proof that hgtpu_torch starts, and is right, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives both of the port's typing paths through
hgtpu_torch.pipeline.type_reads and checks them phase by phase:

  * the production path ("auto" on CUDA, the main path): the place pass
    on kernel K1, the spell pass, the host pileup merge, the count pass
    (pileup gate, compatibility products, class dedup), the host
    rescue of the punt mask (realignment with device verify: the banded
    DP kernel scores the rank-0 proposals) with the device fold on
    kernel K2, the staged EM;
  * the host-engine path (device_typing="off"): placement on K1, device
    verify on the banded DP kernel beside the native verifier,
    haplotypes, the device fold on K2, the staged EM;
  * the pure-device programs: hgtpu_torch.entry.dryrun_multichip(1) and
    (2) and ShardedTyper.call_pairs (ungated count, device EM);
  * many devices on the one card: a mesh of 2 shards on cuda:0, two
    ranks on cuda:0 over gloo and a one-rank "cpu:gloo,cuda:nccl" world
    (hgtpu_torch.parallel.sharded, multihost), each held against one
    process on one shard;
  * one sample over a family (hgtpu_torch.pipeline.type_family): the
    panel router (one K1 product over every gene's PWM, a segment max),
    the NH==1 rule, then each gene on the host engine (K1 placement, the
    bit DP, K2 in the fold); ReadExtractor; linear typing and SAM in and
    out; genome-scale extraction on the checkpointed FM index;
  * the command line (hgtpu_torch.cli.main.main, `python -m
    hgtpu_torch`, the toolkit's parse-results) on text databases the
    port wrote: the family's sample, and the simulation self-test at
    HLA-A scale on the production path;
  * guided assembly and phasing (assembly=True, `--assembly`): typing on
    the host-engine path (K1, the bit DP, K2), then the assembly on the
    host; and the toolkit's extract-codis-data, convert-codis,
    extract-rbg and compare;
  * hgtpu's devel runs on the port (hgtpu_torch.devel): the five golden
    command-line runs against devel/expected/, the full regression
    campaign, and the shard sweep of sharded_place and sharded_count;
  * the punt probe on the port (hgtpu_torch.devel.punts);
  * the edge cases hgtpu's own tests pin (hgtpu_torch.devel.edges):
    random-MSA, gap, variant-free, haplotype-window, partial-allele and
    errored genes and the path-changing options typed on the card, the
    kernels at degenerate shapes, and a BAM the port wrote.

Phases:

  card       nvidia-smi's name and power limit
  build      nvcc builds the kernels from hgtpu_torch/csrc, one process
             per source, all at once (and make builds the native verifier
             beside them); build time and ptxas report
  K1         placement scores (wgmma), kernel vs plain torch on the card:
             the host path's shape (N = 8192, m = 128) and the place
             pass's (N = 7,168 reads of m = 100 against the scale panel's
             pwm_ext, P + 100 rows); exact; times beside the plain
             version's and one torch.mm's (bf16 one-hot reads by PWM
             windows, float32 out: a yardstick the port never calls).
             Exact at m = 1024 too; place_scan_batch buffers on the card
             vs the CPU
  warm-up    one run of each path and gene on the card, recording every
             K1, K2 and DP call (the place pass, the fused spell, the
             rescue's realignment, both folds, device verify) and
             compat_mxu's products
  K1, K2     every distinct operand shape recorded in the warm-ups,
             kernel vs plain on the recorded operands, exact (K1) and
             bitwise (K2: both variants, the slab kernel at k2_plan's
             width and the wide L2 kernel); the wide kernel bitwise on a
             V+1 = 14,000 table, past the slab limit, through and_reduce;
             K2 timed at the largest H x K and at the production rescue's
             fold, in turns (plain, slab, wide, slab, wide, plain), and
             the slab kernel with K = 0 (staging, tile walk and stores)
  DP         both banded DP kernels (device verify) against their plain
             version, bitwise (cost and over): the bit kernel (budgets
             0-7, the path's) and the warp kernel at every (E, W) the
             warm-ups gave them, and on a synthetic batch of the
             insertion test gene, the bit kernel at budgets 0, 2 and 7,
             the warp kernel at 30 (7 and 30 set over); both timed in
             turns (bits, warp, warp, bits) beside the plain version at
             the host path's and the rescue's shapes; bound: the level-
             mask form's word operations at the card's int32 rate (64
             lanes per SM and clock at nvidia-smi's max SM clock)
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
  dryrun     dryrun_multichip(1) and (2) on the card (production path
             and call_allele on the tiny gene, truth called), and
             ShardedTyper(em_iters=300).call_pairs on the scale panel
             (tests/test_hla_scale.py's indel-carrying truth): truth
             called, totals, n_used and punt equal to the port's CPU run
  mesh       the scale cell on a mesh of 2 shards on cuda:0: count_classes'
             mesh-invariant fields (pileup, punt, exclusion, counts, each
             level's totals and aggregated classes) equal to the one-shard
             typer's, type_reads_device field for field equal to
             prod-scale's, its K1, K2 and DP launches counted (counts set
             to 0 just before, read just after); then two ranks on cuda:0
             (backend="gloo": NCCL refuses two ranks on one card) and a
             one-rank world (the default "cpu:gloo,cuda:nccl"), each rank
             its own process: type_reads_device_distributed on its half
             of the pairs equal to prod-scale's result, distributed_call
             on its half of the padded single-end codes equal to one
             process's run over a mesh of as many shards (prob within
             1e-6, totals, n_used and punt exact), an all_reduce on the
             card through the group; walls, TRACE's dist.pileup,
             dist.classes and dist.rescue, launches per rank
  family     tests/synth.make_family's six genes (A, B, C, DQA1, DQB1,
             DRB1) x 200 alleles x 3.5 kb through build_catalog_from_msa,
             a heterozygous truth pair per gene (simulate_interval=2) and
             2,000 background pairs from the flanks (~21 k pairs):
             type_family on the card (router on) equals the port's CPU
             run gene by gene and field by field, truths on top; warm
             wall and reads/s; ReadExtractor equals its CPU run
  bound      the verify prep's proposal bound kernel: every launch of
             the family warm-up recorded (codes, entries, cap, output)
             and held against the aligner's numpy _lb_core on the same
             inputs, bitwise (the recorded output and a second launch);
             timed at the recorded median and largest call and at
             hla6.wgs30's per-call entries (7,399 and 57,112: the largest
             call's entries repeated), beside _lb_core's host time
  panel      K1 at the router's shape (N = 2 x the mate batch, P1 the
             whole panel: 6 x (512 + ~3.5 k) + 512 rows - m + 1) at m =
             128 (the family run's operands) and m = 512 (600-bp reads,
             clipped as gene_max clips them), exact against the plain
             version; timed beside it and one torch.mm; the float32
             output's size; gene_max on the card equals the CPU's
  linear/sam type_reads_linear on gene A and type_from_sam of gene A's
             family SAM (written by type_family's sam_out) equal the CPU
  extract    build_genotype_genome of the family genome plus a random
             16 Mb chromosome (native SA-IS), GenomeExtractor with the
             checkpointed FM index on the card; 100,000 single-end 100-bp
             reads cut from it route as the CPU run of the same index
             routes them; FM search time, calls and device kernels;
             reads/s; the family's own pairs extracted and typed, truths
             on top
  cli        the family's catalog as a text database (export_text) and
             its pairs as gzipped FASTQ, typed by `main(["-1", .., "-2",
             ..])` with no device given (the card by default): rc 0, the
             report equal line for line (but the argv line) to the one
             ReportWriter writes from the family phase's results, K1
             (router, per gene), K2 and bit-DP launches inside the call;
             the 3,600-allele gene as gene A of a text database,
             `--debug basic,test_size:5,set_seed:101`: rc 0, the place
             pass on K1, K2 in the rescue's fold, the bit DP, and the
             five reports equal to an in-process simulation_sweep's;
             import_text's time at 3,600 alleles; `python -m
             hgtpu_torch` on the toy gene in a subprocess (rc 0), then
             `python -m hgtpu_torch.cli.toolkit parse-results` over the
             family run: every gene's truth pair in the CSV
  assembly   the 3,600-allele panel's truth allele_names[123] at
             interval 4 (tests/test_hla_scale.py's test_assembly_at_scale)
             typed with assembly=True on the card, counts set to 0 just
             before and read just after: K1, K2 and the bit DP launched,
             the truth first and called [truth, truth] from 1-2 contigs,
             call (score within 1e-9) and contigs equal to the CPU run;
             wall and TRACE's type.assembly; a profiled run for the
             device's busy share; the toy's het pair (alleles 3 and 24,
             interval 2) called; `main(--debug basic,test_size:2
             --assembly)` on the toy's text database on the card and on
             the CPU: reports equal but the argv line, every call named,
             .fasta and .pdf byte for byte; the toolkit's
             extract-codis-data (--html-dir), convert-codis, extract-rbg
             and compare rc 0 on inputs written here
  golden     hgtpu_torch.devel.golden.main --device-typing auto: hg_test1-5
             (devel/integration_test.py's argv) as `python -m
             hgtpu_torch` children on the card, the test database the
             port writes (equal to devel/make_testdb.py's): every marker
             check passes, every report and hg_test3's .fasta equal
             devel/expected/ after normalize, the production path for
             hg_test1 and 2 and the host engine for hg_test3-5 (assembly;
             real reads go through type_family); each child's wall and
             its K1, K2 and DP launches (HGTPU_TORCH_RUN_STATS)
  campaign   hgtpu_torch.devel.campaign in full on device="cuda" (the
             production path for the ten sweeps and hla-scale, the host
             engine for codis-str and family-2gene): every configuration
             passes, every result equals the CPU host-fold run of the same
             configuration (production contract on the production path,
             field for field on the host engine); hla-scale-3600 types the
             scale panel, its assembly half is the assembly phase's scale
             run (cited); launches counted over the phase
  scaling    hgtpu_torch.devel.scaling.main at 1, 2 and 4 shards on
             cuda:0 (the tiny gene at 3,072 bp, 192 SNPs, 1,024 alleles;
             512 reads and hts per shard): every mesh's outputs equal one
             shard's; its JSON (sec, reads/s, efficiency per shard count;
             one card: per-shard overhead, not scaling); launches
  punts      hgtpu_torch.devel.punts.punt_stats on the scale panel at one
             shard of the card equal to one CPU shard's (punt, excl,
             causes, tier-1 mates, anatomy)
  edges      hgtpu_torch.devel.edges' 16 cases (tests/test_fuzz.py's
             four random-MSA genes, its gap and variant-free genes,
             test_haplotype_paths.py's two-indel gene with a recombinant
             pair, grafted partial alleles, errored reads, use_alts and
             error_correction off, an excluded truth, germline SNPs,
             type_primary_exons) typed through type_reads on the card
             ("auto", one shard), the launches of K1, K2 and both DP
             kernels counted per case (set to 0 just before, read just
             after; K1, K2 and the bit DP must each launch): each result
             equal field for field, class order included, to the port's
             one-shard CPU production run (the host engine where the
             options route there) and to its CPU host engine under the
             contract (the two-indel gene's recombinant pair parts
             hgtpu's own paths by one class; that difference is held as
             it is); K1, K2 (slab and wide) and the bit DP launched
             straight at the degenerate shapes (N, H, E of 0 and 1, P1
             under one tile, W = 1, V+1 = 1) against their plain
             versions, the empty ones launching nothing; the scale cell's
             pairs as a BAM the port wrote (write_bam) and as FASTQ, each
             through `python -m hgtpu_torch` on the card (--bamfile, -1
             -2): the two reports equal but the argv line
  proof      launch counts of each path's runs (counts set to 0 just
             before the path, read just after): K1 > 0 on both paths, K2
             > 0 on the host path and on prod-scale whenever its rescue
             reached the fold, the bit DP kernel > 0 on the host path and
             in the prod-scale rescue and the warp DP kernel 0 on both
             paths; on the family path K1 = the router's 2 launches + the
             per-gene placements, K2, the bit DP kernel and the
             proposal bound > 0; the native library loaded; neither jax
             nor hgtpu (the JAX package) ever imported

Every failure raises: nothing is caught and carried on, and there is no
CPU fallback.  Exits non-zero without a CUDA device or without the repo
beside it.  The last three lines of standard output are the kernels'
JSON record, the card's name and power limit, and the device JSON.
The JSON holds one record per kernel and timed shape (`shape`): ms,
plain_ms and library_ms (null where no torch call computes the function)
are device times of one call (CUDA-graph replay: the host's cost of a
wrapped call, tens of microseconds, would swamp a small kernel; the
proposal bound's plain version is numpy on the host, plain_host_ms),
bound_ms / bound_by the least time the card could take for the same
work, launches the main path's count (the family path's for the K1
records at the router's shape and the proposal bound's, "path":
"family"), launches_assembly the assembly phase's scale run's,
launches_mesh the mesh phase's 2-shard
run's, launches_golden the five golden children's, launches_campaign the
campaign phase's, launches_scaling the shard sweep's, launches_edges the
edge cases' (summed over the cases), max_abs_err over
every shape checked.  "kernels" lists the kernels of the path;
"off_path" the wide K2 variant, which no table of the path takes, and
the warp DP kernel, which no budget of the path takes.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

STAGES = ("device.place", "device.spell", "device.countB", "device.rescue",
          "device.merge", "rescue.align", "verify.prep", "verify.native",
          "verify.dp_codes", "verify.dp_pad", "verify.device_dp",
          "verify.dp_apply", "type.em")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Device time of one call of fn: `iters` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's cost of a
    call (tens of microseconds through a Python wrapper, more than a small
    kernel takes) stays out of the time; warm-up calls first, on a side
    stream as capture wants."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


# the card's datasheet peaks (H100 SXM, 700 W): HBM bytes/s, dense bf16
# tensor-core and float32 CUDA-core rates
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12


def bound_ms(nbytes, ops, peak):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak; and which one."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k1_library(pwm_ext, reads):
    """One torch.mm that computes K1's scores, as a yardstick only: one-hot
    reads [N, 5m] by PWM windows [5m, P1], bf16 in, float32 out, on the
    operands the kernel takes (k16_operands), built here, outside the
    timing."""
    import torch
    from hgtpu_torch.ops.placement_kernel import k16_operands

    pwm_k, reads_k = k16_operands(pwm_ext, reads)
    n, m = reads_k.shape
    P1 = pwm_k.shape[0] - m + 1
    classes = torch.arange(5, device=reads.device)
    onehot = (reads_k.long()[:, :, None] == classes).to(torch.bfloat16) \
        .reshape(n, 5 * m)
    windows = pwm_k.to(torch.bfloat16).unfold(0, m, 1).transpose(1, 2) \
        .reshape(P1, 5 * m)
    return lambda: torch.mm(onehot, windows.T, out_dtype=torch.float32)


def build_gene(n_alleles, length, scale):
    from synth import make_gene_msa, make_hla_scale_msa
    from hgtpu_torch.db import build_gene_ref

    spec = make_hla_scale_msa(n_alleles=n_alleles, length=length) if scale \
        else make_gene_msa(seed=11, n_alleles=n_alleles, length=length)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


def reads_of(gene, truths, seed):
    from hgtpu_torch.sim import simulate_reads

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


def int32_rate():
    """The card's int32 rate, operations a second: 64 int32 lanes per SM
    and clock (Hopper's SM) x the SMs x the max SM clock nvidia-smi
    reports; and that clock in MHz and the SM count."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 64 * sms * mhz * 1e6, mhz, sms


def dp_ops(args):
    """Word operations the level-mask form of the banded DP needs for
    these entries, the least any implementation of the recurrence does:
    per entry and read position up to min(len, W), the transitions every
    position needs (the pending merge, the consume, one closure round of
    the two novel deletions and its convergence test, the two novel
    insertions: 7), one more where a catalog deletion row lies in the
    band and one more where a catalog insertion row does; each 3 word
    operations (shift, mask, min) on each of the max_novel + 1 levels,
    64 diagonals a word (the band's 33 fit one)."""
    import torch
    from hgtpu_torch.ops.banded_dp import D, DNEG, OFF

    table, reads, lens, starts, P, max_novel = args[:6]
    E, W = reads.shape
    rows = table.shape[0]
    counts = []
    for flag in (table[:, 1] != 0, ((table[:, 0] >> 9) & 63) != 0):
        c = torch.zeros(rows + 1, dtype=torch.int64, device=table.device)
        c[1:] = torch.cumsum(flag.long(), 0)
        counts.append(c)
    i = torch.arange(W + 1, device=reads.device)
    q = starts.long()[:, None] + i[None, :] + (OFF - DNEG)   # row of d = 0
    lo = q.clamp(OFF, OFF + P)
    hi = (q + D).clamp(OFF, OFF + P)
    n = torch.full_like(q, 7)
    for c in counts:
        n += (c[hi] - c[lo]) > 0
    walk = i[None, :] <= torch.minimum(lens.long(), torch.full_like(
        lens.long(), W))[:, None]
    return 3 * (max_novel + 1) * int((n * walk).sum())


def dp_phase(seen_dp, timer):
    """Both banded DP kernels against the plain version, bitwise (cost and
    over): the bit kernel at every recorded (E, W) and on a synthetic
    batch at budgets 0, 2 and 7 (which must reach both band edges), the
    warp kernel at every recorded (E, W) and on the synthetic batch at
    30 edits; then both kernels timed in turns (bits, warp, warp, bits;
    timer = cuda_ms), the plain version before and after, at the host
    path's and the prod rescue's largest shapes.  Returns the JSON
    records of the bit kernel and of the warp kernel."""
    import numpy as np
    import torch
    from synth import make_gene_msa
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.ops.banded_dp import (INF, BandedDPTables,
                                           banded_costs_bits,
                                           banded_costs_plain,
                                           banded_costs_warp, dp_plan)
    from hgtpu_torch.utils.dna import encode_seq

    def run(kernel, args, planes):
        if kernel == "bits":
            return banded_costs_bits(args[0], planes, *args[1:])
        return banded_costs_warp(*args)

    def check(kernel, args, planes, what):
        got = run(kernel, args, planes)
        want = banded_costs_plain(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            raise AssertionError("DP %s kernel != plain at %s (%d entries "
                                 "differ)" % (kernel, what, bad))
        return want

    for (E, W, P), (args, planes, runs) in sorted(seen_dp.items()):
        if dp_plan(args[5]) != "bits":
            raise AssertionError("the path's DP budget %d does not take the "
                                 "bit kernel" % args[5])
        for kernel in ("bits", "warp"):
            cost, over = check(kernel, args, planes, "E=%d W=%d" % (E, W))
        log("DP: E=%d W=%d P=%d (runs %s): bit and warp kernels bitwise "
            "equal (cost and over); %d within the budget, %d over"
            % (E, W, P, ",".join(sorted(runs)), int((cost <= 2).sum()),
               int(over.sum())))
    # a synthetic batch: the insertion test gene, allele windows with
    # substitutions at drifted starts, junk reads; budgets 7 and 30 spread
    # the states to both band edges
    spec = make_gene_msa(seed=15, n_alleles=24, length=1600, n_ins=14)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=8.0)
    dev = next(iter(seen_dp.values()))[0][0].device
    tab = BandedDPTables(gene, dev)
    rng = np.random.default_rng(17)
    E, W = 4096, 128
    reads = rng.integers(0, 5, (E, W)).astype(np.int8)
    lens = rng.integers(40, W + 1, E).astype(np.int32)
    starts = rng.integers(-20, len(gene.backbone), E).astype(np.int32)
    for e in range(0, E, 2):
        a = gene.allele_seq(gene.allele_names[int(rng.integers(0, 24))])
        s0 = int(rng.integers(0, len(a) - W))
        r = encode_seq(a[s0:s0 + int(lens[e])])
        reads[e, :len(r)] = r
        starts[e] = s0 + int(rng.integers(-12, 13))
    ops = tuple(torch.from_numpy(x).to(dev) for x in (reads, lens, starts))
    for kernel, budget in (("bits", 0), ("bits", 2), ("bits", 7),
                           ("warp", 30)):
        args = (tab.table,) + ops + (tab.P, budget, tab.del_lens,
                                     tab.ins_lens)
        cost, over = check(kernel, args, tab.planes,
                           "the synthetic batch, budget %d" % budget)
        if budget >= 7 and not (over.any() and (~over).any()
                                and (cost <= 2).any()):
            raise AssertionError("DP: the synthetic batch did not reach "
                                 "both band edges at budget %d" % budget)
        log("DP: synthetic E=%d W=%d, budget %d: %s kernel bitwise equal; "
            "%d over, %d finite" % (E, W, budget,
                                    "bit" if kernel == "bits" else kernel,
                                    int(over.sum()),
                                    int((cost < INF).sum())))

    rate, mhz, sms = int32_rate()
    records = {"bits": [], "warp": []}
    for where, run_name in (("host path", "scale"),
                            ("prod rescue", "prod-scale")):
        key = max((k for k, v in seen_dp.items() if run_name in v[2]),
                  key=lambda k: k[0], default=None)
        if key is None:
            continue
        args, planes, _runs = seen_dp[key]
        table, reads_d = args[:2]
        E, W = reads_d.shape
        turns = {"plain": [], "bits": [], "warp": []}
        for k in ("plain", "bits", "warp", "warp", "bits", "plain"):
            turns[k].append(
                timer(lambda: banded_costs_plain(*args), iters=1, warmup=1)
                if k == "plain" else timer(lambda: run(k, args, planes)))
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        ops_n = dp_ops(args)
        nbytes = E * W + 8 * E + planes.numel() * 8 + 5 * E
        b_ms, b_by = bound_ms(nbytes, ops_n, rate)
        log("DP: %s E=%d W=%d: bit kernel %.4f ms, warp kernel %.4f ms, "
            "plain %.4f ms; bound %.4f ms (%s: %.4g word ops at %.4g int32 "
            "ops/s = 64 x %d SMs x %.0f MHz; %d bytes): bits at %.1f %%, "
            "warp at %.2f %% of it; turns %s"
            % (where, E, W, ms["bits"], ms["warp"], ms["plain"], b_ms, b_by,
               ops_n, rate, sms, mhz, nbytes, 100 * b_ms / ms["bits"],
               100 * b_ms / ms["warp"],
               {k: [round(x, 4) for x in v] for k, v in turns.items()}))
        for kernel in ("bits", "warp"):
            records[kernel].append(dict(
                name="banded_dp_" + kernel, route="cuda",
                source="hgtpu_torch/csrc/banded_dp.cu",
                replaces="hgtpu/ops/banded_dp.py:140", max_abs_err=0.0,
                ms=ms[kernel], plain_ms=ms["plain"], bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                library="none: no torch call computes the banded DP",
                shape="E=%d W=%d P=%d budget %d (%s)" % (E, W, key[2],
                                                         args[5], where),
                turns_ms=turns[kernel], shapes_checked=len(seen_dp) + 4,
                word_ops=ops_n, int32_ops_s=rate,
                hand_kernel="no Pallas counterpart (hgtpu's lax.scan)"))
    return records["bits"], records["warp"]


def dryrun_phase(big, dev):
    """dryrun_multichip(1) on the card, and the pure-device EM program at
    the scale panel (tests/test_hla_scale.py's sharded test on one
    device) against the port's CPU run."""
    import numpy as np
    import torch
    from hgtpu_torch.db.catalog import VT_SINGLE
    from hgtpu_torch.entry import dryrun_multichip
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.sim import simulate_reads

    t0 = time.perf_counter()
    dryrun_multichip(1, device=dev)
    dryrun_multichip(2, device=dev)
    torch.cuda.synchronize()
    t_dry = time.perf_counter() - t0
    snp = big.var_type == VT_SINGLE
    truth = next(n for i, n in enumerate(big.allele_names)
                 if big.links[~snp, i].any() and big.links[snp, i].any())
    r1, r2, _ = simulate_reads(big, [truth], simulate_interval=8, seed=3)
    outs, walls = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        typer = ShardedTyper(big, d, em_iters=300, max_ht_vars=32,
                             max_indel_cand=8)
        c1 = typer.encode([r.seq for r in r1])
        c2 = typer.encode([r.seq for r in r2])
        t0 = time.perf_counter()
        outs[where] = typer.call_pairs(c1, c2)
        walls[where] = time.perf_counter() - t0
    prob, totals, n_used, punt = outs["card"]
    top = int(np.argmax(prob))
    if big.allele_names[top] != truth or prob[top] <= 0.999:
        raise AssertionError("dryrun: call_pairs called %s at %.6f, truth "
                             "%s" % (big.allele_names[top], prob[top],
                                     truth))
    if punt.sum() > 0.35 * len(r1) or n_used <= 0.6 * len(r1):
        raise AssertionError("dryrun: %d punts, %g used of %d pairs"
                             % (punt.sum(), n_used, len(r1)))
    c_prob, c_totals, c_used, c_punt = outs["cpu"]
    if not (np.array_equal(totals, c_totals) and n_used == c_used
            and np.array_equal(punt, c_punt)):
        raise AssertionError("dryrun: call_pairs on the card differs from "
                             "the CPU run (totals, n_used or punt)")
    log("dryrun: dryrun_multichip(1) and (2) passed (%.2f s); call_pairs "
        "at the scale panel, %d pairs: %s at %.6f (truth), n_used %g, "
        "punts %d; "
        "totals, n_used and punt equal to the CPU run, prob max diff %.3g; "
        "wall card %.2f s, CPU %.2f s"
        % (t_dry, len(r1), truth, prob[top], n_used, int(punt.sum()),
           float(np.abs(prob - c_prob).max()), walls["card"], walls["cpu"]))


def mesh_rank(spec):
    """One rank of the mesh phase, in its own process (`chip_smoke.py
    --mesh-rank <json>`): joins the group on cuda:0 over spec["backend"]
    (None: "cpu:gloo,cuda:nccl"), types its half of the scale cell's pairs
    with type_reads_device_distributed on a one-shard local mesh, then
    runs distributed_call on its half of the padded single-end codes over
    a mesh that spans the ranks; prints one MESHRANK JSON line: the
    results, walls, TRACE's dist.* stages and the launches of each
    kernel in each call."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from hgtpu_torch.db import load_npz
    from hgtpu_torch.ops.banded_dp import banded_costs_bits, banded_costs_warp
    from hgtpu_torch.ops.compat_kernel import and_reduce_slab, and_reduce_wide
    from hgtpu_torch.ops.placement_kernel import placement_scores
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.multihost import (
        distributed_call, global_mesh, init_distributed, pad_reads,
        process_read_shard, type_reads_device_distributed)
    from hgtpu_torch.parallel.sharded import Mesh
    from hgtpu_torch.typer import TypingOptions
    from hgtpu_torch.utils.trace import TRACE

    fns = (("placement_scores", placement_scores),
           ("and_reduce_slab", and_reduce_slab),
           ("and_reduce_wide", and_reduce_wide),
           ("banded_dp_bits", banded_costs_bits),
           ("banded_dp_warp", banded_costs_warp))

    def launches():
        out = {k: f.launches for k, f in fns}
        for _k, f in fns:
            f.launches = 0
        return out

    rank, world = spec["rank"], spec["world"]
    card = torch.device("cuda", 0)
    t0 = time.perf_counter()
    gene = load_npz(spec["gene"]).genes["A"]
    with open(spec["reads"]) as f:
        R1, R2 = [[tuple(r) for r in rs] for rs in json.load(f)]
    set_up = time.perf_counter() - t0
    assert init_distributed("localhost:%d" % spec["port"], world, rank,
                            backend=spec["backend"], device=card) \
        == (rank, world)
    backend = str(dist.get_backend())
    # a collective on the card through the group's CUDA backend
    probe = torch.full((1,), rank + 1, dtype=torch.int32, device=card)
    dist.all_reduce(probe)
    probe = int(probe.item())

    n = len(R1)
    lo, hi = rank * n // world, (rank + 1) * n // world
    launches()
    TRACE.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = type_reads_device_distributed(
        gene, R1[lo:hi], R2[lo:hi], TypingOptions(simulation=True),
        global_start=lo, n_global=n, mesh=Mesh([card]))
    torch.cuda.synchronize()
    wall_typing = time.perf_counter() - t0
    stages = {k: v for k, v in TRACE.summary().items()
              if k.startswith("dist.") or k == "rescue.fold"}
    typing_launches = launches()

    typer = ShardedTyper(gene, em_iters=300, mesh=global_mesh(card))
    codes = pad_reads(typer.encode([s for _, s in R1 + R2]), world)
    start, stop = process_read_shard(codes.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob, totals, n_used, punt = distributed_call(typer, codes[start:stop])
    torch.cuda.synchronize()
    wall_call = time.perf_counter() - t0
    call_launches = launches()
    dist.destroy_process_group()
    print("MESHRANK " + json.dumps(dict(
        rank=rank, backend=backend, probe=probe, set_up=set_up,
        typing=[list(res.cmpt.items()), list(res.exon_cmpt.items()),
                res.prob, res.num_reads, res.num_pairs,
                sorted(res.novel_vars)],
        wall_typing=wall_typing, stages=stages,
        typing_launches=typing_launches,
        call=[np.asarray(prob).tolist(), np.asarray(totals).tolist(),
              float(n_used), np.flatnonzero(punt).tolist(), start, stop],
        wall_call=wall_call, call_launches=call_launches)), flush=True)
    return 0


def run_ranks(world, backend, gene_path, reads_path, work, timeout=420):
    """Start `world` ranks of mesh_rank on cuda:0 and return their
    MESHRANK records; every rank is killed when one fails or passes the
    time limit.  Each rank's output goes to files under `work`."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs, files = [], []
    try:
        for rank in range(world):
            spec = dict(rank=rank, world=world, port=port, backend=backend,
                        gene=gene_path, reads=reads_path)
            out = open(os.path.join(work, "rank%d-%d.out" % (world, rank)),
                       "w+")
            err = open(os.path.join(work, "rank%d-%d.err" % (world, rank)),
                       "w+")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 json.dumps(spec)], stdout=out, stderr=err, cwd=ROOT))
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        recs = []
        for rank, p in enumerate(procs):
            out, err = files[2 * rank], files[2 * rank + 1]
            out.seek(0)
            err.seek(0)
            text = out.read()
            if p.returncode != 0:
                raise AssertionError("mesh: rank %d of %d (backend %s) exited "
                                     "%d: %s" % (rank, world, backend,
                                                 p.returncode,
                                                 err.read()[-3000:]))
            recs += [json.loads(line[len("MESHRANK "):])
                     for line in text.splitlines()
                     if line.startswith("MESHRANK ")]
        if sorted(r["rank"] for r in recs) != list(range(world)):
            raise AssertionError("mesh: ranks printed %s"
                                 % [r["rank"] for r in recs])
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def mesh_phase(big, b1, b2, big_gpu, prod_res, prod_wall, prod_opts, dev,
               counts, reset, work):
    """Many devices on one card, at the scale cell: a mesh of 2 shards on
    cuda:0 held against the mesh of one (count_classes' mesh-invariant
    fields; type_reads_device field for field), its launches counted
    (counts set to 0 just before, read just after); then two ranks on
    cuda:0 over gloo and a one-rank world over "cpu:gloo,cuda:nccl",
    each running type_reads_device_distributed and distributed_call on
    its share, held against this process's runs.  Returns the 2-shard
    run's launches."""
    import numpy as np
    import torch
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import save_npz
    from hgtpu_torch.parallel import production
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.multihost import pad_reads
    from hgtpu_torch.parallel.sharded import make_mesh

    mesh2 = make_mesh(2, dev)
    st1 = production._shared_sharded_typer(
        big, prod_opts, production.default_mesh(dev), 100)
    st2 = production._shared_sharded_typer(big, prod_opts, mesh2, 100)
    c1 = st1.encode([s for _, s in b1])
    c2 = st1.encode([s for _, s in b2])
    outs, walls = {}, {}
    for k, st in ((1, st1), (2, st2)):
        st.count_classes(c1, c2)            # warm: the 2-shard typer's first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[k] = st.count_classes(c1, c2)
        torch.cuda.synchronize()
        walls[k] = time.perf_counter() - t0

    def agg(rows, w):
        out = {}
        for r, x in zip(rows, w):
            out[r.tobytes()] = out.get(r.tobytes(), 0) + int(x)
        return out

    o1, o2 = outs[1], outs[2]
    for key in ("pileup", "punt", "excl"):
        if not np.array_equal(o1[key], o2[key]):
            raise AssertionError("mesh: count_classes' %s differs between 1 "
                                 "and 2 shards" % key)
    if (o1["n_reads"], o1["n_pairs"]) != (o2["n_reads"], o2["n_pairs"]):
        raise AssertionError("mesh: count_classes' counts differ")
    for name, (rows, w, tot) in o1["levels"].items():
        rows2, w2, tot2 = o2["levels"][name]
        if not np.array_equal(tot, tot2) or agg(rows, w) != agg(rows2, w2):
            raise AssertionError("mesh: count_classes' %s classes differ "
                                 "between 1 and 2 shards" % name)

    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = production.type_reads_device(big, b1, b2, prod_opts,
                                        aligner=big_gpu, mesh=mesh2)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = counts()
    for f in FIELDS:
        x, y = getattr(res2, f), getattr(prod_res, f)
        if isinstance(x, dict):
            x, y = list(x.items()), list(y.items())
        if x != y:
            raise AssertionError("mesh: type_reads_device on 2 shards: %s "
                                 "differs from the one-shard run" % f)
    log("mesh: 2 shards on %s: count_classes equal to 1 shard's (pileup, "
        "punt, excl, counts, every level's totals and classes; %d vs %d "
        "rows), %.3f s vs %.3f s; type_reads_device equal field for field "
        "to prod-scale's, warm wall %.3f s (1 shard: %.3f s); launches %s"
        % (dev, sum(len(v[0]) for v in o2["levels"].values()),
           sum(len(v[0]) for v in o1["levels"].values()), walls[2],
           walls[1], wall2, prod_wall, launches))

    # ---- ranks: the gene and reads on disk, one process per rank ---- #
    os.makedirs(work, exist_ok=True)
    gene_path = os.path.join(work, "scale.npz")
    reads_path = os.path.join(work, "scale_reads.json")
    save_npz(Catalog(family="hla", genes={"A": big}), gene_path)
    with open(reads_path, "w") as f:
        json.dump([b1, b2], f)
    seqs = [s for _, s in b1 + b2]
    want_typing = [[list(x) for x in prod_res.cmpt.items()],
                   [list(x) for x in prod_res.exon_cmpt.items()],
                   [list(x) for x in prod_res.prob], prod_res.num_reads,
                   prod_res.num_pairs]
    for world, backend in ((2, "gloo"), (1, None)):
        t0 = time.perf_counter()
        recs = run_ranks(world, backend, gene_path, reads_path, work)
        wall = time.perf_counter() - t0
        # the single-process runs they must equal: prod-scale's typing,
        # and call over a mesh of `world` shards on this card
        typer = ShardedTyper(big, em_iters=300, mesh=make_mesh(world, dev))
        codes = pad_reads(typer.encode(seqs), world)
        prob, totals, n_used, punt = typer(codes)
        what = "%d rank(s), backend %s" % (world, recs[0]["backend"])
        for r in recs:
            if r["typing"][:5] != want_typing:
                raise AssertionError("mesh: %s: rank %d's "
                                     "type_reads_device_distributed differs "
                                     "from the single-process run"
                                     % (what, r["rank"]))
            c_prob, c_tot, c_used, c_punt, start, stop = r["call"]
            err = float(np.abs(np.asarray(c_prob) - prob).max())
            # the same top call, up to a tie within the tolerance (the het
            # pair's two alleles are near 0.5 each)
            same = dict(
                top=c_prob[int(np.argmax(prob))] >= max(c_prob) - 2e-6,
                prob=err <= 1e-6, totals=c_tot == np.asarray(totals).tolist(),
                n_used=c_used == float(n_used),
                punt=c_punt == np.flatnonzero(punt[start:stop]).tolist())
            if not all(same.values()):
                raise AssertionError("mesh: %s: rank %d's distributed_call "
                                     "differs from one process's: %s (prob "
                                     "max diff %g)" % (what, r["rank"], same,
                                                       err))
            if r["probe"] != world * (world + 1) // 2:
                raise AssertionError("mesh: %s: all_reduce on the card gave "
                                     "%d" % (what, r["probe"]))
            if r["typing_launches"]["placement_scores"] <= 0 \
                    or r["call_launches"]["placement_scores"] <= 0:
                raise AssertionError("mesh: %s: K1 never launched on rank %d"
                                     % (what, r["rank"]))
            log("mesh: %s, rank %d: type_reads_device_distributed on pairs "
                "[%d, %d) equal to the single-process run (%d novel ids), "
                "wall %.3f s, stages %s, launches %s; distributed_call on "
                "rows [%d, %d): top %s, prob max diff %.3g, totals, n_used "
                "and punt equal, wall %.3f s, launches %s; set-up %.1f s"
                % (what, r["rank"], r["rank"] * len(b1) // world,
                   (r["rank"] + 1) * len(b1) // world, len(r["typing"][5]),
                   r["wall_typing"],
                   {k: (round(v["s"], 4), v["n"])
                    for k, v in r["stages"].items()},
                   r["typing_launches"], start, stop,
                   big.allele_names[int(np.argmax(c_prob))], err,
                   r["wall_call"], r["call_launches"], r["set_up"]))
        log("mesh: %s: %.1f s with process start" % (what, wall))
    return launches


FAMILY_GENES = ("A", "B", "C", "DQA1", "DQB1", "DRB1")


def build_family(genes=FAMILY_GENES, n_alleles=200, length=3500,
                 interval=2, n_bg=2000, seed=21):
    """One sample over an HLA-like family: tests/synth.make_family's
    genes through the port's build_catalog_from_msa, a heterozygous truth
    pair per gene (reads every `interval` bases, named by gene so that
    mates group per gene) and n_bg background pairs cut from the flanks
    between the loci, as tests/test_family.py:55-62 cuts them.  Returns
    (family, catalog, truths {gene: [a, b]}, reads per gene {gene:
    (reads_1, reads_2)}, reads_1, reads_2)."""
    import numpy as np
    from synth import make_family
    from hgtpu_torch.db import build_catalog_from_msa
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.utils.dna import revcomp

    fam = make_family(genes=genes, n_alleles=n_alleles, length=length,
                      seed=seed)
    cat = build_catalog_from_msa("hla", {
        g: dict(names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"],
                exons=s["exons"], primary_exon_idx=s["primary_exon_idx"])
        for g, s in fam["specs"].items()}, min_var_freq=0.0)
    rng = np.random.default_rng(seed)
    truths, per_gene, reads_1, reads_2 = {}, {}, [], []
    for k, (g, gene) in enumerate(cat.genes.items()):
        pick = rng.choice(gene.n_alleles, 2, replace=False)
        truths[g] = sorted(gene.allele_names[int(i)] for i in pick)
        r1, r2, _ = simulate_reads(gene, truths[g],
                                   simulate_interval=interval, seed=k)
        per_gene[g] = ([(g + r.name, r.seq) for r in r1],
                       [(g + r.name, r.seq) for r in r2])
        reads_1 += per_gene[g][0]
        reads_2 += per_gene[g][1]
    genome = fam["genome"]
    loci = sorted(fam["loci"].values())
    for i in range(n_bg):
        while True:
            p = int(rng.integers(0, len(genome) - 260))
            if all(p + 250 <= lo or p >= hi for lo, hi in loci):
                break
        frag = genome[p:p + 250]
        reads_1.append(("bg%d" % i, frag[:100]))
        reads_2.append(("bg%d" % i, revcomp(frag[-100:])))
    return fam, cat, truths, per_gene, reads_1, reads_2


@contextlib.contextmanager
def k1_spies(operands=None):
    """Counts the K1 calls of the panel router and of the per-gene
    placements, {"router": n, "gene": n} (a spy wraps each module's
    uncounted callee, so the kernel's own launch counter stays the only
    count); the router's first operands of each read width go into
    `operands` {m: (pwm, reads)} when it is given."""
    from hgtpu_torch.align import panel
    from hgtpu_torch.ops import placement as tplace

    calls = {"router": 0, "gene": 0}
    real_router, real_gene = panel.correlate_scores, tplace.correlate_scores

    def router_spy(pwm, reads):
        calls["router"] += 1
        if operands is not None:
            operands.setdefault(reads.shape[1], (pwm, reads))
        return real_router(pwm, reads)

    def gene_spy(pwm, reads):
        calls["gene"] += 1
        return real_gene(pwm, reads)

    panel.correlate_scores = router_spy
    tplace.correlate_scores = gene_spy
    try:
        yield calls
    finally:
        panel.correlate_scores = real_router
        tplace.correlate_scores = real_gene


def family_phase(cat, truths, reads_1, reads_2, dev, counts, reset,
                 sam_prefix, bounds):
    """type_family on `dev` (FamilyAligner routes through the panel
    router: 6 genes) against the port's CPU run, gene by gene and field by
    field, every truth pair on top; and ReadExtractor on the same reads
    against its CPU run.  A warm-up run first (tables, per-gene typers;
    it writes the per-gene SAM files under sam_prefix and records the
    router's K1 operands and, into `bounds`, every launch of the verify
    prep's proposal bound), then the run whose launches are counted: the
    counts are set to 0 just before it and read just after.  Returns
    (launches, router operands {m: (pwm, reads)}, family aligner, the
    K1 calls of that run: {"router": n, "gene": n}, its results, its
    wall)."""
    import torch
    from hgtpu_torch.align import FamilyAligner
    from hgtpu_torch.pipeline import ReadExtractor, type_family
    from hgtpu_torch.utils.trace import TRACE

    on_card = dev.type == "cuda"
    fa = FamilyAligner(cat, device=dev)
    if fa.router is None:
        raise AssertionError("family: the router is off for %d genes"
                             % len(cat.genes))
    operands = {}
    with k1_spies(operands) as calls:
        t0 = time.perf_counter()
        with bound_spy(bounds):
            type_family(cat, reads_1, reads_2, family_aligner=fa,
                        sam_out=sam_prefix)
        if on_card:
            torch.cuda.synchronize()
        log("setup: family warm-up run on %s %.2f s"
            % (dev.type, time.perf_counter() - t0))
        reset()
        calls.update(router=0, gene=0)
        TRACE.reset()
        t0 = time.perf_counter()
        res = type_family(cat, reads_1, reads_2, family_aligner=fa)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        proof = dict(calls)
        stages = TRACE.summary()
    t0 = time.perf_counter()
    ref = type_family(cat, reads_1, reads_2, device="cpu")
    cpu_s = time.perf_counter() - t0
    if list(res) != list(ref) or list(res) != list(cat.genes):
        raise AssertionError("family: genes %s, CPU %s" % (list(res),
                                                           list(ref)))
    n_reads = len(reads_1) + len(reads_2)
    for g in res:
        same_result(res[g], ref[g], "family %s" % g)
        check_truths(res[g], truths[g], "family %s" % g)
    log("family: %d genes x %d alleles, %d pairs (%d reads): every gene "
        "equals the CPU run, truths on top (%s); warm wall %.3f s, %.1f "
        "reads/s (CPU run %.1f s); router K1 launches %d, per-gene "
        "placements %d"
        % (len(cat.genes), next(iter(cat.genes.values())).n_alleles,
           len(reads_1), n_reads,
           ", ".join("%s %.2f/%.2f" % (g, r.prob[0][1], r.prob[1][1])
                     for g, r in res.items()),
           wall, n_reads / wall, cpu_s, proof["router"], proof["gene"]))
    top = sorted(((k, v["s"]) for k, v in stages.items() if "." in k),
                 key=lambda kv: -kv[1])[:10]
    log("family: TRACE stages of the warm run (s, nested): %s"
        % ", ".join("%s %.4f" % kv for kv in top))
    t0 = time.perf_counter()
    routed = ReadExtractor({"hla": cat}, device=dev).extract(reads_1,
                                                             reads_2)
    ex_s = time.perf_counter() - t0
    routed_cpu = ReadExtractor({"hla": cat}, device="cpu").extract(reads_1,
                                                                   reads_2)
    if routed != routed_cpu:
        raise AssertionError("family: ReadExtractor on the card differs "
                             "from the CPU run")
    kept = {n for n, _ in routed.get("hla", ([], []))[0]}
    n_bg = sum(n.startswith("bg") for n, _ in reads_1)
    if sum(not n.startswith("bg") for n in kept) < 0.9 * (len(reads_1)
                                                          - n_bg) \
            or sum(n.startswith("bg") for n in kept) > 0.01 * n_bg:
        raise AssertionError("family: ReadExtractor kept %d of %d gene "
                             "pairs and %d of %d background pairs"
                             % (sum(not n.startswith("bg") for n in kept),
                                len(reads_1) - n_bg,
                                sum(n.startswith("bg") for n in kept), n_bg))
    log("family: ReadExtractor routed %d of %d pairs (%d background of "
        "%d), equal to the CPU run; %.2f s with its set-up"
        % (len(kept), len(reads_1), sum(n.startswith("bg") for n in kept),
           n_bg, ex_s))
    return launches, operands, fa, proof, res, wall


@contextlib.contextmanager
def bound_spy(calls):
    """Records every launch of the verify prep's proposal bound into
    `calls`: (aligner, codes, mask, entries, cap, bound), the codes,
    entries and bound copied as the kernel saw and gave them."""
    from hgtpu_torch.align import aligner as amod

    real_bound, real_lb = amod.proposal_bound, amod.GeneAligner._lb_entries
    who = [None]

    def lb_spy(self, *a, **k):
        who[0] = self
        return real_lb(self, *a, **k)

    def spy(codes, mask, entries, cap):
        out = real_bound(codes, mask, entries, cap)
        calls.append((who[0], codes.clone(), mask, entries.clone(), cap,
                      out.clone()))
        return out

    amod.proposal_bound = spy
    amod.GeneAligner._lb_entries = lb_spy
    try:
        yield calls
    finally:
        amod.proposal_bound = real_bound
        amod.GeneAligner._lb_entries = real_lb


# hla6.wgs30's per-call entries of the proposal bound, its median call and
# its largest (the benchmark's samples, each call recorded; PERF.md)
BOUND_E_CELL = (7399, 57112)


def bound_phase(calls, timer):
    """The verify prep's proposal bound: every call recorded in the
    family warm-up (bound_spy) held against the aligner's numpy
    _lb_core on the same inputs, bitwise, the kernel's own output and a
    second launch; then timed (timer = cuda_ms) at the recorded median
    and largest call and at hla6.wgs30's per-call entries (BOUND_E_CELL:
    the largest recorded call's entries repeated to that many), beside
    _lb_core's host time.  Bound: bytes (12 per entry in, 1 out, each code
    row the entries read once, the table once).  Returns the JSON
    records."""
    import numpy as np
    import torch
    from hgtpu_torch.ops.proposal_bound import proposal_bound

    if not calls:
        raise AssertionError("bound: the family run never launched the "
                             "proposal bound")

    def lb_core(ga, codes, ent, cap):
        # the aligner's plain bound on the kernel's inputs (past a row's
        # end the code is 5, never free, as the kernel reads it)
        if cap != ga.num_editdist + 1:
            raise AssertionError("bound: cap %d, budget %d"
                                 % (cap, ga.num_editdist))
        e = ent.cpu().numpy().astype(np.int64)
        rows, base, cw = e.T
        clip, win = cw & 0xFFFF, cw >> 16
        W = int(win.max())
        c = codes.cpu().numpy()
        c = np.concatenate([c, np.full((len(c), W), 5, np.int8)], 1)

        def fetch(active, at, w):
            return c[rows[active][:, None],
                     clip[active][:, None] + at + np.arange(w)]

        return ga._lb_core(fetch, len(rows), base - ga._LB_PAD, win, W)

    n_kept = 0
    for k, (ga, codes, mask, ent, cap, got) in enumerate(calls):
        want = lb_core(ga, codes, ent, cap)
        again = proposal_bound(codes, mask, ent, cap).cpu().numpy()
        if not (np.array_equal(got.cpu().numpy(), want)
                and np.array_equal(again, want)):
            raise AssertionError(
                "bound: kernel != _lb_core at call %d (E=%d, %d entries "
                "differ)" % (k, ent.shape[0],
                             int((got.cpu().numpy() != want).sum())))
        n_kept += int((want < cap).sum())
    Es = sorted(c[3].shape[0] for c in calls)
    W_max = max(int((c[3][:, 2] >> 16).max()) for c in calls)
    log("bound: %d calls of the family warm-up (E median %d, max %d, total "
        "%d; W <= %d), each equal to _lb_core bitwise (the recorded output "
        "and a second launch); %d entries within the budget"
        % (len(calls), Es[len(Es) // 2], Es[-1], sum(Es), W_max, n_kept))

    by_e = sorted(range(len(calls)), key=lambda k: calls[k][3].shape[0])
    largest = calls[by_e[-1]]
    cases = [(calls[by_e[len(by_e) // 2]], "family run, median call"),
             (largest, "family run, largest call")]
    for E in BOUND_E_CELL:
        idx = torch.arange(E, device=largest[3].device) \
            % largest[3].shape[0]
        cases.append((largest[:3] + (largest[3][idx].contiguous(),)
                      + largest[4:], "hla6.wgs30's E, the largest call's "
                      "entries repeated"))
    records = []
    for (ga, codes, mask, ent, cap, _got), where in cases:
        E = ent.shape[0]
        ms = timer(lambda: proposal_bound(codes, mask, ent, cap))
        t0 = time.perf_counter()
        lb_core(ga, codes, ent, cap)
        host_ms = (time.perf_counter() - t0) * 1e3
        n_rows = int(torch.unique(ent[:, 0]).numel())
        nbytes = 13 * E + n_rows * codes.shape[1] + mask.numel()
        b_ms, b_by = bound_ms(nbytes, 0, PEAK_F32_S)
        log("bound: %s E=%d W<=%d: kernel %.4f ms; _lb_core on the host "
            "%.2f ms; bound %.5f ms (%s: %d bytes), %.1f %% of it"
            % (where, E, int((ent[:, 2] >> 16).max()), ms, host_ms, b_ms,
               b_by, nbytes, 100 * b_ms / ms))
        records.append(dict(
            name="proposal_bound", path="family", route="cuda",
            source="hgtpu_torch/csrc/proposal_bound.cu",
            replaces="none: hgtpu bounds on the host "
                     "(hgtpu/align/aligner.py:_lb_core)",
            max_abs_err=0.0, ms=ms, plain_ms=None, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            library="none: no torch call computes the bound",
            plain="GeneAligner._lb_core (numpy, host)",
            plain_host_ms=host_ms,
            shape="E=%d W<=%d (%s)" % (E, int((ent[:, 2] >> 16).max()),
                                       where),
            shapes_checked=len(calls)))
    return records


def panel_phase(router, cpu_router, operands, long_seqs, timer):
    """K1 at the router's shape, m = 128 (the family run's operands) and
    m = 512 (reads past the spacer, clipped as gene_max clips them),
    against its plain version, exact; gene_max on the card against the
    CPU's on 8,192 reads of each width; then the kernel, the plain
    version and one torch.mm timed (timer = cuda_ms).  Returns the K1
    records of both widths."""
    import numpy as np
    import torch
    from hgtpu_torch.align import panel
    from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                                  placement_scores_plain)

    real = panel.correlate_scores

    def spy(pwm, reads):
        operands.setdefault(reads.shape[1], (pwm, reads))
        return real(pwm, reads)

    panel.correlate_scores = spy
    try:
        router.gene_max(long_seqs)
    finally:
        panel.correlate_scores = real
    if sorted(operands) != [128, 512]:
        raise AssertionError("panel: router widths %s, want 128 and 512"
                             % sorted(operands))
    short = long_seqs[:4096]
    for width, seqs in ((128, [s[:100] for s in short] * 2),
                        (512, short * 2)):
        gm, lens = router.gene_max(seqs)
        gm_c, lens_c = cpu_router.gene_max(seqs)
        if not (np.array_equal(gm, gm_c) and np.array_equal(lens, lens_c)):
            raise AssertionError("panel: gene_max on the card differs from "
                                 "the CPU's at m=%d" % width)
    records = []
    for m in (128, 512):
        pwm, reads = operands[m]
        n, P1 = reads.shape[0], pwm.shape[0] - m + 1
        out_gb = n * P1 * 4 / 1e9
        got = placement_scores(pwm, reads)
        want = placement_scores_plain(pwm, reads)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError("panel: K1 != plain at N=%d m=%d P1=%d, "
                                 "max abs err %g" % (n, m, P1, err))
        del want
        lib = k1_library(pwm, reads)
        lib_err = float((lib() - got).abs().max())
        del got
        ms = timer(lambda: placement_scores(pwm, reads), iters=5, warmup=1)
        plain_ms = timer(lambda: placement_scores_plain(pwm, reads),
                         iters=2, warmup=1)
        lib_ms = timer(lib, iters=5, warmup=1)
        del lib
        nbytes = n * m + pwm.shape[0] * 5 * 4 + n * P1 * 4
        ops = 2 * n * 5 * m * P1
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_S)
        log("panel: K1 at the router's shape N=%d m=%d P1=%d (%d genes, "
            "%.2f GB float32 output) exact; kernel %.4f ms (%.1f TFLOP/s, "
            "output %.0f GB/s), plain %.4f ms, library torch.mm %.4f ms "
            "(max abs err vs kernel %g); bound %.4f ms (%s), kernel at "
            "%.1f %% of it"
            % (n, m, P1, len(router.keys), out_gb, ms, ops / ms / 1e9,
               n * P1 * 4 / ms / 1e6, plain_ms, lib_ms, lib_err, b_ms, b_by,
               100 * b_ms / ms))
        records.append(dict(
            name="placement_scores", route="cuda",
            source="hgtpu_torch/csrc/placement_scores.cu",
            replaces="hgtpu/ops/placement_pallas.py:48", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms,
            library="torch.mm(onehot bf16 [N, 5m], windows bf16 [5m, P1], "
                    "out_dtype=float32); max abs err vs the kernel %g"
                    % lib_err,
            shape="N=%d m=%d P1=%d (panel router, %d genes)"
                  % (n, m, P1, len(router.keys)),
            output_bytes=n * P1 * 4, path="family"))
    return records


def fm_cpu_copy(ex):
    """The same GenomeExtractor with its FM index's tables on the CPU:
    the CPU run of the port's FM search on the same index."""
    import copy

    cpu = copy.copy(ex)
    cpu.fm = copy.copy(ex.fm)
    for name in ("_C_dev", "_ckpt_dev", "_bwt_dev", "_occ_dev"):
        t = getattr(ex.fm, name)
        setattr(cpu.fm, name, None if t is None else t.cpu())
    cpu.fm.device = cpu.fm._C_dev.device
    return cpu


def extract_phase(cat, fam, truths, reads_1, reads_2, dev, out_prefix,
                  n_route=100_000, chr_len=16_000_000, seed=7):
    """The genome-scale path: build_genotype_genome of the family genome
    plus a random chromosome chrR of chr_len bases, GenomeExtractor over
    it (the checkpointed FM index on `dev`), n_route single-end 100-bp
    reads cut from the spliced genome as bench.py cuts them, routed on
    the card and by the CPU run of the same index, equal; then the
    family's own pairs extracted and typed with type_family, truths on
    top."""
    import numpy as np
    import torch
    from hgtpu_torch.db import build_genotype_genome
    from hgtpu_torch.native import have_native
    from hgtpu_torch.ops.fm import FMIndex
    from hgtpu_torch.pipeline import GenomeExtractor, type_family

    if not have_native():
        raise AssertionError("extract: the native SA-IS library is not "
                             "loaded (make -C native)")
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    chr_r = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, chr_len)].tobytes().decode()
    for g, (lo, hi) in fam["loci"].items():
        gene = cat.genes[g]
        gene.chrom, gene.chrom_left, gene.chrom_right = "chrS", lo, hi
    t0 = time.perf_counter()
    spliced, offsets = build_genotype_genome(
        {"chrS": fam["genome"], "chrR": chr_r}, {"hla": cat}, out_prefix)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = GenomeExtractor(spliced, offsets, {"hla": cat}, device=dev)
    t_index = time.perf_counter() - t0
    n1 = ex.fm.n + 1
    log("setup: genotype genome %d bases (chrS %d + chrR %d) built in "
        "%.2f s; checkpointed FM index (native SA-IS) on %s in %.2f s: "
        "n+1 = %d, %d blocks of 64"
        % (sum(map(len, spliced.values())), len(spliced["chrS"]),
           len(spliced["chrR"]), t_build, dev.type, t_index, n1,
           ex.fm._bwt_dev.shape[0]))
    # reads cut as bench.py:175-181 cuts them, from the whole spliced
    # genome (both chromosomes and the N between them)
    L = 100
    text = np.frombuffer(b"ACGTN.", np.uint8)[ex.codes]
    pos = rng.integers(0, len(text) - L, n_route)
    cut = text[pos[:, None] + np.arange(L)[None, :]]
    reads = [("q%d" % i, cut[i].tobytes().decode()) for i in range(n_route)]
    timing = {"s": 0.0, "calls": 0, "queries": 0}
    real = FMIndex.search_batch

    def timed(self, queries):
        t = time.perf_counter()
        out = real(self, queries)       # ends in a fetch: synchronised
        timing["s"] += time.perf_counter() - t
        timing["calls"] += 1
        timing["queries"] += len(queries)
        return out

    ex.extract(reads[:1000], None)      # warm-up
    FMIndex.search_batch = timed
    try:
        t0 = time.perf_counter()
        routed = ex.extract(reads, None)
        wall = time.perf_counter() - t0
    finally:
        FMIndex.search_batch = real
    cpu = fm_cpu_copy(ex)
    t0 = time.perf_counter()
    routed_cpu = cpu.extract(reads, None)
    cpu_s = time.perf_counter() - t0
    if routed != routed_cpu:
        raise AssertionError("extract: the routed reads differ between the "
                             "card's FM search and the CPU's")
    # device kernels of one search of the same queries
    seeds = timing["queries"]
    n_kernels, dev_ms = None, None
    if on_card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        k = ex.seed_len
        q = ex.codes[rng.integers(0, n1 - k - 1, seeds)[:, None]
                     + np.arange(k)[None, :]]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ex.fm.search_batch(q)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        n_kernels = len(kern)
        dev_ms = sum(e.device_time for e in kern) / 1e3
    log("extract: %d single-end reads routed in %.3f s (%.1f reads/s), "
        "equal to the CPU run of the same index (%.1f s); routed %s; FM "
        "search %d calls, %d seed queries of %d bases, %.4f s on the host "
        "clock (launch, loop and fetch); one search of %d queries: %s "
        "device kernels, %s ms device time"
        % (n_route, wall, n_route / wall, cpu_s,
           {f: len(v[0]) for f, v in routed.items()}, timing["calls"],
           seeds, ex.seed_len, timing["s"], seeds, n_kernels,
           "%.4f" % dev_ms if dev_ms is not None else "not measured"))
    fam_routed = ex.extract(reads_1, reads_2)
    if "hla" not in fam_routed:
        raise AssertionError("extract: no family read was routed")
    got = fam_routed["hla"]
    n_bg = sum(n.startswith("bg") for n, _ in reads_1)
    n_gene = sum(not n.startswith("bg") for n, _ in got[0])
    if n_gene < 0.8 * (len(reads_1) - n_bg):
        raise AssertionError("extract: %d of %d gene pairs routed"
                             % (n_gene, len(reads_1) - n_bg))
    res = type_family(cat, *got, device=dev)
    for g, r in res.items():
        check_truths(r, truths[g], "extract %s" % g)
    log("extract: the family's %d pairs: %d gene pairs and %d of %d "
        "background pairs routed; type_family on them: truths on top in "
        "every gene" % (len(reads_1), n_gene,
                        sum(n.startswith("bg") for n, _ in got[0]), n_bg))


def report_lines(path):
    """A report's lines without the one after `# COMMAND:` (the argv of
    the process that wrote it)."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = lines.index("# COMMAND:")
    return lines[:i + 1] + lines[i + 2:]


def write_reports(results, simulation):
    """Reports as hgtpu_torch.cli.main writes them, from results already
    in hand: [(path, [(true alleles, GeneTypingResult), ...])]."""
    from hgtpu_torch.typer.report import ReportWriter

    for path, rows in results:
        w = ReportWriter(path)
        w.header(dbversion="NONE", command=" ".join(sys.argv))
        w.begin_aligner()
        for true_alleles, res in rows:
            w.gene_result(res, simulation=simulation,
                          true_alleles=true_alleles)
        w.close()


def cli_phase(cat, truths, reads_1, reads_2, fam_res, fam_wall, big, toy,
              dev, counts, reset, work, smi):
    """The command line on the card, in process, with no device given
    (so it takes the card):

    - the family's sample: the catalog written with the port's
      export_text, its pairs as gzipped FASTQ with write_fastq, then
      `main(["--base", "hla", "--ix-dir", DB, "-1", .., "-2", ..])`; rc
      0, and the report equal, line for line but the argv line, to the
      one ReportWriter writes from the family phase's results; K1
      (router, per gene), K2 and bit-DP launches counted inside the call;
    - the simulation self-test at HLA-A scale: the 3,600-allele gene as
      gene A of a text database, `--locus-list A --debug
      basic,test_size:5,set_seed:101`; rc 0 (every truth ranked first),
      the production path taken (K1 in the place pass, K2 in the
      rescue's fold, the bit DP wherever the native verifier is built),
      and the five reports equal to those of an in-process
      simulation_sweep with the same arguments;
    - `python -m hgtpu_torch` in a subprocess (a small simulation on the
      toy gene, test_size:1, no HGTPU_TORCH_DEVICE), then
      `python -m hgtpu_torch.cli.toolkit parse-results` over the family
      run's output: its CSV names each gene's truth pair.

    Prints `cli:` lines with the walls, rates, launches and import_text's
    time at 3,600 alleles, beside the card's name and power limit."""
    import shutil
    import numpy as np
    import torch
    from hgtpu_torch.cli import main as cli
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import export_text, import_text
    from hgtpu_torch.native import have_native
    from hgtpu_torch.pipeline import simulation_sweep
    from hgtpu_torch.utils.io import read_fastx, write_fastq
    from hgtpu_torch.utils.trace import TRACE

    if os.environ.get(cli.DEVICE_ENV):
        raise AssertionError("cli: %s is set; the phase needs the default "
                             "device" % cli.DEVICE_ENV)
    root = os.path.join(work, "cli")
    shutil.rmtree(root, ignore_errors=True)

    # ---- the family's sample, real reads ---- #
    db = os.path.join(root, "db")
    t0 = time.perf_counter()
    export_text(cat, os.path.join(db, "hla"))
    export_s = time.perf_counter() - t0
    fq = [os.path.join(root, "sample.%d.fq.gz" % k) for k in (1, 2)]
    t0 = time.perf_counter()
    write_fastq(reads_1, fq[0])
    write_fastq(reads_2, fq[1])
    fastq_s = time.perf_counter() - t0
    if read_fastx(fq[0]) != reads_1 or read_fastx(fq[1]) != reads_2:
        raise AssertionError("cli: the FASTQ does not read back as written")
    out = os.path.join(root, "family")
    argv = ["--base", "hla", "--ix-dir", db, "-1", fq[0], "-2", fq[1],
            "--out-dir", out]
    with k1_spies() as calls:
        reset()
        TRACE.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        k1 = dict(calls)
    stages = TRACE.summary()
    if rc != 0:
        raise AssertionError("cli: the family run exited %d" % rc)
    want = os.path.join(root, "family_want.report")
    write_reports([(want, [((), fam_res[g]) for g in cat.genes])],
                  simulation=False)
    got = os.path.join(out, "assembly_graph-hla.sample.report")
    if report_lines(got) != report_lines(want):
        raise AssertionError("cli: the family report differs from the one "
                             "written from type_family's results")
    if k1["router"] != 2 or k1["gene"] <= 0 \
            or launches["placement_scores"] != k1["router"] + k1["gene"] \
            or launches["and_reduce_slab"] <= 0 \
            or launches["banded_dp_bits"] <= 0:
        raise AssertionError("cli: family launches %s, K1 calls %s"
                             % (launches, k1))
    n_reads = len(reads_1) + len(reads_2)
    log("cli: family run `main(-1 -2)`: %d genes, %d pairs; rc 0, report "
        "equals the family phase's line for line; wall %.3f s (cold: "
        "import_text, FASTQ parse, aligners; the family phase's warm run "
        "%.3f s), %.1f reads/s; launches K1 %d (router %d, per gene %d), "
        "K2 %d, bit DP %d; export_text %.2f s, write_fastq %.2f s "
        "(gzip); %s"
        % (len(cat.genes), len(reads_1), wall, fam_wall, n_reads / wall,
           launches["placement_scores"], k1["router"], k1["gene"],
           launches["and_reduce_slab"], launches["banded_dp_bits"],
           export_s, fastq_s, smi))
    top = sorted(((k, v["s"]) for k, v in stages.items() if "." in k),
                 key=lambda kv: -kv[1])[:8]
    log("cli: family run TRACE (s, nested): %s"
        % ", ".join("%s %.4f" % kv for kv in top))

    # ---- the simulation self-test at HLA-A scale ---- #
    sdb = os.path.join(root, "scale_db")
    t0 = time.perf_counter()
    export_text(Catalog(family="hla", genes={"A": big}),
                os.path.join(sdb, "hla"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = import_text("hla", os.path.join(sdb, "hla")).genes["A"]
    import_s = time.perf_counter() - t0
    if back.allele_names != big.allele_names \
            or back.var_ids != big.var_ids \
            or not np.array_equal(back.links, big.links) \
            or back.backbone != big.backbone:
        raise AssertionError("cli: the scale gene does not import as it "
                             "was exported")
    del back
    sout = os.path.join(root, "scale")
    debug = "basic,test_size:5,set_seed:101"
    argv = ["--base", "hla", "--ix-dir", sdb, "--locus-list", "A",
            "--debug", debug, "--out-dir", sout]
    reset()
    TRACE.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    stages = TRACE.summary()
    if rc != 0:
        raise AssertionError("cli: the scale simulation exited %d (a truth "
                             "not ranked first)" % rc)
    if "device.place" not in stages or launches["placement_scores"] <= 0:
        raise AssertionError("cli: no place pass on K1 in the scale "
                             "simulation: %s" % launches)
    if "rescue.fold" not in stages or launches["and_reduce_slab"] <= 0:
        raise AssertionError("cli: K2 never launched in the rescue's fold: "
                             "%s" % launches)
    if have_native() and launches["banded_dp_bits"] <= 0:
        raise AssertionError("cli: the native verifier is built but the "
                             "bit DP never launched: %s" % launches)
    args = cli.build_parser().parse_args(argv)
    opts = cli.typing_options_from_args(args, cli.A.parse_debug(debug))
    n, results = simulation_sweep(
        big, test_size=5, seed=101, paired=True, allele_count=1,
        simulate_interval=args.simulate_interval, read_len=args.read_len,
        fragment_len=args.fragment_len, opts=opts, device=dev)
    want_dir = os.path.join(root, "scale_want")
    os.makedirs(want_dir)
    write_reports([(os.path.join(want_dir, "t%d.report" % t), [row])
                   for t, row in enumerate(results)], simulation=True)
    names = sorted(os.listdir(sout))
    want_names = ["assembly_graph-hla.test-%d.report" % (t + 1)
                  for t in range(5)]
    if [f for f in names if f.endswith(".report")] != want_names or n != 5:
        raise AssertionError("cli: scale reports %s, in-process sweep "
                             "passed %d" % (names, n))
    for t in range(5):
        if report_lines(os.path.join(sout, want_names[t])) != \
                report_lines(os.path.join(want_dir, "t%d.report" % t)):
            raise AssertionError("cli: scale report %d differs from the "
                                 "in-process sweep's" % (t + 1))
    n_sim = sum(r.num_reads for _, r in results)
    log("cli: scale simulation `main(--debug %s)`: A=%d, 5 tests, %d "
        "reads typed; rc 0 (5/5 ranked first), 5 reports equal to an "
        "in-process simulation_sweep's; wall %.3f s (cold), %.1f reads/s; "
        "launches K1 %d, K2 %d, bit DP %d, warp DP %d; import_text at "
        "%d alleles %.3f s (export_text %.2f s); %s"
        % (debug, big.n_alleles, n_sim, wall, n_sim / wall,
           launches["placement_scores"], launches["and_reduce_slab"],
           launches["banded_dp_bits"], launches["banded_dp_warp"],
           big.n_alleles, import_s, export_s, smi))
    top = sorted(((k, v["s"]) for k, v in stages.items() if "." in k),
                 key=lambda kv: -kv[1])[:8]
    log("cli: scale simulation TRACE (s, nested): %s"
        % ", ".join("%s %.4f" % kv for kv in top))

    # ---- the module entries, as a user runs them ---- #
    tdb = os.path.join(root, "toy_db")
    export_text(Catalog(family="hla", genes={"A": toy}),
                os.path.join(tdb, "hla"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = dict(cwd=ROOT, env=env, capture_output=True, text=True,
               timeout=600)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hgtpu_torch", "--base", "hla", "--ix-dir",
         tdb, "--locus-list", "A", "--debug", "basic,test_size:1,set_seed:7",
         "--out-dir", os.path.join(root, "module")], **run)
    module_s = time.perf_counter() - t0
    if proc.returncode != 0 or "Passed so far: 1/1" not in proc.stderr:
        raise AssertionError("cli: python -m hgtpu_torch exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-3000:]))
    csv = os.path.join(root, "calls.csv")
    proc = subprocess.run(
        [sys.executable, "-m", "hgtpu_torch.cli.toolkit", "parse-results",
         "--in-dir", out, "--csv", csv], **run)
    if proc.returncode != 0:
        raise AssertionError("cli: parse-results exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-3000:]))
    with open(csv) as f:
        rows = [line.rstrip("\n").split(",") for line in f][1:]
    got_calls = {r[1]: sorted(r[2:4]) for r in rows
                 if r[0] == "assembly_graph-hla.sample"}
    if got_calls != {g: sorted(t) for g, t in truths.items()}:
        raise AssertionError("cli: parse-results calls %s, truths %s"
                             % (got_calls, truths))
    log("cli: `python -m hgtpu_torch` (toy, test_size:1, on the card by "
        "default) rc 0 in %.1f s of process; `python -m "
        "hgtpu_torch.cli.toolkit parse-results` names every gene's truth "
        "pair (%d genes); %s" % (module_s, len(got_calls), smi))


STR_PAGE = """<html><body><table>
<tr><th>Allele</th><th>Repeat Structure</th></tr>
<tr><td>9</td><td>[AGAA]<sub>9</sub></td></tr>
<tr><td>13</td><td>[AGAA]<sub>13</sub></td></tr>
<tr><td>14.2</td><td>[AGAA]<sub>13</sub> GA [AGAA]<sub>1</sub></td></tr>
<tr><td>16</td><td>[AGAA]<sub>16</sub></td></tr>
</table></body></html>
"""


def genbank_record(acc, gene, seq, exons):
    """A GenBank flat-file record as extract-rbg reads it: a gene
    feature with /gene, an mRNA join, numbered exons, ORIGIN."""
    joins = ["%d..%d" % (left, right) for left, right in exons]
    rows = ["LOCUS       %s             %d bp    DNA" % (acc, len(seq)),
            "FEATURES             Location/Qualifiers",
            "     source          1..%d" % len(seq),
            "     gene            %d..%d" % (11, len(seq) - 10),
            '                     /gene="%s"' % gene,
            "     mRNA            join(%s," % joins[0],
            "                     %s)" % ",".join(joins[1:]),
            '                     /gene="%s"' % gene]
    for i, (left, right) in enumerate(exons):
        rows += ["     exon            %d..%d" % (left, right),
                 '                     /number="%d"' % (i + 1)]
    rows.append("ORIGIN")
    for s in range(0, len(seq), 60):
        chunk = seq[s:s + 60].lower()
        rows.append("%9d %s" % (s + 1, " ".join(
            chunk[k:k + 10] for k in range(0, len(chunk), 10))))
    return "\n".join(rows) + "\n//"


def assembly_phase(big, toy, dev, counts, reset, work, smi):
    """Guided assembly and phasing (--assembly) on the card.  Typing with
    assembly=True takes the host-engine path (K1 placement, the bit DP
    in device verify, K2 in the fold); the assembly itself is host work.

    - the homozygous call at scale (tests/test_hla_scale.py's
      test_assembly_at_scale): truth allele_names[123], interval 4, seed
      1; counts set to 0 just before the run and read just after: K1,
      K2 and the bit DP launched; the truth ranked first and called
      [truth, truth] from 1-2 contigs; call (score within 1e-9) and
      contigs (names, sequences) equal to the port's CPU run; wall and
      TRACE's type.assembly; then one more run under torch.profiler for
      the device's busy share of the wall;
    - the heterozygous call on the toy gene (tests/test_assembly.py's
      alleles 3 and 24, interval 2, distinct read ids): the called pair
      is the truth pair;
    - the command line: `--assembly` simulation on the toy gene's text
      database (test_size:2) on the card and on the CPU: reports equal
      line for line but the argv line, every assembly call named (no
      NONE), the .fasta and .pdf files equal byte for byte, each PDF
      from %PDF to %%EOF;
    - the toolkit's extract-codis-data (--html-dir), convert-codis,
      extract-rbg and compare, once each on inputs written here: rc 0,
      and the databases they write import with their alleles.

    Returns the scale run's launches and (truth, its assembly call)."""
    import shutil
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hgtpu_torch.cli import main as cli
    from hgtpu_torch.cli import toolkit
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import export_text, import_text
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.typer import TypingOptions
    from hgtpu_torch.utils.trace import TRACE

    root = os.path.join(work, "assembly")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    opts = TypingOptions(simulation=True, assembly=True)

    # ---- the homozygous call at scale ---- #
    truth = big.allele_names[123]
    r1, r2, _ = simulate_reads(big, [truth], simulate_interval=4, seed=1)
    reads = ([(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2])
    n_reads = len(r1) + len(r2)
    reset()
    TRACE.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = type_reads(big, *reads, opts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    stages = TRACE.summary()
    check_probs(res, "assembly scale")
    if res.prob[0][0] != truth:
        raise AssertionError("assembly scale: top call %s, truth %s"
                             % (res.prob[0][0], truth))
    if res.assembly_call is None or res.assembly_call[0] != [truth, truth]:
        raise AssertionError("assembly scale: call %s, want [%s, %s]"
                             % (res.assembly_call, truth, truth))
    if not res.contigs or len(res.contigs) > 2:
        raise AssertionError("assembly scale: %d contigs"
                             % len(res.contigs or {}))
    for name in ("placement_scores", "and_reduce_slab", "banded_dp_bits"):
        if launches[name] <= 0:
            raise AssertionError("assembly scale: %s never launched: %s"
                                 % (name, launches))
    scale_call = (truth, res.assembly_call)
    t0 = time.perf_counter()
    ref = type_reads(big, *reads, opts, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_result(res, ref, "assembly scale")
    if ref.assembly_call is None \
            or res.assembly_call[0] != ref.assembly_call[0] \
            or abs(res.assembly_call[1] - ref.assembly_call[1]) >= 1e-9 \
            or list(res.contigs.items()) != list(ref.contigs.items()):
        raise AssertionError("assembly scale: call %s contigs %s, the CPU "
                             "run's %s %s"
                             % (res.assembly_call, list(res.contigs),
                                ref.assembly_call, list(ref.contigs or {})))
    asm_s = stages.get("type.assembly", {}).get("s", 0.0)
    typing = sorted(((k, v["s"]) for k, v in stages.items()
                     if "." in k and k != "type.assembly"),
                    key=lambda kv: -kv[1])[:6]
    log("assembly: scale A=%d, %d reads, truth %s called [%s, %s] (group "
        "score %.5f) from %d contig(s) %s; equal to the CPU run (call, "
        "contig names and sequences; CPU run %.1f s); wall %.3f s, "
        "type.assembly %.3f s (%.1f %%), typing stages %s; launches K1 "
        "%d, K2 %d, bit DP %d, warp DP %d; %s"
        % (big.n_alleles, n_reads, truth, truth, truth,
           10 ** res.assembly_call[1], len(res.contigs), list(res.contigs),
           cpu_s, wall, asm_s, 100 * asm_s / wall,
           ", ".join("%s %.4f" % kv for kv in typing),
           launches["placement_scores"], launches["and_reduce_slab"],
           launches["banded_dp_bits"], launches["banded_dp_warp"], smi))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = type_reads(big, *reads, opts, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    if again.assembly_call != res.assembly_call:
        raise AssertionError("assembly scale: the profiled run called %s"
                             % (again.assembly_call,))
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in kern) / 1e6
    log("assembly: profiled scale run wall %.3f s (profiler on), device "
        "busy %.4f s (%.2f %% of the wall) in %d kernels; %s"
        % (prof_wall, busy, 100 * busy / prof_wall, len(kern), smi))
    del prof, kern, again, ref

    # ---- the heterozygous call on the toy gene ---- #
    a1, a2 = toy.allele_names[3], toy.allele_names[24]
    r1a, r2a, _ = simulate_reads(toy, [a1], simulate_interval=2)
    r1b, r2b, _ = simulate_reads(toy, [a2], simulate_interval=2)
    het_1 = [("%d|L_x" % i, r.seq) for i, r in enumerate(r1a + r1b)]
    het_2 = [("%d|R_x" % i, r.seq) for i, r in enumerate(r2a + r2b)]
    t0 = time.perf_counter()
    het = type_reads(toy, het_1, het_2,
                     TypingOptions(simulation=False, assembly=True),
                     device=dev)
    het_s = time.perf_counter() - t0
    if {a for a, _ in het.prob[:2]} != {a1, a2} \
            or het.assembly_call is None \
            or set(het.assembly_call[0]) != {a1, a2}:
        raise AssertionError("assembly toy: top 2 %s, call %s, want {%s, %s}"
                             % (het.prob[:2], het.assembly_call, a1, a2))
    log("assembly: toy A=%d het pair %s / %s called %s (group score %.5f) "
        "from %d contigs; wall %.3f s"
        % (toy.n_alleles, a1, a2, het.assembly_call[0],
           10 ** het.assembly_call[1], len(het.contigs), het_s))

    # ---- the command line with --assembly, card against CPU ---- #
    db = os.path.join(root, "toy_db")
    export_text(Catalog(family="hla", genes={"A": toy}),
                os.path.join(db, "hla"))
    argv = ["--base", "hla", "--ix-dir", db, "--locus-list", "A",
            "--debug", "basic,test_size:2,set_seed:101", "--assembly"]
    outs = {}
    for side, device in (("card", None), ("cpu", "cpu")):
        out = os.path.join(root, "cli_" + side)
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--out-dir", out], device=device)
        outs[side] = (out, rc, time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError("assembly cli (%s): rc %d" % (side, rc))
    card, cpu = outs["card"][0], outs["cpu"][0]
    names = sorted(os.listdir(card))
    if names != sorted(os.listdir(cpu)):
        raise AssertionError("assembly cli: files %s, CPU %s"
                             % (names, sorted(os.listdir(cpu))))
    kinds = {}
    for name in names:
        kinds.setdefault(name.rsplit(".", 1)[-1], []).append(name)
        a, b = os.path.join(card, name), os.path.join(cpu, name)
        if name.endswith(".report"):
            if report_lines(a) != report_lines(b):
                raise AssertionError("assembly cli: %s differs from the CPU "
                                     "run's" % name)
            with open(a) as f:
                calls = f.read().split("Assembly Coloring Allele "
                                       "Collapse:")[-1]
            if "NONE" in calls or "Group score" not in calls:
                raise AssertionError("assembly cli: %s calls %r"
                                     % (name, calls))
        else:
            with open(a, "rb") as f:
                data = f.read()
            with open(b, "rb") as f:
                if f.read() != data:
                    raise AssertionError("assembly cli: %s differs from the "
                                         "CPU run's, byte for byte" % name)
            if name.endswith(".pdf") and not (
                    data.startswith(b"%PDF") and data.endswith(b"%%EOF\n")):
                raise AssertionError("assembly cli: %s is not a whole PDF"
                                     % name)
    if [len(kinds.get(k, ())) for k in ("report", "fasta", "pdf")] \
            != [2, 2, 2]:
        raise AssertionError("assembly cli: files %s" % names)
    log("assembly: `main(--debug basic,test_size:2 --assembly)` on the "
        "toy database: rc 0 on the card (%.1f s) and on the CPU (%.1f s); "
        "2 reports equal line for line, every call named, 2 .fasta and 2 "
        ".pdf files equal byte for byte"
        % (outs["card"][2], outs["cpu"][2]))

    # ---- the toolkit's last four commands ---- #
    rng = np.random.default_rng(31)
    pages = os.path.join(root, "pages")
    os.makedirs(pages)
    with open(os.path.join(pages, "str_D18S51.htm"), "w") as f:
        f.write(STR_PAGE)
    base = os.path.join(root, "codis")
    flank = ["".join(rng.choice(list("ACGT"), 300)) for _ in range(2)]
    seq = "".join(rng.choice(list("ACGT"), 1200))
    variants = [seq]
    for k in (1, 2):
        s = list(seq)
        for p in rng.choice(np.arange(30, len(seq) - 30), 3 + k,
                            replace=False):
            s[p] = "ACGT"[("ACGT".index(s[p]) + k) % 4]
        variants.append("".join(s))
    gb = os.path.join(root, "gypb.gb")
    with open(gb, "w") as f:
        f.write("\n".join(genbank_record("RB%03d" % k, "GYPB", s,
                                         [(41, 400), (501, 1100)])
                          for k, s in enumerate(variants)) + "\n")
    calls_tsv, truth_tsv = (os.path.join(root, n)
                            for n in ("calls.tsv", "truth.tsv"))
    with open(calls_tsv, "w") as f:
        f.write("s1\tA*01:01:01\t0.6\ns1\tA*02:05\t0.4\n"
                "s2\tA*03:01\t0.9\ns2\tA*11:01\t0.05\n")
    with open(truth_tsv, "w") as f:
        f.write("s1\tA*01:01\ns2\tA*03:01\ns2\tA*11:01\n")
    tk_db = os.path.join(root, "tk_db")
    os.makedirs(tk_db)
    runs = [["extract-codis-data", "--html-dir", pages, "--locus-list",
             "D18S51", "--base", base],
            ["convert-codis", "--base", "codis", "--ix-dir", tk_db, "--dat",
             base + ".dat", "--flank5", flank[0], "--flank3", flank[1]],
            ["extract-rbg", "--base", "rbg", "--ix-dir", tk_db,
             "--genbank", gb],
            ["compare", calls_tsv, truth_tsv, "--genes", "A"]]
    for argv in runs:
        rc = toolkit.main(argv)
        if rc != 0:
            raise AssertionError("toolkit %s: rc %d" % (argv[0], rc))
    codis = import_text("codis", os.path.join(tk_db, "codis"))
    rbg = import_text("rbg", os.path.join(tk_db, "rbg"))
    if codis.genes["D18S51"].n_alleles != 4 \
            or rbg.genes["GYPB"].n_alleles != 3:
        raise AssertionError("toolkit: codis %s, rbg %s alleles"
                             % (codis.genes["D18S51"].n_alleles,
                                rbg.genes["GYPB"].n_alleles))
    log("assembly: toolkit extract-codis-data (--html-dir), convert-codis, "
        "extract-rbg and compare rc 0 (python %s, jax imported: %s); "
        "D18S51 4 alleles, GYPB 3 alleles import"
        % (sys.version.split()[0], sys.modules.get("jax") is not None))
    return launches, scale_call


def golden_phase(work, smi):
    """hgtpu's golden command-line runs on the card: golden.main with
    --device-typing auto, each of hg_test1-5 a `python -m hgtpu_torch`
    child on the card.  Every marker check passes, every report and
    hg_test3's .fasta equal devel/expected/ after normalize, and the path
    is checked per run (the production path for hg_test1 and 2; the host
    engine for the assembly and real-read runs).  Each child prints its
    own launches (HGTPU_TORCH_RUN_STATS; a fresh process counts from 0):
    K1 in every run, K2 wherever the run folded on the device
    (rescue.fold on the production path, every host-engine run), the
    bit DP wherever device verify ran, the warp DP never.  Returns the
    launches summed over the five runs."""
    from hgtpu_torch.devel import golden
    from hgtpu_torch.ops import launch_counts

    root = os.path.join(work, "golden")
    stats = {}
    t0 = time.perf_counter()
    rc = golden.main(["--device-typing", "auto",
                      "--db", os.path.join(root, "testdb"),
                      "--out-dir", os.path.join(root, "out")], stats=stats)
    wall = time.perf_counter() - t0
    if rc != 0 or sorted(stats) != sorted(golden.CONFIGS):
        raise AssertionError("golden: rc %d, runs %s" % (rc, sorted(stats)))
    total = dict.fromkeys(launch_counts(), 0)
    for name in golden.CONFIGS:
        st = stats[name]
        want = "production" if name in golden.PRODUCTION else "host engine"
        if st["path"] != want:
            raise AssertionError("golden %s took the %s, want the %s"
                                 % (name, st["path"], want))
        n = st["launches"]
        stages = st["stages"]
        need = ["placement_scores"]
        if want == "host engine" or "rescue.fold" in stages:
            need.append("and_reduce_slab")
        if "verify.device_dp" in stages:
            need.append("banded_dp_bits")
        if want == "host engine" and "verify.device_dp" not in stages:
            raise AssertionError("golden %s: device verify did not run on "
                                 "the host engine" % name)
        if any(n[k] <= 0 for k in need) or n["banded_dp_warp"]:
            raise AssertionError("golden %s: launches %s (need %s)"
                                 % (name, n, need))
        for k in total:
            total[k] += n[k]
        log("golden: %s on the card: %s, wall %.3f s (a fresh process: "
            "imports, the card, the kernels' load), launches K1 %d, K2 %d, "
            "bit DP %d, warp DP %d; %s"
            % (name, st["path"], st["wall"], n["placement_scores"],
               n["and_reduce_slab"], n["banded_dp_bits"],
               n["banded_dp_warp"], smi))
    log("golden: hg_test1-5 equal devel/expected/ (every report and "
        "hg_test3's .fasta, normalized), every marker check passed; phase "
        "wall %.1f s; launches over the five runs %s" % (wall, total))
    return total


def campaign_phase(big, dev, counts, reset, asm_scale_call, smi):
    """hgtpu's regression campaign (hgtpu_torch.devel.campaign), in full,
    on device="cuda" with its default options ("auto": the production
    path for every sweep and hla-scale, the host engine for CODIS and the
    family).  Every configuration passes the campaign's rule, and every
    typing result equals the same run on the CPU host-fold run
    (device_typing and device_counting off): under the production
    contract (same_production) on the production path, field for field
    (same_result) on the host engine.  hla-scale reuses the scale panel; its
    assembly half is the assembly phase's scale run (the same allele,
    interval and seed), cited, not typed again.  Counts set to 0 just
    before the phase and read just after (the CPU runs launch nothing).
    Returns them."""
    import torch
    from hgtpu_torch.devel import campaign
    from hgtpu_torch.utils.trace import TRACE

    cpu = dict(device="cpu", device_typing="off", device_counting="off")
    passed = total = 0
    card_s = cpu_s = 0.0

    def both(name, fn, path, **kw):
        nonlocal card_s, cpu_s
        TRACE.reset()
        t0 = time.perf_counter()
        got = fn(device=dev, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        took = "production" if "device.encode" in TRACE.summary() \
            else "host engine"
        t0 = time.perf_counter()
        want = fn(**dict(kw, **cpu))
        dt_cpu = time.perf_counter() - t0
        card_s += dt
        cpu_s += dt_cpu
        if took != path:
            raise AssertionError("campaign %s took the %s, want the %s"
                                 % (name, took, path))
        results, ref = got[-1], want[-1]
        if [t for t, _ in results] != [t for t, _ in ref]:
            raise AssertionError("campaign %s: truths differ from the CPU "
                                 "run" % name)
        err = 0.0
        for (t, a), (_, b) in zip(results, ref):
            what = "campaign %s %s" % (name, t)
            if took == "production":
                err = max(err, same_production(a, b, what))
            else:
                same_result(a, b, what)
        log("campaign: %-16s %s, %s; equal to the CPU host-fold run (prob "
            "max diff %.3g); card %.3f s, CPU %.3f s"
            % (name, "%d/%d" % got[:2], took, err, dt, dt_cpu))
        return got

    reset()
    t0 = time.perf_counter()
    for name, msa_kw, build_kw, sweep_kw in campaign.configs(False):
        ref = campaign.build_gene(msa_kw, build_kw)
        n, want, ok, _ = both(name, campaign.sweep_config, "production",
                              msa_kw=msa_kw, build_kw=build_kw,
                              sweep_kw=sweep_kw, ref=ref)
        if not ok:
            raise AssertionError("campaign %s: %d/%d FAIL" % (name, n, want))
        passed += n
        total += want
    for name, fn, path in (("codis-str", campaign.codis_config,
                            "host engine"),
                           ("family-2gene", campaign.family_config,
                            "host engine")):
        n, want, _ = both(name, fn, path)
        if n != want:
            raise AssertionError("campaign %s: %d/%d FAIL" % (name, n, want))
        passed += n
        total += want
    n, want, _ = both("hla-scale-3600", campaign.hla_scale_config,
                      "production", ref=big, assembly=False)
    if n != want:
        raise AssertionError("campaign hla-scale-3600: %d/%d FAIL"
                             % (n, want))
    truth, call = asm_scale_call
    if call is None or call[0] != [truth, truth]:
        raise AssertionError("campaign hla-scale-3600: the assembly phase's "
                             "scale run called %s" % (call,))
    passed += n + 1
    total += want + 1
    wall = time.perf_counter() - t0
    launches = counts()
    for name in ("placement_scores", "and_reduce_slab", "banded_dp_bits"):
        if launches[name] <= 0:
            raise AssertionError("campaign: %s never launched: %s"
                                 % (name, launches))
    if launches["banded_dp_warp"]:
        raise AssertionError("campaign: the warp DP kernel launched")
    log("campaign: hla-scale-3600's assembly half is the assembly phase's "
        "scale run (allele_names[123], interval 4, seed 1): %s called "
        "[%s, %s]" % (truth, truth, truth))
    log("campaign: %d/%d passed on the card, every result equal to the CPU "
        "host-fold run; phase wall %.1f s (card runs %.1f s, CPU runs %.1f "
        "s); launches %s; %s" % (passed, total, wall, card_s, cpu_s,
                                 launches, smi))
    return launches


def scaling_phase(counts, reset, smi):
    """hgtpu's shard sweep (hgtpu_torch.devel.scaling.main) at 1, 2 and 4
    shards, every shard on cuda:0: sharded_place (K1) and sharded_count
    (K2 in _compat, the psum-reduced totals), each mesh's outputs equal
    to one shard's on the same inputs.  One card, so the sweep shows the
    per-shard overhead, not scaling.  Counts set to 0 just before, read
    just after; returns them."""
    from hgtpu_torch.devel import scaling

    reset()
    t0 = time.perf_counter()
    out = scaling.main(["--max-shards", "4", "--device", "cuda:0"])
    wall = time.perf_counter() - t0
    launches = counts()
    if sorted(out["results"]) != [1, 2, 4]:
        raise AssertionError("scaling: shard counts %s"
                             % sorted(out["results"]))
    for name in ("placement_scores", "and_reduce_slab"):
        if launches[name] <= 0:
            raise AssertionError("scaling: %s never launched: %s"
                                 % (name, launches))
    log("scaling: 1, 2 and 4 shards on cuda:0 equal to one shard (scores, "
        "positions, masks, totals, prob); phase wall %.1f s; launches %s; "
        "%s" % (wall, launches, smi))
    return launches


def punts_phase(dev, smi):
    """The punt probe (hgtpu_torch.devel.punts, the twin of
    measure_punts.py) on the scale panel at one shard of the card: punt,
    excl, causes, tier-1 mates and the punted reads' anatomy equal to one
    CPU shard's."""
    from hgtpu_torch.devel import punts
    from hgtpu_torch.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    pref, p1, p2 = punts.build("scale")
    got = punts.punt_stats(pref, p1, p2, make_mesh(1, dev))
    want = punts.punt_stats(pref, p1, p2, make_mesh(1, "cpu"))
    keys = ("pairs", "punt", "excl", "causes", "tier1", "anatomy")
    if any(got[k] != want[k] for k in keys):
        raise AssertionError("punts: on the card %s, on the CPU %s"
                             % ({k: got[k] for k in keys},
                                {k: want[k] for k in keys}))
    punts.report("scale", pref, got, dev)
    log("punts: equal to one CPU shard's (card count_classes %.3f s, CPU "
        "%.3f s); phase wall %.1f s; %s" % (got["wall"], want["wall"],
                                            time.perf_counter() - t0, smi))


def edges_bam_runs(big, b1, b2, work):
    """The scale cell's pairs as a BAM the port writes (write_bam; mate 2
    on the reverse strand, as an aligner stores it) and as FASTQ, the
    scale gene placed on chr6 in a text database; `python -m hgtpu_torch
    --bamfile` and `-1 -2` on them, both on the card, started together
    as subprocesses.  Returns (Popens, their output directories)."""
    import dataclasses

    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import export_text
    from hgtpu_torch.utils.bam import write_bam
    from hgtpu_torch.utils.dna import revcomp
    from hgtpu_torch.utils.io import write_fastq

    root = os.path.join(work, "edges")
    os.makedirs(root, exist_ok=True)
    placed = dataclasses.replace(big, chrom="chr6", chrom_left=20000,
                                 chrom_right=20000 + len(big.backbone) - 1)
    export_text(Catalog(family="hla", genes={"A": placed}),
                os.path.join(root, "db", "hla"))
    recs = []
    span = len(big.backbone) - 250
    for k, ((_, a), (_, b)) in enumerate(zip(b1, b2)):
        pos = placed.chrom_left + (k * 3) % span
        recs.append({"name": "rd%d" % k, "flag": 0x1 | 0x40,
                     "rname": "chr6", "pos": pos, "cigar": [("M", len(a))],
                     "seq": a, "qual": "I" * len(a),
                     "tags": {"NH": ("i", 1)}})
        recs.append({"name": "rd%d" % k, "flag": 0x1 | 0x80 | 0x10,
                     "rname": "chr6", "pos": pos + 150,
                     "cigar": [("M", len(b))], "seq": revcomp(b),
                     "qual": "I" * len(b), "tags": {"NH": ("i", 1)}})
    os.makedirs(os.path.join(root, "bam"), exist_ok=True)
    os.makedirs(os.path.join(root, "fq"), exist_ok=True)
    bam = os.path.join(root, "bam", "scale.bam")
    write_bam(bam, [("chr6", placed.chrom_right + 1000)], recs)
    fq = [os.path.join(root, "fq", "scale.%d.fq" % i) for i in (1, 2)]
    write_fastq([("rd%d" % k, a) for k, (_, a) in enumerate(b1)], fq[0])
    write_fastq([("rd%d" % k, b) for k, (_, b) in enumerate(b2)], fq[1])
    env = {k: v for k, v in os.environ.items() if k != "HGTPU_TORCH_DEVICE"}
    db = ["--base", "hla", "--ix-dir", os.path.join(root, "db")]
    outs = [os.path.join(root, "out_bam"), os.path.join(root, "out_fq")]
    procs = []
    for argv, out in ((["--bamfile", bam], outs[0]),
                      (["-1", fq[0], "-2", fq[1]], outs[1])):
        log_f = open(out + ".log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "hgtpu_torch"] + db + argv
            + ["--out-dir", out], cwd=ROOT, env=env, stdout=log_f,
            stderr=subprocess.STDOUT), log_f))
    return procs, outs, len(recs), os.path.getsize(bam)


def edges_degenerate(dev):
    """K1, K2 (slab and wide) and the bit DP launched straight at the
    degenerate shapes of hgtpu_torch.devel.edges, each held against its
    plain version on the same card tensors; an empty shape launches (and
    counts) nothing, any other launches once."""
    import numpy as np
    import torch

    from hgtpu_torch.devel import edges
    from hgtpu_torch.ops.banded_dp import (BandedDPTables, banded_costs_bits,
                                           banded_costs_plain)
    from hgtpu_torch.ops.compat_kernel import (and_reduce_plain,
                                               and_reduce_slab,
                                               and_reduce_wide, k2_plan)
    from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                                  placement_scores_plain)

    def launched(fn, call, want_one, what):
        before = fn.launches
        out = call()
        torch.cuda.synchronize()
        if fn.launches - before != int(bool(want_one)):
            raise AssertionError("edges: %s launched %d times, want %d"
                                 % (what, fn.launches - before,
                                    int(bool(want_one))))
        return out

    for n, m, P1 in edges.K1_SHAPES:
        pwm, reads = (torch.from_numpy(x).to(dev)
                      for x in edges.k1_operands(n, m, P1, seed=n + m + P1))
        what = "K1 at N=%d m=%d P1=%d" % (n, m, P1)
        got = launched(placement_scores,
                       lambda: placement_scores(pwm, reads), n and m and P1,
                       what)
        want = placement_scores_plain(pwm, reads)
        if got.shape != (n, P1) or not torch.equal(got, want):
            raise AssertionError("edges: %s differs from the plain "
                                 "version" % what)
    for V1, W, H, K in edges.K2_SHAPES:
        links, vars_ = (torch.from_numpy(x).to(dev) for x in
                        edges.k2_operands(V1, W, H, K, seed=V1 + W + H + K))
        want = and_reduce_plain(links, vars_)
        ws = k2_plan(V1, W)[1]
        for fn, call in (
                (and_reduce_slab, lambda: and_reduce_slab(links, vars_, ws)),
                (and_reduce_wide, lambda: and_reduce_wide(links, vars_))):
            what = "K2 %s at V+1=%d W=%d H=%d K=%d" % (
                fn.__name__, V1, W, H, K)
            got = launched(fn, call, H and W, what)
            if tuple(got.shape) != (H, W) or not torch.equal(got, want):
                raise AssertionError("edges: %s differs from the plain "
                                     "version" % what)
    specs = edges.specs()
    tables = {}
    for name, E, W, budget in edges.DP_SHAPES:
        if name not in tables:
            tables[name] = BandedDPTables(edges.build(specs[name]), dev)
        tab = tables[name]
        gene = tab.gene
        reads, lens, starts = (torch.from_numpy(np.ascontiguousarray(x))
                               .to(dev) for x in
                               edges.dp_operands(gene, E, W, seed=E + W))
        what = "the bit DP at %s E=%d W=%d budget %d" % (name, E, W, budget)
        cost, over = launched(
            banded_costs_bits,
            lambda: banded_costs_bits(tab.table, tab.planes, reads, lens,
                                      starts, tab.P, budget, tab.del_lens,
                                      tab.ins_lens), E, what)
        want_c, want_o = banded_costs_plain(tab.table, reads, lens, starts,
                                            tab.P, budget, tab.del_lens,
                                            tab.ins_lens)
        if not (torch.equal(cost, want_c) and torch.equal(over, want_o)):
            raise AssertionError("edges: %s differs from the plain version"
                                 % what)


def edges_phase(big, b1, b2, dev, counts, reset, work, smi):
    """hgtpu_torch.devel.edges' genes and cases on the card: each typed
    through type_reads ("auto": the production path where the options
    allow it, one shard) with the launches counted (set to 0 just before
    each case, read just after), held exactly against the port's
    one-shard CPU production run (the host engine where the options route
    there) and under the host contract against its CPU host engine (the
    two-indel gene's recombinant pair parts hgtpu's own paths: that
    difference is held as it is); the kernels at degenerate shapes; the
    scale cell through a BAM the port wrote."""
    import dataclasses

    import torch

    from hgtpu_torch.devel import edges
    from hgtpu_torch.parallel.production import (device_typing_supported,
                                                 type_reads_device)
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.typer import TypingOptions

    t_phase = time.perf_counter()
    procs, outs, n_recs, bam_bytes = edges_bam_runs(big, b1, b2, work)
    log("edges: the scale cell's %d pairs as a BAM written by the port "
        "(%d records, %d bytes) and as FASTQ; `python -m hgtpu_torch "
        "--bamfile` and `-1 -2` started on the card" % (len(b1), n_recs,
                                                         bam_bytes))
    specs = edges.specs()
    genes = {}
    total = None
    reached = {}
    for name, gene_name, reads, opts in edges.CASES:
        if gene_name not in genes:
            genes[gene_name] = edges.build(specs[gene_name])
        gene = genes[gene_name]
        R1, R2 = edges.case_reads(simulate_reads, gene, reads)
        panel = edges.panel(gene, reads)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = type_reads(panel, R1, R2, TypingOptions(simulation=True,
                                                      **opts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        for k, v in launches.items():
            if v:
                reached.setdefault(k, []).append(name)
        on = TypingOptions(simulation=True, device_typing="on", **opts)
        production = device_typing_supported(on, True)
        cpu = (type_reads_device(panel, R1, R2, on, device="cpu")
               if production else
               type_reads(panel, R1, R2, TypingOptions(simulation=True,
                                                       **opts),
                          device="cpu"))
        if dataclasses.asdict(got) != dataclasses.asdict(cpu):
            raise AssertionError("edges %s: the card's result differs from "
                                 "the CPU's" % name)
        same_result(got, cpu, "edges %s" % name)
        host = type_reads(panel, R1, R2, TypingOptions(
            simulation=True, device_typing="off", **opts), device="cpu")
        if name == "two-indels":
            diff = {k: host.cmpt.get(k, 0) - got.cmpt.get(k, 0)
                    for k in set(host.cmpt) | set(got.cmpt)
                    if host.cmpt.get(k, 0) != got.cmpt.get(k, 0)}
            if diff != {"X*A": -1, "X*A-X*C": 1}:
                raise AssertionError("edges two-indels: production and "
                                     "host engine part by %s" % diff)
        elif not edges.host_contract(got, host):
            raise AssertionError("edges %s: the card's result leaves the "
                                 "host contract" % name)
        log("edges: %s A=%d V=%d P=%d, %d pairs, %s path, top %s; equals "
            "the CPU %s run exactly and the host engine under the contract"
            "%s; launches %s; wall %.3f s"
            % (name, panel.n_alleles, panel.n_vars, len(panel.backbone),
               len(R1), "production" if production else "host-engine",
               [(a, round(p, 4)) for a, p in got.prob[:2]],
               "one-shard production" if production else "host-engine",
               " (but the recombinant pair, as in hgtpu)"
               if name == "two-indels" else "",
               {k: v for k, v in launches.items() if v}, wall))
    for k in ("placement_scores", "and_reduce_slab", "banded_dp_bits"):
        if not total[k]:
            raise AssertionError("edges: %s never launched over the edge "
                                 "genes: %s" % (k, total))
    log("edges: launches over the cases %s; reached by %s" % (total,
                                                               reached))
    edges_degenerate(dev)
    log("edges: K1 (%d shapes), K2 slab and wide (%d each) and the bit DP "
        "(%d) at the degenerate shapes equal their plain versions; the "
        "empty ones launched nothing" % (len(edges.K1_SHAPES),
                                         len(edges.K2_SHAPES),
                                         len(edges.DP_SHAPES)))
    t0 = time.perf_counter()
    for p, log_f in procs:
        rc = p.wait(timeout=600)
        log_f.close()
        if rc != 0:
            raise AssertionError("edges: a `python -m hgtpu_torch` run "
                                 "exited %d (%s)" % (rc, log_f.name))
    waited = time.perf_counter() - t0
    reports = []
    for out in outs:
        names = [f for f in os.listdir(out) if f.endswith(".report")]
        if len(names) != 1:
            raise AssertionError("edges: %s holds %s" % (out, names))
        reports.append(report_lines(os.path.join(out, names[0])))
    if reports[0] != reports[1] \
            or not any("1 ranked" in x for x in reports[0]):
        raise AssertionError("edges: the BAM run's report differs from the "
                             "FASTQ run's")
    log("edges: the BAM run's report equals the FASTQ run's line for line "
        "(but the argv line; %d lines; waited %.1f s for them after the "
        "cases); phase wall %.1f s; %s"
        % (len(reports[0]), waited, time.perf_counter() - t_phase, smi))
    return total


def linear_sam_phase(cat, truths, per_gene, dev, sam_path, n_pairs=1000):
    """type_reads_linear on gene A (n_pairs of its truth pairs) and
    type_from_sam of gene A's family SAM, on `dev`, each equal to the
    CPU run."""
    import dataclasses
    from hgtpu_torch.pipeline import type_from_sam, type_reads_linear
    from hgtpu_torch.typer import TypingOptions

    gene = cat.genes["A"]
    r1, r2 = (r[:n_pairs] for r in per_gene["A"])
    opts = TypingOptions(linear_typing=True)
    got = type_reads_linear(gene, r1, r2, opts, device=dev)
    want = type_reads_linear(gene, r1, r2, opts, device="cpu")
    if dataclasses.asdict(got) != dataclasses.asdict(want):
        raise AssertionError("linear: type_reads_linear on the card differs "
                             "from the CPU run")
    check_probs(got, "linear")
    opts = TypingOptions(simulation=True)
    got_s = type_from_sam(gene, sam_path, opts, device=dev)
    want_s = type_from_sam(gene, sam_path, opts, device="cpu")
    same_result(got_s, want_s, "sam")
    check_truths(got_s, truths["A"], "sam")
    rank = [a for a, _ in got.prob]
    log("linear: type_reads_linear on gene A, %d pairs: %d classes, top %s, "
        "truths at ranks %s, equal to the CPU run; sam: type_from_sam of "
        "gene A's family SAM (%d reads): equal to the CPU run, truths on top"
        % (len(r1), len(got.cmpt), got.prob[0][0],
           [rank.index(t) if t in rank else None for t in truths["A"]],
           got_s.num_reads))


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
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(json.loads(sys.argv[2]))
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

    # ---- 2. build: the native verifier and the kernels side by side ---- #
    make = subprocess.Popen(["make", "-C", os.path.join(ROOT, "native")],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    from hgtpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    build_s = time.perf_counter() - t0
    cuda_lib.load()
    log("build: native verifier make rc=%d" % make.wait())
    log("build: kernels %s in %.1f s (one nvcc per source, in parallel)"
        % (os.path.basename(lib_path), build_s))
    with open(lib_path + ".log") as f:
        for line in f:
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill", "wgmma")):
                log("  ptxas: " + line.strip())

    from hgtpu_torch.utils.trace import TRACE
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.ops import banded_dp as tdp
    from hgtpu_torch.ops import placement as tplace
    from hgtpu_torch.ops.banded_dp import (banded_costs, banded_costs_bits,
                                           banded_costs_warp)
    from hgtpu_torch.ops.compat_kernel import (and_reduce, and_reduce_plain,
                                               and_reduce_slab,
                                               and_reduce_wide, k2_plan)
    from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                                  placement_scores_plain)
    from hgtpu_torch.ops.proposal_bound import proposal_bound
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
    kernels = []        # one record per kernel and timed shape
    off_path = []       # K2's wide variant: no table of the path takes it

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
    lib = k1_library(ext_d, reads_d)
    lib_err1 = float((lib() - got).abs().max())
    k1_lib_ms = cuda_ms(lib)
    n1, P1 = got.shape
    log("K1: placement_scores N=%d m=%d P1=%d exact (max abs err %g); "
        "kernel %.4f ms (%.1f TFLOP/s, output %.0f GB/s), plain %.4f ms, "
        "library torch.mm %.4f ms (max abs err vs kernel %g); "
        "place_scan_batch buffers exact"
        % (n1, m, P1, err1, k1_ms, 2 * n1 * 5 * m * P1 / k1_ms / 1e9,
           n1 * P1 * 4 / k1_ms / 1e6, k1_plain_ms, k1_lib_ms, lib_err1))
    del got, want, lib
    # the production place pass's shape: the scale typer's pwm_ext (the
    # PWM plus read_len zero rows), one mate batch as count_classes pads
    # it (6,511 pairs -> 7,168 rows), m = 100 (the wrapper pads to 112)
    st_big = production._shared_sharded_typer(
        big, prod_opts, production.default_mesh(dev), 100)
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
    lib = k1_library(pwm_p, reads_p)
    lib_errp = float((lib() - got).abs().max())
    kp_lib_ms = cuda_ms(lib)
    np_, P1p = got.shape
    log("K1: place pass shape N=%d m=%d P1=%d exact (max abs err %g); "
        "kernel %.4f ms (%.1f TFLOP/s), plain %.4f ms, library torch.mm "
        "%.4f ms (max abs err vs kernel %g)"
        % (np_, reads_p.shape[1], P1p, err_p, kp_ms,
           2 * np_ * 5 * 112 * P1p / kp_ms / 1e9, kp_plain_ms, kp_lib_ms,
           lib_errp))
    del got, want, lib
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
    seen_dp = {}        # (E, W, P) -> (args, planes, runs)
    gemms = []
    run_name = [None]

    def dp_spy(self, reads, lens, starts, max_novel=2):
        # BandedDPTables.costs' operands as it hands them to banded_costs
        key = tuple(reads.shape) + (self.P,)
        if key not in seen_dp:
            seen_dp[key] = ((self.table,) + tuple(
                torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)
                for x, dt in ((reads, np.int8), (lens, np.int32),
                              (starts, np.int32)))
                + (self.P, max_novel, self.del_lens, self.ins_lens),
                self.planes, set())
        seen_dp[key][2].add(run_name[0])
        return real_costs(self, reads, lens, starts, max_novel)

    def recorder(name, real):
        # K2's table is kept as the path holds it (a row-padded view, the
        # DeviceCounter's own, never written); the rest is copied
        def spy(a, b):
            key = (name,) + tuple(b.shape) + tuple(a.shape)
            seen[name].setdefault(key, (a if name == "and_reduce"
                                        else a.clone(), b.clone(), set()))[2] \
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
    real_costs = tdp.BandedDPTables.costs
    tdp.BandedDPTables.costs = dp_spy
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
        tdp.BandedDPTables.costs = real_costs

    def runs_of(name, run):
        return [k for k, v in seen[name].items() if run in v[2]]

    for name in seen:
        for run in ("scale", "toy", "prod-toy", "prod-scale"):
            if not runs_of(name, run) and (
                    name == "placement_scores" or run in ("scale", "toy")
                    or (run == "prod-scale" and warm_fold)):
                raise AssertionError("the %s warm-up run never called %s"
                                     % (run, name))
    for run in ("scale", "toy", "prod-scale"):
        if not any(run in v[2] for v in seen_dp.values()):
            raise AssertionError("the %s warm-up run never called the "
                                 "banded DP" % run)

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
    # one record per timed shape: the host path's and the place pass's
    for (n_, m_, P1_, rows_), ms_, plain_, lib_ms_, lib_err_, where in (
            ((n1, m, P1, ext_d.shape[0]), k1_ms, k1_plain_ms, k1_lib_ms,
             lib_err1, "host path"),
            ((np_, reads_p.shape[1], P1p, pwm_p.shape[0]), kp_ms,
             kp_plain_ms, kp_lib_ms, lib_errp, "place pass")):
        b_ms, b_by = bound_ms(n_ * m_ + rows_ * 5 * 4 + n_ * P1_ * 4,
                              2 * n_ * 5 * m_ * P1_, PEAK_BF16_S)
        kernels.append(dict(
            name="placement_scores", route="cuda",
            source="hgtpu_torch/csrc/placement_scores.cu",
            replaces="hgtpu/ops/placement_pallas.py:48",
            max_abs_err=max(err1, err_p, err_seen), ms=ms_,
            plain_ms=plain_, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms_,
            library="torch.mm(onehot bf16 [N, 5m], windows bf16 [5m, P1], "
                    "out_dtype=float32); max abs err vs the kernel %g"
                    % lib_err_,
            shape="N=%d m=%d P1=%d (%s)" % (n_, m_, P1_, where),
            shapes_checked=len(seen["placement_scores"])))

    # ---- 4. K2: every (H, K) the folds gave it, both variants, bitwise;
    # then a table past the slab limit, which takes the wide variant ---- #
    for key, (links_s, vars_s, runs) in sorted(seen["and_reduce"].items()):
        kind, ws = k2_plan(*links_s.shape)
        if kind != "slab":
            raise AssertionError("K2: the path's table V+1=%d W=%d does not "
                                 "take the slab kernel" % links_s.shape)
        want = and_reduce_plain(links_s, vars_s)
        for name, fn in (("slab", lambda: and_reduce_slab(links_s, vars_s,
                                                          ws)),
                         ("wide", lambda: and_reduce_wide(links_s, vars_s))):
            if not torch.equal(fn(), want):
                raise AssertionError("K2 %s kernel != plain at H=%d K=%d "
                                     "W=%d (%s)" % ((name,) + key[1:3]
                                                    + (key[4], sorted(runs))))
        log("K2: H=%d K=%d W=%d V+1=%d (runs %s): slab (WS=%d) and wide "
            "kernels bitwise equal" % (key[1], key[2], key[4], key[3],
                                       ",".join(sorted(runs)), ws))
    rng = np.random.default_rng(4)
    V1w = 14000
    links_w = torch.from_numpy(rng.integers(
        0, 2**32, (V1w, 113), dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(dev)
    vars_w = torch.from_numpy(rng.integers(
        -V1w - 4, V1w + 4, (8192, 16)).astype(np.int32)).to(dev)
    before = and_reduce_slab.launches, and_reduce_wide.launches
    got = and_reduce(links_w, vars_w)
    if k2_plan(V1w, 113) != ("wide", None) \
            or (and_reduce_slab.launches, and_reduce_wide.launches) \
            != (before[0], before[1] + 1) \
            or not torch.equal(got, and_reduce_plain(links_w, vars_w)):
        raise AssertionError("K2: a table of V+1=%d rows did not go "
                             "bitwise through the wide kernel" % V1w)
    log("K2: synthetic table V+1=%d W=113 H=8192 K=16 (indices out of "
        "range on both sides): the wide kernel, bitwise equal" % V1w)

    def k2_records(links_s, vars_s, where):
        """The slab kernel, the wide (L2) kernel and the plain
        version timed in turns: plain, slab, wide, slab, wide, plain;
        each ms is the mean of its two turns."""
        V1, W = links_s.shape
        H, K = vars_s.shape
        ws = k2_plan(V1, W)[1]
        fns = {"plain": lambda: and_reduce_plain(links_s, vars_s),
               "slab": lambda: and_reduce_slab(links_s, vars_s, ws),
               "wide": lambda: and_reduce_wide(links_s, vars_s)}
        turns = {k: [] for k in fns}
        for k in ("plain", "slab", "wide", "slab", "wide", "plain"):
            turns[k].append(cuda_ms(fns[k]))
        ms = {k: sum(v) / len(v) for k, v in turns.items()}
        # K = 0: the slab staged, the tiles walked, all-ones rows stored
        stage_ms = cuda_ms(lambda: and_reduce_slab(links_s, vars_s[:, :0],
                                                   ws))
        b_ms, b_by = bound_ms(4 * (V1 * W + H * K + H * W), H * K * W,
                              PEAK_F32_S)
        gather = H * K * W * 4
        log("K2: %s H=%d K=%d W=%d V+1=%d: slab (WS=%d) %.4f ms (%.1f TB/s "
            "of gathered rows; %.4f ms of it with K = 0), wide %.4f ms (%.1f "
            "TB/s), plain %.4f ms; bound %.4f ms (%s), slab at %.1f %% of "
            "it; turns %s"
            % (where, H, K, W, V1, ws, ms["slab"], gather / ms["slab"] / 1e9,
               stage_ms, ms["wide"], gather / ms["wide"] / 1e9, ms["plain"],
               b_ms, b_by, 100 * b_ms / ms["slab"],
               {k: [round(x, 4) for x in v] for k, v in turns.items()}))
        common = dict(route="cuda", source="hgtpu_torch/csrc/and_reduce.cu",
                      replaces="hgtpu/ops/compat_kernel.py:36",
                      max_abs_err=0.0, plain_ms=ms["plain"], bound_ms=b_ms,
                      bound_by=b_by, library_ms=None,
                      library="none: torch has no bitwise-AND reduction",
                      shape="H=%d K=%d W=%d V+1=%d (%s)" % (H, K, W, V1,
                                                            where),
                      shapes_checked=len(seen["and_reduce"]))
        return (dict(common, name="and_reduce_slab", ms=ms["slab"], ws=ws,
                     wide_ms=ms["wide"], k0_ms=stage_ms,
                     turns_ms=turns["slab"]),
                dict(common, name="and_reduce_wide", ms=ms["wide"],
                     turns_ms=turns["wide"]))

    # the largest H x K of the warm-ups, and the production rescue's fold
    k2_large = max(seen["and_reduce"], key=lambda k: k[1] * k[2])
    k2_rescue = max((k for k, v in seen["and_reduce"].items()
                     if "prod-scale" in v[2]), key=lambda k: k[1] * k[2],
                    default=None)
    for key, where in ((k2_large, "largest"), (k2_rescue, "prod rescue")):
        if key is None or (where != "largest" and key == k2_large):
            continue
        slab_rec, wide_rec = k2_records(*seen["and_reduce"][key][:2], where)
        kernels.append(slab_rec)
        off_path.append(wide_rec)
    t_w = cuda_ms(lambda: and_reduce_wide(links_w, vars_w))
    t_wp = cuda_ms(lambda: and_reduce_plain(links_w, vars_w))
    b_ms, b_by = bound_ms(4 * (V1w * 113 + 8192 * 16 + 8192 * 113),
                          8192 * 16 * 113, PEAK_F32_S)
    off_path.append(dict(off_path[-1], ms=t_w, plain_ms=t_wp, bound_ms=b_ms,
                         bound_by=b_by, turns_ms=[t_w],
                         shape="H=8192 K=16 W=113 V+1=%d (synthetic)" % V1w))
    log("K2: wide kernel at the synthetic table %.4f ms, plain %.4f ms"
        % (t_w, t_wp))
    del seen, links_w, vars_w, got

    # ---- the banded DP (device verify) ---- #
    dp_bits, dp_warp = dp_phase(seen_dp, cuda_ms)
    kernels.extend(dp_bits)
    off_path.extend(dp_warp)
    del seen_dp

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
                "and_reduce_slab": and_reduce_slab.launches,
                "and_reduce_wide": and_reduce_wide.launches,
                "banded_dp_bits": banded_costs_bits.launches,
                "banded_dp_warp": banded_costs_warp.launches,
                "proposal_bound": proposal_bound.launches}

    def reset():
        placement_scores.launches = 0
        and_reduce_slab.launches = 0
        and_reduce_wide.launches = 0
        banded_costs.launches = 0
        banded_costs_bits.launches = 0
        banded_costs_warp.launches = 0
        proposal_bound.launches = 0

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
        st = production._shared_sharded_typer(
            gene, prod_opts, production.default_mesh(dev), 100)
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
            scale_dp = stages.get("verify.device_dp", {}).get("n", 0)

    # ---- 8. the pure-device programs ---- #
    dryrun_phase(big, dev)

    # ---- 8b. many devices on one card: 2 shards, 2 gloo ranks, a
    # one-rank NCCL world (the 2-shard run's launches counted) ---- #
    mesh_launches = mesh_phase(big, b1, b2, big_gpu, runs["prod-scale"][0],
                               runs["prod-scale"][1], prod_opts, dev, counts,
                               reset, os.path.join(ROOT, "build",
                                                   "chip_smoke"))

    # ---- 9. one sample over a family: type_family through the panel
    # router (counts set to 0 just before its run, read just after), K1
    # at the router's shape, linear typing and SAM, genome extraction ---- #
    from hgtpu_torch.align import PanelRouter
    from hgtpu_torch.native import have_native

    t0 = time.perf_counter()
    fam, cat, fam_truths, per_gene, f1, f2 = build_family()
    log("setup: family %s, %d alleles x ~%d bp each, %d pairs with %d "
        "background (%.1f s)" % (",".join(cat.genes),
                                 next(iter(cat.genes.values())).n_alleles,
                                 len(next(iter(cat.genes.values())).backbone),
                                 len(f1), 2000, time.perf_counter() - t0))
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    bounds = []
    fam_launches, operands, fa, fam_proof, fam_res, fam_wall = family_phase(
        cat, fam_truths, f1, f2, dev, counts, reset,
        os.path.join(work, "family"), bounds)
    kernels.extend(bound_phase(bounds, cuda_ms))
    del bounds
    rng = np.random.default_rng(23)
    pos = rng.integers(0, len(fam["genome"]) - 600, len(f1))
    long_seqs = [fam["genome"][p:p + 600] for p in pos]
    cpu_router = PanelRouter([(g, cat.genes[g]) for g in cat.genes],
                             device="cpu")
    kernels.extend(panel_phase(fa.router, cpu_router, operands, long_seqs,
                               cuda_ms))
    del operands, fa, cpu_router, long_seqs
    linear_sam_phase(cat, fam_truths, per_gene, dev,
                     os.path.join(work, "family.A.sam"))
    extract_phase(cat, fam, fam_truths, f1, f2, dev,
                  os.path.join(work, "gg"))

    # ---- 10. the command line on the card: the family's sample, the
    # simulation self-test at HLA-A scale, the module entries ---- #
    cli_phase(cat, fam_truths, f1, f2, fam_res, fam_wall, big, toy, dev,
              counts, reset, work, smi)
    del fam_res

    # ---- 11. --assembly: the scale call with its launches counted, the
    # toy het call, the command line, the toolkit's last four commands ---- #
    asm_launches, asm_scale_call = assembly_phase(big, toy, dev, counts,
                                                  reset, work, smi)

    # ---- 12. hgtpu's golden command-line runs, its regression campaign
    # and its shard sweep, on the card (each phase's launches counted:
    # set to 0 just before, read just after) ---- #
    golden_launches = golden_phase(work, smi)
    campaign_launches = campaign_phase(big, dev, counts, reset,
                                       asm_scale_call, smi)
    scaling_launches = scaling_phase(counts, reset, smi)

    # ---- 13. the punt probe: one shard of the card against one CPU
    # shard ---- #
    punts_phase(dev, smi)

    # ---- 14. hgtpu's edge cases: the edge genes on the card (launches
    # counted per case), the kernels at degenerate shapes, a BAM the
    # port wrote ---- #
    edges_launches = edges_phase(big, b1, b2, dev, counts, reset, work, smi)

    # ---- 15. proof of path ---- #
    for rec in kernels + off_path:
        rec["launches"] = (fam_launches if rec.get("path") == "family"
                           else prod_launches)[rec["name"]]
        rec["launches_assembly"] = asm_launches[rec["name"]]
        rec["launches_mesh"] = mesh_launches[rec["name"]]
        rec["launches_golden"] = golden_launches[rec["name"]]
        rec["launches_campaign"] = campaign_launches[rec["name"]]
        rec["launches_scaling"] = scaling_launches[rec["name"]]
        rec["launches_edges"] = edges_launches[rec["name"]]
    for name in ("placement_scores", "and_reduce_slab", "banded_dp_bits"):
        if host_launches[name] <= 0:
            raise AssertionError("%s never launched on the host-engine path"
                                 % name)
    if scale_launches["banded_dp_bits"] <= 0 or not scale_dp:
        raise AssertionError("the bit DP kernel never launched in the "
                             "prod-scale rescue")
    if host_launches["banded_dp_warp"] or prod_launches["banded_dp_warp"]:
        raise AssertionError("the warp DP kernel launched on a path (budget "
                             "2 takes the bit kernel)")
    if big_gpu.native is None or big_gpu._dp_tables is None \
            or toy_gpu._dp_tables is None:
        raise AssertionError("device verify is off on the card: the native "
                             "verifier is not loaded")
    if toy_launches["placement_scores"] <= 0 \
            or scale_launches["placement_scores"] <= 0:
        raise AssertionError("K1 did not launch in both production runs")
    if scale_fold and scale_launches["and_reduce_slab"] <= 0:
        raise AssertionError("the prod-scale rescue reached the fold but "
                             "K2 never launched")
    if prod_launches["and_reduce_slab"] <= 0:
        raise AssertionError("K2 never launched on the production path")
    if mesh_launches["placement_scores"] <= 0 \
            or (scale_fold and mesh_launches["and_reduce_slab"] <= 0) \
            or (scale_dp and mesh_launches["banded_dp_bits"] <= 0) \
            or mesh_launches["banded_dp_warp"]:
        raise AssertionError("mesh: the 2-shard run's launches %s"
                             % mesh_launches)
    if fam_proof["router"] != 2 or fam_proof["gene"] <= 0 \
            or fam_launches["placement_scores"] \
            != fam_proof["router"] + fam_proof["gene"]:
        raise AssertionError("family: K1 launched %d times, want the "
                             "router's 2 (one per mate) + %d per-gene "
                             "placements" % (fam_launches["placement_scores"],
                                             fam_proof["gene"]))
    for name in ("and_reduce_slab", "banded_dp_bits", "proposal_bound"):
        if fam_launches[name] <= 0:
            raise AssertionError("%s never launched on the family path"
                                 % name)
    if not have_native():
        raise AssertionError("the native library (SA-IS, verifier) is not "
                             "loaded")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    if "hgtpu" in sys.modules:
        raise AssertionError("the JAX package hgtpu was imported")
    log("proof: launches host path %s, production path %s (prod-scale %s; "
        "rescue reached the fold: %s; device verify in the rescue: %d "
        "calls), family path %s (K1: the router %d + per-gene placements "
        "%d), assembly run %s, 2-shard mesh run %s; jax imported: no; "
        "hgtpu imported: no; native library loaded: yes"
        % (host_launches, prod_launches, scale_launches, scale_fold,
           scale_dp, fam_launches, fam_proof["router"], fam_proof["gene"],
           asm_launches, mesh_launches))
    log("wall: chip_smoke %.1f s" % (time.perf_counter() - t_start))

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")

    def ordered(recs):
        return [{k: r[k] for k in order + tuple(k for k in r
                                                if k not in order)}
                for r in recs]

    log(json.dumps({"kernels": ordered(kernels),
                    "off_path": ordered(off_path)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
