# Twin of bench.py: the same three cells (generators, seeds, sizes, truth
# checks), warm-up, repeats, stage shares and JSON keys, on the port.
"""Benchmark: end-to-end typing throughput on one card.

    python -m hgtpu_torch.devel.bench [--baseline PATH]

Prints ONE JSON line on stdout, with bench.py's keys: reads/s of the
3,600-allele heterozygous pair (best of N, the median and spread beside
it), its ratio to the emulator anchor, the 60-allele toy's reads/s and
ratio, the route type_reads took, per-stage shares of the best run's
wall (hgtpu_torch.utils.trace), the share spent in device stages, the
dispatched FLOPs and bytes of the TRACE counters over the wall against
the card's peaks, and the WGS-volume extraction rates: the native fastx
scanner on a 2M-read FASTQ and GenomeExtractor routing 100,000 reads.
HGTPU_BENCH_REPEATS sets N (default 5); one warm-up run precedes each
cell.  `run()` takes the cell sizes, bench.py's by default.

Runs on the card unless HGTPU_TORCH_DEVICE names another device
(`HGTPU_TORCH_DEVICE=cpu`), or `run(device="cpu")` in process.  It needs
the native library (`make -C native`) for the fastx scanner.

Where the card forces a change from bench.py:

  peaks        the card's data-sheet peaks (PEAKS, by
               torch.cuda.get_device_name) replace the v5e constants; a
               card missing from PEAKS raises.  A CPU run has none, so its
               mfu_pct, bandwidth_pct and device wall shares are null:
               not measured.
  production_path  the route type_reads took, by its own rule
               (pipeline.genotype._take_device_path), not `backend ==
               "tpu"`.
  start-up     the CUDA kernels are built (ops.cuda_lib.build) before the
               first timed run, in place of the compilation cache; each
               timed run ends in torch.cuda.synchronize().
  extraction   a failure raises and the run exits non-zero; bench.py
               catches it and carries on.
  anchor       BASELINE_MEASURED.json by default, as bench.py; --baseline
               PATH takes one measured on the card's own host
               (python -m hgtpu_torch.devel.baseline_emu).  The anchor's
               file and host are named in the JSON.
  card line    nvidia-smi's name and power limit on stderr before the JSON.

The scale cell's truths are allele_names[123 % n] and [2047 % n], which at
bench.py's 3,600 alleles are its [123] and [2047].
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import REPO, use_synth

# dense bf16 FLOP/s and HBM bytes/s by torch.cuda.get_device_name(): the
# data sheet's rates at the part's full power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),     # H100 SXM, 700 W
}

DEVICE_STAGES = ("place.dispatch", "place.fetch", "verify.device_dp",
                 "type.count_masks.device", "type.count_fold.device",
                 "device.place", "device.spell", "device.countB")

FLOP_COUNTERS = ("flops.placement", "flops.device_fold", "flops.device_dp",
                 "flops.device_classes")
BYTE_COUNTERS = ("bytes.device_classes",)

BASELINE = os.path.join(REPO, "BASELINE_MEASURED.json")

# bench.py's cells: (alleles, length) of the toy and of the scale panel,
# the reads scanned and the reads routed in the extraction cell
TOY = (60, 3000)
SCALE = (3600, 3500)
N_SCAN = 2_000_000
N_ROUTE = 100_000


def _note(msg):
    print("[bench] %s" % msg, file=sys.stderr, flush=True)


def card_peaks(device):
    """(bf16 FLOP/s, bytes/s) of the card `device` is on; None for a CPU
    device.  A card missing from PEAKS raises: its peaks are not guessed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise RuntimeError("no peak rates for %r: add its data sheet's dense "
                           "bf16 and HBM rates to PEAKS" % name)
    return PEAKS[name]


def card_line():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_baseline(path=None):
    with open(path or BASELINE) as f:
        return json.load(f)


def _measure(ref, reads_1, reads_2, aligner, opts=None, repeats=None):
    """Best-of-N e2e typing wall time on the aligner's device; returns
    (best_dt, res, stage summary + counters of the best run, all_dts
    sorted).  HGTPU_BENCH_REPEATS overrides N (default 5)."""
    if repeats is None:
        repeats = int(os.environ.get("HGTPU_BENCH_REPEATS", "5"))
    from ..pipeline import type_reads
    from ..utils.trace import TRACE

    cuda = aligner.device.type == "cuda"
    best = None
    dts = []
    for _ in range(repeats):
        TRACE.reset()
        t0 = time.time()
        res = type_reads(ref, reads_1, reads_2, opts, aligner=aligner)
        if cuda:
            torch.cuda.synchronize(aligner.device)
        dt = time.time() - t0
        dts.append(dt)
        if best is None or dt < best[0]:
            best = (dt, res, TRACE.summary(), TRACE.counters())
    return best + (sorted(dts),)


def _build(name, n_alleles, length, scale=False):
    use_synth()
    from synth import make_gene_msa, make_hla_scale_msa

    from ..db import build_gene_ref

    spec = make_hla_scale_msa(n_alleles=n_alleles, length=length) if scale \
        else make_gene_msa(seed=11, n_alleles=n_alleles, length=length)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


def scale_truths(big):
    n = big.n_alleles
    return [big.allele_names[123 % n], big.allele_names[2047 % n]]


def fastq_text(n_scan, rng, L=100):
    """bench.py's FASTQ: n_scan fixed-width records of L random bases,
    named r0000000..., built as one [n, rec_len] uint8 matrix."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    rows = lut[rng.integers(0, 4, (n_scan, L)).astype(np.uint8)]
    digits = 7
    ids = np.arange(n_scan, dtype=np.int64)
    name_digits = np.stack(
        [(ids // 10 ** (digits - 1 - k)) % 10 for k in range(digits)],
        axis=1).astype(np.uint8) + ord("0")
    rec_len = 2 + digits + 1 + L + 1 + 2 + L + 1
    rec = np.empty((n_scan, rec_len), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    rec[:, 2:2 + digits] = name_digits
    at = 2 + digits
    rec[:, at] = ord("\n")
    rec[:, at + 1:at + 1 + L] = rows
    at += 1 + L
    rec[:, at] = ord("\n")
    rec[:, at + 1] = ord("+")
    rec[:, at + 2] = ord("\n")
    rec[:, at + 3:at + 3 + L] = ord("I")
    rec[:, at + 3 + L] = ord("\n")
    return rec.tobytes()


def family_extractor(device):
    """(GenomeExtractor over bench.py's synthetic family genome on
    `device`, the genome)."""
    use_synth()
    from synth import make_family

    from ..db.build import build_catalog_from_msa
    from ..db.genome import build_genotype_genome
    from ..pipeline.extract_genome import GenomeExtractor

    fam = make_family(seed=17)
    cat = build_catalog_from_msa(
        "hla",
        {g: dict(names=s["names"], rows=s["rows"],
                 ref_allele=s["ref_allele"], exons=s["exons"],
                 primary_exon_idx=s["primary_exon_idx"])
         for g, s in fam["specs"].items()},
        min_var_freq=0.0)
    for g, (lo, hi) in fam["loci"].items():
        cat.genes[g].chrom = "chrS"
        cat.genes[g].chrom_left = lo
        cat.genes[g].chrom_right = hi
    with tempfile.TemporaryDirectory() as tmp:
        spliced, offsets = build_genotype_genome(
            {"chrS": fam["genome"]}, {"hla": cat}, os.path.join(tmp, "gg"))
    ex = GenomeExtractor(spliced, offsets, {"hla": cat}, device=device)
    return ex, fam["genome"]


def route_reads(genome, n_route, rng, L=100):
    """bench.py's routed reads: n_route genome substrings of L bases."""
    pos = rng.integers(0, len(genome) - 260, n_route)
    starts = pos[:, None] + np.arange(L)[None, :]
    g_codes = np.frombuffer(genome.encode(), np.uint8)
    r1s = g_codes[starts]
    return [("q%d" % i, r1s[i].tobytes().decode()) for i in range(n_route)]


def routed_count(routed):
    return sum(len(v[0]) for v in routed.values()) if routed else 0


def _bench_extraction(device, n_scan=N_SCAN, n_route=N_ROUTE):
    """WGS-volume extraction: stream an n_scan-read FASTQ through the
    native fastx scanner, then route n_route reads through the
    genotype-genome extractor on `device` (the reference bins 20-Mbp
    blocks, typing_process.py:1330-1784).  Returns a dict: scan_rps,
    route_rps, routed_n, n_records and the routed reads (reads_1)."""
    from ..native import scan_fastx

    rng = np.random.default_rng(0)
    t_gen = time.time()
    text = fastq_text(n_scan, rng)
    _note("extraction: %d reads, %.0f MB fastq (gen %.1fs)"
          % (n_scan, len(text) / 1e6, time.time() - t_gen))
    t0 = time.time()
    recs = scan_fastx(text)
    scan_dt = time.time() - t0
    if recs is None:
        raise RuntimeError("the native fastx scanner is not built: run "
                           "make -C native")
    if len(recs) != n_scan:
        raise AssertionError("scan_fastx returned %d records of %d"
                             % (len(recs), n_scan))
    del text, recs

    ex, genome = family_extractor(device)
    reads_1 = route_reads(genome, n_route, rng)
    t0 = time.time()
    routed = ex.extract(reads_1, None)
    if ex.fm.device.type == "cuda":
        torch.cuda.synchronize(ex.fm.device)
    route_dt = time.time() - t0
    return dict(scan_rps=n_scan / scan_dt, route_rps=n_route / route_dt,
                routed_n=routed_count(routed), n_records=n_scan,
                reads_1=reads_1)


def run(device=None, toy=TOY, scale=SCALE, n_scan=N_SCAN, n_route=N_ROUTE,
        repeats=None, baseline=None):
    """The three cells on `device` (default: the card, or
    HGTPU_TORCH_DEVICE).  Returns (the JSON object, the measured runs:
    each cell's result, stages and counters, and the extraction dict)."""
    from ..align import GeneAligner
    from ..cli.main import pick_device
    from ..pipeline.genotype import _take_device_path
    from ..sim import simulate_reads
    from ..typer import TypingOptions

    device = pick_device(device)
    peaks = card_peaks(device)
    if device.type == "cuda":
        from ..ops import cuda_lib

        t0 = time.time()
        cuda_lib.build()
        cuda_lib.load()
        _note("kernels built and loaded in %.1f s" % (time.time() - t0))
    _note("device: %s" % device)

    # ---- flagship: hg_test1-scale gene (60 alleles / 3 kb) ---- #
    _note("building %d-allele gene" % toy[0])
    ref = _build("A", *toy)
    aligner = GeneAligner(ref, device=device)
    alleles = ref.allele_names[:4]
    r1, r2, _ = simulate_reads(ref, alleles, simulate_interval=1)
    reads_1 = [(r.name, r.seq) for r in r1]
    reads_2 = [(r.name, r.seq) for r in r2]
    n_reads = len(reads_1) + len(reads_2)

    _note("warm-up")
    _measure(ref, reads_1, reads_2, aligner, repeats=1)
    _note("measuring (%d reads)" % n_reads)
    best_dt, res, stages, counters, toy_dts = _measure(
        ref, reads_1, reads_2, aligner, repeats=repeats)
    if not res.prob:
        raise AssertionError("typing produced no abundance")
    if res.prob[0][0] not in alleles:
        raise AssertionError("typing called a wrong allele")
    reads_per_s = n_reads / best_dt

    # ---- reference scale: 3,600 alleles / 3.5 kb, a heterozygous pair
    # at full simulation depth (~13k reads), the emulator's read set ---- #
    _note("building %d-allele panel" % scale[0])
    big = _build("A", *scale, scale=True)
    big_aligner = GeneAligner(big, device=device)
    truths = scale_truths(big)
    b1, b2, _ = simulate_reads(big, truths, simulate_interval=1, seed=1)
    breads_1 = [(r.name, r.seq) for r in b1]
    breads_2 = [(r.name, r.seq) for r in b2]
    bn = len(breads_1) + len(breads_2)
    _note("warm-up (scale)")
    _measure(big, breads_1, breads_2, big_aligner, repeats=1)
    _note("measuring (%d reads, %d alleles)" % (bn, big.n_alleles))
    big_dt, bres, big_stages, big_counters, big_dts = _measure(
        big, breads_1, breads_2, big_aligner, repeats=repeats)
    if {name for name, _ in bres.prob[:2]} != set(truths):
        raise AssertionError("scale typing missed the het truth pair")
    if not all(0.3 <= frac <= 0.7 for _, frac in bres.prob[:2]):
        raise AssertionError("het abundance off the 50/50 mix")
    big_reads_per_s = bn / big_dt

    # ---- WGS-volume extraction ---- #
    _note("extraction benchmark")
    ext = _bench_extraction(device, n_scan, n_route)
    _note("fastx scan %.0f reads/s, routing %.0f reads/s (%d routed)"
          % (ext["scan_rps"], ext["route_rps"], ext["routed_n"]))

    # ---- derived diagnostics ---- #
    anchor = load_baseline(baseline)
    anchor_scale = anchor["scale"]["reads_per_s"]
    anchor_toy = anchor["toy"]["reads_per_s"]

    def device_share(st, dt):
        if peaks is None:
            return None
        return round(sum(st[k]["s"] for k in DEVICE_STAGES if k in st) / dt,
                     4)

    def pct(ctr, names, dt, peak):
        if peaks is None:
            return None
        return round(100.0 * sum(ctr.get(k, 0.0) for k in names) / dt
                     / peak, 4)

    def shares(st, dt):
        return {k: round(v["s"] / dt, 4)
                for k, v in sorted(st.items(), key=lambda kv: -kv[1]["s"])}

    bf16, hbm = peaks or (None, None)
    path = "device" if _take_device_path(TypingOptions(), True, device) \
        else "host"
    out = {
        "metric": "hla_scale_typing_reads_per_s",
        "value": round(big_reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(big_reads_per_s / anchor_scale, 3),
        "baseline_anchor": {
            "scale_reads_per_s": anchor_scale,
            "toy_reads_per_s": anchor_toy,
            "source": "%s (hgtpu_torch.devel.baseline_emu or "
                      "devel/baseline_emu.py; reference typing hot loop, "
                      "alignment omitted: lower bound on reference cost)"
                      % os.path.relpath(os.path.abspath(baseline or BASELINE),
                                        REPO),
            "host": anchor.get("host")},
        "toy_e2e_reads_per_s": round(reads_per_s, 1),
        "vs_baseline_toy": round(reads_per_s / anchor_toy, 3),
        "production_path": path,
        "repeats": len(big_dts),
        "hla_scale_dt_best": round(big_dts[0], 3),
        "hla_scale_dt_median": round(big_dts[len(big_dts) // 2], 3),
        "hla_scale_spread_pct": round(
            100.0 * (big_dts[-1] - big_dts[0])
            / max(big_dts[len(big_dts) // 2], 1e-9), 1),
        "toy_dt_best": round(toy_dts[0], 3),
        "toy_dt_median": round(toy_dts[len(toy_dts) // 2], 3),
        "stage_shares": shares(stages, best_dt),
        "hla_scale_stage_shares": shares(big_stages, big_dt),
        "device_wall_share": device_share(stages, best_dt),
        "hla_scale_device_wall_share": device_share(big_stages, big_dt),
        "mfu_pct": pct(counters, FLOP_COUNTERS, best_dt, bf16),
        "hla_scale_mfu_pct": pct(big_counters, FLOP_COUNTERS, big_dt, bf16),
        "bandwidth_pct": pct(counters, BYTE_COUNTERS, best_dt, hbm),
        "hla_scale_bandwidth_pct": pct(big_counters, BYTE_COUNTERS, big_dt,
                                       hbm),
        "extract_fastx_scan_reads_per_s": round(ext["scan_rps"], 1),
        "extract_route_reads_per_s": round(ext["route_rps"], 1),
    }
    runs = dict(toy=(res, stages, counters), scale=(bres, big_stages,
                                                    big_counters),
                extract=ext)
    return out, runs


def main(argv=None):
    p = argparse.ArgumentParser(prog="hgtpu_torch.devel.bench")
    p.add_argument("--baseline", default=None,
                   help="the anchor's JSON (default: the repository's "
                        "BASELINE_MEASURED.json)")
    args = p.parse_args(argv)
    from ..cli.main import pick_device

    device = pick_device()
    out, _ = run(device, baseline=args.baseline)
    if device.type == "cuda":
        print(card_line(), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
