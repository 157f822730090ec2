# Port of hgtpu/cli/main.py: the same flags, modes and reports; the run
# types on one torch device that main() picks, in place of a JAX platform.
"""Main CLI — the `hisatgenotype` equivalent.

Usage mirrors the reference driver (./hisatgenotype:692-771):

  python -m hgtpu_torch --base hla --ix-dir DB --locus-list A \
      --debug basic,test_size:5,set_seed:101 --out-dir out     # simulation
  python -m hgtpu_torch --base hla --ix-dir DB -1 r1.fq -2 r2.fq  # reads

The database directory holds the reference-format text files
(<base>_backbone.fa, <base>.snp, .link, .haplotype, .locus, .allele, ...)
produced by `python -m hgtpu_torch.cli.toolkit extract-vars`, by hgtpu's
or by the reference's own extract_vars.

The run types on a CUDA device unless asked otherwise: `main(argv,
device=...)` in process, or the environment variable HGTPU_TORCH_DEVICE
(any torch device string, e.g. `cpu`).  Where CUDA is asked for, directly
or by default, and no card is present, the CLI exits with an error; it
never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from ..db.catalog import import_text
from ..typer.engine import TypingOptions
from ..typer.report import ReportWriter
from ..utils.io import read_fastx
from . import args as A

DEVICE_ENV = "HGTPU_TORCH_DEVICE"


class DeviceUnavailable(RuntimeError):
    """The device the run asked for is not present."""


def build_parser(advanced=False):
    """Two-tier parser: common flags always, advanced flags surfaced by
    --advanced-help (ref: the dual-parser trick, hisatgenotype:732-765)."""
    p = argparse.ArgumentParser(
        prog="hgtpu_torch",
        description="HLA/CYP/CODIS genotyping on one CUDA device",
        epilog="use --advanced-help for simulation/assembly tuning flags")
    A.args_common(p)
    A.args_databases(p, genome=True)
    A.args_input(p)
    A.args_aligner(p)
    A.args_set_aligner(p)
    A.args_reference_type(p)
    A.args_no_partial(p)
    A.args_single_end(p)
    A.args_assembly(p)
    A.args_simulation(p)
    A.args_output(p)
    p.add_argument("--advanced-help", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def _resolve_ix_dir(ix_dir):
    """Follow a hg_ix.link indirection file if present
    (ref: hisatgenotype_args.py:78-87)."""
    link = os.path.join(ix_dir, "hg_ix.link")
    if os.path.exists(link):
        target = open(link).read().strip()
        if target:
            return target
    return ix_dir


def pick_device(device=None) -> torch.device:
    """The device a command-line run types on: `device` if the caller
    gives one, else $HGTPU_TORCH_DEVICE, else `cuda`.  Raises
    DeviceUnavailable where CUDA is asked for and no card is present."""
    want = device if device is not None else (
        os.environ.get(DEVICE_ENV) or "cuda")
    dev = torch.device(want)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; to run on the CPU set %s=cpu "
            "(or pass device=\"cpu\" to main)" % DEVICE_ENV)
    return dev


def main(argv=None, device=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.advanced_help:
        parser.print_help()
        return 0
    try:
        device = pick_device(device)
    except DeviceUnavailable as e:
        print("Error: %s" % e, file=sys.stderr)
        return 1
    debug = A.parse_debug(args.debug)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.verbose and not args.verbose_level:
        args.verbose_level = 1

    args.ix_dir = _resolve_ix_dir(args.ix_dir)
    if args.region_list:
        # family.gene entries override --base/--locus-list (the
        # reference loops families the same way, hisatgenotype:345-369)
        jobs = {}
        for token in args.region_list.split(","):
            fam, _, gene = token.partition(".")
            genes = jobs.setdefault(fam, [])
            if gene:
                genes.append(gene)
        rc = 0
        args.region_list = ""
        for fam, genes in jobs.items():
            args.base_fname = fam
            args.locus_list = ",".join(genes)
            rc |= main_one(args, debug, device)
    else:
        rc = main_one(args, debug, device)
    if args.verbose_level >= 2:
        from ..utils.trace import TRACE
        TRACE.report(sys.stderr)
    return rc


def typing_options_from_args(args, debug=None):
    """Parsed CLI args -> TypingOptions: THE flag->behavior mapping for
    the typing path (held field for field against hgtpu's by
    tests/test_torch_cli.py).  Ref registry:
    hisatgenotype_args.py:33-469."""
    debug = debug or {}
    single_end = bool(args.read_fname_U) or "single-end" in debug
    return TypingOptions(
        family=args.base_fname,
        num_editdist=args.num_editdist,
        num_mismatch=args.num_mismatch,
        allow_discordant=args.discordant or single_end,
        simulation=not (args.read_fname_1 or args.read_fname_U),
        error_correction=args.error_correction,
        assembly=args.assembly,
        best_alleles=args.best_alleles,
        output_allele_counts=args.output_allele_counts,
        type_primary_exons=args.type_primary_exons,
        remove_low_abundance_alleles=args.remove_low_abundance_alleles,
        display_alleles=tuple(
            a for a in args.display_alleles.split(",") if a),
        linear_typing=(args.aligner == "bowtie2" or not args.graph_index),
        strict_pair_distance=args.strict_pair_distance,
        device_typing=args.device_typing,
    )


def main_one(args, debug, device):
    if args.aligner not in ("hisat2", "bowtie2"):
        print("Error: unsupported aligner '%s' (hisat2 or bowtie2)"
              % args.aligner, file=sys.stderr)
        return 1
    if args.reference_type == "chromosome":
        # the reference's chromosome mode needs per-chromosome backbones
        # built by its extract_vars; only gene and genome are supported
        print("Error: --reference-type chromosome is not supported; "
              "use gene (default) or genome with -x", file=sys.stderr)
        return 1
    if args.reference_type == "genome":
        return run_genome_regions(args, device)

    prefix = os.path.join(args.ix_dir, args.base_fname)
    catalog = import_text(args.base_fname, prefix)
    locus_list = [g for g in args.locus_list.split(",") if g] \
        or list(catalog.genes)
    only = [g for g in args.only_locus_list.split(",") if g]
    if only:
        # restrict typing targets while the extraction stage still sees
        # the full database (ref args.py:328-333)
        locus_list = [g for g in locus_list if g in only]

    if not args.partial:
        # --no-partial: drop partial alleles from every typing panel
        for g in list(catalog.genes):
            part = sorted(catalog.genes[g].partial)
            if part:
                catalog.genes[g] = catalog.genes[g].exclude_alleles(part)

    # novel-allele experiments: remove alleles from the typing panel but
    # keep them available as simulation truth (the reference rebuilds its
    # DB without them, etc/hisatgenotype_hla_cyp.py:552,1154)
    full_genes = dict(catalog.genes)
    exclude = [a for a in args.exclude_allele_list.split(",") if a]
    if exclude:
        for g in list(catalog.genes):
            catalog.genes[g] = catalog.genes[g].exclude_alleles(exclude)

    if args.alignment_fname:
        return run_alignment_file(args, catalog, locus_list, device)
    if args.bamfile:
        return run_bamfile(args, catalog, locus_list, device)

    if not args.paired and args.read_fname_1 and not args.read_fname_2:
        # --single-end: -1 names a single-ended file (ref args.py:190-195)
        args.read_fname_U, args.read_fname_1 = args.read_fname_1, ""

    opts = typing_options_from_args(args, debug)

    if opts.simulation:
        return run_simulation(args, debug, catalog, locus_list, opts,
                              full_genes, device)
    return run_reads(args, catalog, locus_list, opts, device)


def run_genome_regions(args, device):
    """--reference-type genome: type arbitrary chrom:left-right regions of
    a genotype genome built by `toolkit build-genome` (the reference's
    `--base genome` region path, typing_core.py:372-377)."""
    from ..db.genome import region_gene
    from ..pipeline.genotype import type_reads

    if not args.genotype_genome:
        print("Error: --reference-type genome requires -x/--ref-genome "
              "(genotype-genome prefix)", file=sys.stderr)
        return 1
    tokens = [t for t in args.locus_list.split(",") if t]
    if not tokens:
        print("Error: --reference-type genome requires --locus-list of "
              "chrom:left-right regions", file=sys.stderr)
        return 1
    if not (args.read_fname_1 or args.read_fname_U):
        print("Error: genome-region typing needs real reads (-1/-2 or -U)",
              file=sys.stderr)
        return 1
    reads_1 = read_fastx(args.read_fname_U or args.read_fname_1)
    reads_2 = read_fastx(args.read_fname_2) if args.read_fname_2 else None
    core_id = os.path.basename(
        (args.read_fname_U or args.read_fname_1)).split(".")[0]
    report_base = os.path.join(
        args.out_dir, "%s-genome.%s" % (args.output_base, core_id))
    opts = TypingOptions(family="genome",
                         num_editdist=args.num_editdist,
                         allow_discordant=args.discordant or not reads_2,
                         error_correction=args.error_correction)
    w = ReportWriter(report_base + ".report", echo=args.verbose)
    w.header(dbversion="genome", command=" ".join(sys.argv))
    w.begin_aligner()
    for token in tokens:
        chrom, _, span = token.partition(":")
        left, right = (int(x) for x in span.split("-"))
        region = region_gene(args.genotype_genome, chrom, left, right)
        res = type_reads(region, reads_1, reads_2, opts, device=device)
        w.gene_result(res, simulation=False)
    w.close()
    print("Report written to %s.report" % report_base, file=sys.stderr)
    return 0


def run_simulation(args, debug, catalog, locus_list, opts,
                   full_genes=None, device=None):
    """Ref: the --debug simulation sweep (typing_core.py:2488-2648)."""
    from ..pipeline.genotype import simulation_sweep

    test_size = int(debug.get("test_size", 5 if "basic" in debug else 200))
    seed = debug.get("set_seed", args.random_seed)
    seed = int(seed) if seed is not None else None
    skip_regions = []
    for token in args.skip_fragment_regions.split(","):
        if token:
            l, r = token.split("-")
            skip_regions.append((int(l), int(r)))
    allele_count = 2 if "pair" in debug else 1
    paired = "single-end" not in debug
    # ref: --debug test_list:<allele[-allele]> and test_id:<i[-j]>
    # (hisatgenotype:381-393)
    test_list = None
    if "test_list" in debug:
        test_list = [debug["test_list"].split("-")]
        allele_count = len(test_list[0])
    test_ids = None
    if "test_id" in debug:
        test_ids = {int(x) for x in str(debug["test_id"]).split("-")}

    total_passed = 0
    total = 0
    def report_base_for(t):
        return os.path.join(args.out_dir, "%s-%s.test-%d"
                            % (args.output_base, args.base_fname, t + 1))

    from ..utils.runlog import RunLog
    runlog = RunLog(args.out_dir)
    for gene in locus_list:
        ref = catalog.gene(gene)
        try:
            n, results = simulation_sweep(
                ref, test_size=test_size, seed=seed, paired=paired,
                allele_count=allele_count,
                simulate_interval=args.simulate_interval,
                read_len=args.read_len, fragment_len=args.fragment_len,
                perbase_errorrate=args.perbase_errorrate,
                perbase_snprate=args.perbase_snprate,
                skip_fragment_regions=skip_regions, opts=opts,
                report_base_fn=report_base_for if opts.assembly else None,
                test_list=test_list, test_ids=test_ids,
                sim_gene=(full_genes or {}).get(gene), device=device)
        except Exception:
            # per-gene failure: log the traceback and keep going (the
            # reference captures per-job tracebacks into the date-stamped
            # run log, hisatgenotype:670-680)
            runlog.exception("%s %s" % (args.base_fname, gene))
            print("gene %s failed; traceback in %s"
                  % (gene, runlog.path), file=sys.stderr)
            total += test_size * allele_count
            continue
        for t, (true_alleles, res) in enumerate(results):
            report_base = os.path.join(
                args.out_dir,
                "%s-%s.test-%d" % (args.output_base, args.base_fname, t + 1))
            w = ReportWriter(report_base + ".report", echo=args.verbose)
            w.header(dbversion=catalog.version,
                     command=" ".join(sys.argv))
            w.begin_aligner()
            w.gene_result(res, simulation=True, true_alleles=true_alleles,
                          best_alleles=args.best_alleles)
            if opts.assembly:
                w.assembly_detail(res.contigs)
                w.assembly_calls({gene: res.assembly_call})
                if res.contigs:
                    with open(report_base + ".fasta", "w") as f:
                        for key, seq in res.contigs.items():
                            print(">%s" % key, file=f)
                            for s in range(0, len(seq), 60):
                                print(seq[s:s + 60], file=f)
            w.close()
        total_passed += n
        total += len(results) * allele_count
        print("\t\tPassed so far: %d/%d (%.2f%%)"
              % (total_passed, total, total_passed * 100.0 / max(1, total)),
              file=sys.stderr)
    return 0 if total_passed == total else 1


def run_bamfile(args, catalog, locus_list, device):
    """Type from a coordinate BAM of host-genome alignments: extract the
    reads overlapping each locus placement, then type per gene (the
    reference's --bamfile flow, hisatgenotype:242-315, via samtools;
    here via the in-process BAM reader)."""
    from ..pipeline.genotype import type_reads
    from ..utils.bam import reads_from_bam

    paired = not args.read_fname_U and "single-end" not in args.debug
    opts = TypingOptions(family=args.base_fname,
                         num_editdist=args.num_editdist,
                         allow_discordant=args.discordant or not paired,
                         error_correction=args.error_correction,
                         assembly=args.assembly,
                         best_alleles=args.best_alleles,
                         output_allele_counts=args.output_allele_counts)
    core_id = os.path.basename(args.bamfile).split(".")[0]
    report_base = os.path.join(
        args.out_dir, "%s-%s.%s" % (args.output_base, args.base_fname,
                                    core_id))
    w = ReportWriter(report_base + ".report", echo=args.verbose)
    w.header(dbversion=catalog.version, command=" ".join(sys.argv))
    w.begin_aligner()
    for gene in locus_list:
        ref = catalog.gene(gene)
        r1, r2 = reads_from_bam(args.bamfile, ref.chrom, ref.chrom_left,
                                ref.chrom_right, paired=paired)
        if args.verbose:
            print("%s: %d pairs extracted from %s" %
                  (gene, len(r1), args.bamfile), file=sys.stderr)
        res = type_reads(ref, [(n, s) for n, s, _q in r1],
                         [(n, s) for n, s, _q in r2] if paired else None,
                         opts, device=device)
        w.gene_result(res, simulation=False,
                      output_allele_counts=args.output_allele_counts,
                      best_alleles=args.best_alleles)
    w.close()
    print("Report written to %s.report" % report_base, file=sys.stderr)
    return 0


def run_alignment_file(args, catalog, locus_list, device):
    """Type from an existing SAM alignment (the reference's --alignment
    path through typing(), alignment_fname != "")."""
    from ..pipeline.genotype import type_from_sam

    opts = TypingOptions(family=args.base_fname,
                         num_editdist=args.num_editdist,
                         allow_discordant=args.discordant,
                         error_correction=args.error_correction)
    core_id = os.path.basename(args.alignment_fname).split(".")[0]
    report_base = os.path.join(
        args.out_dir, "%s-%s.%s" % (args.output_base, args.base_fname,
                                    core_id))
    w = ReportWriter(report_base + ".report", echo=args.verbose)
    w.header(dbversion=catalog.version, command=" ".join(sys.argv))
    w.begin_aligner()
    for gene in locus_list:
        res = type_from_sam(catalog.gene(gene), args.alignment_fname, opts,
                            device=device)
        w.gene_result(res, simulation=False,
                      output_allele_counts=args.output_allele_counts)
    w.close()
    print("Report written to %s.report" % report_base, file=sys.stderr)
    return 0


def run_reads(args, catalog, locus_list, opts, device):
    from ..pipeline.genotype import type_family

    if args.read_fname_U:
        reads_1 = read_fastx(args.read_fname_U)
        reads_2 = None
        core_id = os.path.basename(args.read_fname_U).split(".")[0]
    else:
        reads_1 = read_fastx(args.read_fname_1)
        reads_2 = read_fastx(args.read_fname_2) if args.read_fname_2 else None
        core_id = os.path.basename(args.read_fname_1).split(".")[0]

    report_base = os.path.join(
        args.out_dir, "%s-%s.%s" % (args.output_base, args.base_fname,
                                    core_id))
    opts.report_base = report_base
    from ..utils.runlog import RunLog
    runlog = RunLog(args.out_dir)
    results = type_family(catalog, reads_1, reads_2,
                          locus_list=locus_list, opts=opts,
                          sam_out=report_base if args.keep_alignment
                          else None, threads=args.threads, runlog=runlog,
                          device=device)
    failed = [g for g in locus_list if results.get(g) is None]
    if failed:
        print("genes failed (tracebacks in %s): %s"
              % (runlog.path, ",".join(failed)), file=sys.stderr)
        locus_list = [g for g in locus_list if results.get(g) is not None]
    w = ReportWriter(report_base + ".report", echo=args.verbose)
    w.header(dbversion=catalog.version, command=" ".join(sys.argv))
    w.begin_aligner()
    for gene in locus_list:
        res = results[gene]
        w.gene_result(res, simulation=False,
                      output_allele_counts=args.output_allele_counts,
                      best_alleles=args.best_alleles)
    if opts.assembly:
        for g in locus_list:
            w.assembly_detail(results[g].contigs)
        w.assembly_calls({g: results[g].assembly_call for g in locus_list})
        for g in locus_list:
            if results[g].contigs:
                with open("%s.fasta" % report_base, "a") as f:
                    for key, seq in results[g].contigs.items():
                        print(">%s" % key, file=f)
                        for s in range(0, len(seq), 60):
                            print(seq[s:s + 60], file=f)
    w.close()
    print("Report written to %s.report" % report_base, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
