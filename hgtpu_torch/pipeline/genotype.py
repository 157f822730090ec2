"""End-to-end genotyping orchestration (port of
hgtpu/pipeline/genotype.py).

Routes a read set to the production device program
(parallel/production.py) or to the host engine (align read batches with
the torch aligner, group mates, type with the device fold), or to the
linear path (exact FM seeds and a Hamming check against the allele
panel), as hgtpu does; types every gene of a family from one read set
(the panel router and the NH==1 rule, then the host engine per gene) or
a gene from a SAM file; and for simulations sweeps random allele draws
checking that the truth ranks #1 — the reference's built-in self-test
(`--debug basic,test_size:N,set_seed:S`).
"""
from __future__ import annotations

import random
from collections import defaultdict

from ..db.catalog import GeneRef
from ..sim import simulate_reads
from .. import resolve_device
from ..align import GeneAligner
from ..typer.engine import TypingOptions, type_gene
from ..utils.trace import TRACE


def type_reads_linear(gene: GeneRef, reads_1, reads_2=None, opts=None,
                      device=None):
    """Linear-index typing (--aligner bowtie2 / --linear-index): exact
    full-read matches against the concatenated allele panel feed the
    compatibility classes straight into the EM, with no variant-graph
    alignment (ref typing_core.py:1597-1648 consuming the -k 10 linear
    hisat2/bowtie2 run of typing_common.py:995-1027).  The FM index's
    tables live on `device`."""
    from ..align.linear import LinearAligner
    from ..typer.em import single_abundance
    from ..typer.engine import GeneTypingResult

    opts = opts or TypingOptions()
    seqs = [s for _, s in reads_1] + [s for _, s in (reads_2 or [])]
    la = LinearAligner(gene, device=device)
    ranked, cmpt = la.type_linear(
        seqs, max_mm=opts.num_mismatch if opts.num_mismatch > 0 else None)
    prob = single_abundance(
        cmpt, remove_low_abundance_allele=opts.remove_low_abundance_alleles)
    return GeneTypingResult(
        gene=gene.gene, num_reads=sum(n for _, n in cmpt.items()),
        num_pairs=len(reads_1), counts=ranked, prob=prob, cmpt=cmpt,
        exon_cmpt={}, primary_exon_cmpt={})


def _take_device_path(opts, paired, device) -> bool:
    """Route typing through the production device program?  "on" forces
    it, "auto" takes it on a CUDA device whenever the options are
    device-compatible (hgtpu's rule, with CUDA in place of a TPU)."""
    if opts.device_typing == "off":
        return False
    from ..parallel.production import device_typing_supported

    if not device_typing_supported(opts, paired):
        return False
    if opts.device_typing == "on":
        return True
    return device.type == "cuda"


def type_reads(gene: GeneRef, reads_1, reads_2=None, opts=None,
               aligner: GeneAligner = None, device=None):
    """reads_*: [(name, seq)].  Returns GeneTypingResult.

    The production path (parallel.production.type_reads_device: place on
    K1, spell, count, host rescue with the device fold on K2, staged EM)
    when _take_device_path says so; otherwise the host-engine path:
    placement (K1) -> host verify -> haplotypes -> device fold (K2) ->
    staged numpy EM.  `device` defaults to the aligner's device; with
    neither, the production path runs over default_mesh() (every visible
    card) and the host path on its first card, as hgtpu takes its
    default mesh.  The call is one TRACE call under the root stage
    call.type_reads."""
    with TRACE.stage("call.type_reads"):
        return _type_reads(gene, reads_1, reads_2, opts, aligner, device)


def _type_reads(gene, reads_1, reads_2, opts, aligner, device):
    opts = opts or TypingOptions()
    if device is None and aligner is not None:
        device = aligner.device
    mesh = None
    if device is None:
        from ..parallel.production import default_mesh

        mesh = default_mesh()
        device = mesh.devices[0]
    device = resolve_device(device)
    if opts.linear_typing:
        return type_reads_linear(gene, reads_1, reads_2, opts, device)
    if _take_device_path(opts, reads_2 is not None, device):
        from ..parallel.production import type_reads_device

        return type_reads_device(gene, reads_1, reads_2, opts,
                                 aligner=aligner, device=device, mesh=mesh)
    aligner = aligner or GeneAligner(gene, num_editdist=opts.num_editdist,
                                     leftmost=opts.family == "codis",
                                     device=device)
    by_read = defaultdict(list)
    groups = [([n for n, _ in reads_1], [s for _, s in reads_1], "L")]
    if reads_2:
        groups.append(([n for n, _ in reads_2],
                       [s for _, s in reads_2], "R"))
    batches = aligner.align_batches(groups)
    for alns in batches:
        for a in alns:
            if a is None:
                continue
            read_id = a.read_id.split("|")[0]
            by_read[read_id].append(a)
    return type_gene(gene, sorted(by_read.items(), key=lambda kv: kv[0]),
                     opts, device=device)


def type_from_sam(gene: GeneRef, sam_path, opts=None, device=None):
    """Type a gene from an existing SAM alignment file (the reference's
    --alignment path, typing() with alignment_fname)."""
    from ..align.sam import read_sam

    opts = opts or TypingOptions()
    groups = read_sam(gene, sam_path, opts.num_editdist)
    return type_gene(gene, groups, opts, device=resolve_device(device))


def type_family(catalog, reads_1, reads_2=None, locus_list=None, opts=None,
                family_aligner=None, sam_out=None, threads=1, runlog=None,
                device=None):
    """Type every gene of a family from one read set.

    Reads are assigned cross-gene by the NH==1 uniqueness rule
    (FamilyAligner: the panel router on K1 for three genes or more); each
    gene in locus_list is then typed independently with the host engine
    (type_gene), as in hgtpu, whatever opts.device_typing says.
    Ref: typing() per-gene loop (typing_core.py:370-1789).
    Returns {gene: GeneTypingResult}.

    When `runlog` (utils.runlog.RunLog) is given, a gene whose typing
    raises is logged with its traceback and mapped to None instead of
    aborting the family — the reference's per-sample error-log behavior
    (hisatgenotype:670-680).  `device` defaults to the family aligner's
    device, else to hgtpu_torch.default_device().

    The call is one TRACE call under the root stage call.type_family
    (with `threads` > 1 each worker's genes are calls of their own).
    """
    with TRACE.stage("call.type_family"):
        return _type_family(catalog, reads_1, reads_2, locus_list, opts,
                            family_aligner, sam_out, threads, runlog,
                            device)


def _type_family(catalog, reads_1, reads_2, locus_list, opts,
                 family_aligner, sam_out, threads, runlog, device):
    from ..align.family import FamilyAligner

    opts = opts or TypingOptions()
    if device is None and family_aligner is not None:
        device = next(iter(family_aligner.aligners.values())).device
    device = resolve_device(device)
    if opts.linear_typing:
        # linear path has no cross-gene routing stage: each gene's panel
        # is matched exactly (multi-gene hits stay ambiguous and drop)
        return {g: type_reads_linear(catalog.genes[g], reads_1, reads_2,
                                     opts, device)
                for g in (locus_list or list(catalog.genes))}
    fa = family_aligner or FamilyAligner(catalog,
                                         num_editdist=opts.num_editdist,
                                         leftmost=opts.family == "codis",
                                         device=device)
    genes = locus_list or list(catalog.genes)
    per_gene_1 = fa.align_batch([n for n, _ in reads_1],
                                [s for _, s in reads_1], "L")
    per_gene_2 = None
    if reads_2:
        per_gene_2 = fa.align_batch([n for n, _ in reads_2],
                                    [s for _, s in reads_2], "R")

    def run_gene(g):
        try:
            by_read = defaultdict(list)
            batches = [per_gene_1[g]]
            if per_gene_2:
                batches.append(per_gene_2[g])
            for alns in batches:
                for a in alns:
                    if a is None:
                        continue
                    by_read[a.read_id.split("|")[0]].append(a)
            groups = sorted(by_read.items(), key=lambda kv: kv[0])
            if sam_out:
                from ..align.sam import write_sam
                write_sam("%s.%s.sam" % (sam_out, g), catalog.genes[g],
                          groups)
            return g, type_gene(catalog.genes[g], groups, opts,
                                device=device)
        except Exception:
            if runlog is None:
                raise
            runlog.exception("%s %s" % (catalog.family, g))
            return g, None

    if threads > 1 and len(genes) > 1:
        # per-gene threading mirrors the reference's per-locus Pool fan-out
        # (hisatgenotype:613-665); numpy/native stages release the GIL
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            results = dict(ex.map(run_gene, genes))
    else:
        results = dict(run_gene(g) for g in genes)
    return results


def simulation_sweep(gene: GeneRef, test_size=5, seed=None, paired=True,
                     allele_count=1, simulate_interval=1, read_len=100,
                     fragment_len=250, perbase_errorrate=0.0,
                     perbase_snprate=0.0, skip_fragment_regions=(),
                     opts=None, aligner=None, verbose=False,
                     report_base_fn=None, test_list=None, test_ids=None,
                     sim_gene=None, device=None):
    """Reference self-test: draw random alleles, simulate, type, and check
    the truth ranks #1 (typing_core.py:2488-2648).

    Returns (n_passed, results list of (true alleles, GeneTypingResult)).
    """
    opts = opts or TypingOptions(simulation=True,
                                 allow_discordant=not paired)
    aligner = aligner or GeneAligner(gene, num_editdist=opts.num_editdist,
                                     leftmost=opts.family == "codis",
                                     device=device)
    rng = random.Random(seed)
    if test_list:
        # explicit allele draws (ref: --debug test_list, hisatgenotype:381)
        tests = [sorted(t) for t in test_list]
    else:
        draws = rng.sample(range(len(gene.allele_names)),
                           test_size * allele_count)
        tests = [sorted(gene.allele_names[draws[t * allele_count + j]]
                        for j in range(allele_count))
                 for t in range(test_size)]
    results = []
    n_passed = 0
    for t in range(len(tests)):
        if test_ids and (t + 1) not in test_ids:
            continue  # ref: --debug test_id filter (hisatgenotype:383)
        alleles = tests[t]
        # sim_gene lets excluded alleles remain simulation truth
        # (novel-allele experiments, --exclude-allele-list)
        r1, r2, _ = simulate_reads(
            sim_gene or gene, alleles, simulate_interval=simulate_interval,
            read_len=read_len, frag_len=fragment_len,
            perbase_errorrate=perbase_errorrate,
            perbase_snprate=perbase_snprate,
            skip_fragment_regions=skip_fragment_regions, seed=rng.random())
        if report_base_fn is not None:
            opts.report_base = report_base_fn(t)
        res = type_reads(
            gene,
            [(r.name, r.seq) for r in r1],
            [(r.name, r.seq) for r in r2] if paired else None,
            opts, aligner, device=device)
        ranks = {}
        for i, (allele, prob) in enumerate(res.prob):
            if allele in alleles:
                ranks[allele] = i
        # per-allele pass tally, as in the reference (typing_core.py:2133-2142
        # counts each correctly-ranked allele separately)
        n_correct = sum(ranks.get(a, 99) < allele_count for a in alleles)
        passed = n_correct == allele_count
        n_passed += n_correct
        if verbose:
            top = res.prob[0] if res.prob else ("-", 0)
            print("test %d: true=%s top=%s %.2f%% %s"
                  % (t + 1, alleles, top[0], top[1] * 100,
                     "PASS" if passed else "FAIL"))
        results.append((alleles, res))
    return n_passed, results
