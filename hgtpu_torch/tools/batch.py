# Copy of hgtpu/tools/batch.py; run_batch takes the caller's device.
"""Batch sample runner + pedigree concordance.

Equivalent of hisatgenotype_tools/hisatgenotype_locus_samples.py: type
many extracted samples (threaded over samples, each sample a full typing
run), collect per-gene calls, and check trio (CEPH/platinum-style)
inheritance concordance (ref: locus_samples.py:288-329).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from ..db.catalog import Catalog
from ..pipeline.genotype import type_family
from ..typer.engine import TypingOptions
from ..utils.io import read_fastx


def find_samples(read_dir, suffix="extracted.1.fq.gz"):
    """{sample: (reads1 path, reads2 path|None)} (ref scans
    *.extracted.1.fq.gz, locus_samples.py:166)."""
    out = {}
    for fname in sorted(os.listdir(read_dir)):
        if not fname.endswith(suffix):
            continue
        sample = fname[:-len(suffix)].rstrip(".-_")
        p1 = os.path.join(read_dir, fname)
        p2 = p1.replace(".1.", ".2.") if ".1." in fname else None
        if p2 and not os.path.exists(p2):
            p2 = None
        out[sample] = (p1, p2)
    return out


def run_batch(catalog: Catalog, samples: dict, locus_list=None, opts=None,
              threads=4, device=None):
    """samples: {sample: (reads1, reads2|None)}; every sample is typed on
    `device` (default: hgtpu_torch.default_device()).
    Returns {sample: {gene: [(allele, prob)]}}."""
    opts = opts or TypingOptions()

    def work(item):
        sample, (p1, p2) = item
        reads_1 = read_fastx(p1)
        reads_2 = read_fastx(p2) if p2 else None
        results = type_family(catalog, reads_1, reads_2,
                              locus_list=locus_list, opts=opts,
                              device=device)
        return sample, {g: r.prob for g, r in results.items()}

    out = {}
    with ThreadPoolExecutor(max_workers=threads) as ex:
        for sample, calls in ex.map(work, samples.items()):
            out[sample] = calls
    return out


def top_two(prob, min_ab=0.1):
    calls = [a for a, p in prob[:2] if p >= min_ab]
    if len(calls) == 1:
        calls = calls * 2  # homozygous
    return calls


def trio_concordant(child_prob, mother_prob, father_prob, min_ab=0.1):
    """Mendelian check: one child allele from each parent
    (ref: pedigree concordance, locus_samples.py:288-329)."""
    c = top_two(child_prob, min_ab)
    m = set(top_two(mother_prob, min_ab))
    f = set(top_two(father_prob, min_ab))
    if len(c) < 2:
        return False
    a1, a2 = c[0], c[1]
    return (a1 in m and a2 in f) or (a1 in f and a2 in m)
