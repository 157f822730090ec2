# Copy of hgtpu/db/clinvar.py.
"""External variant import (ClinVar VCF / UCSC dbSNP common tables).

The reference shells out to hisat2's extract scripts and merges the
result into the genotype genome (`hisatgenotype_build_genome.py:65-142`:
clinvar.vcf.gz -> clinvar.{snp,haplotype,clnsig}; snp144Common.txt ->
.{snp,haplotype}; interleave + renumber at `:205-290`; `.clnsig` output
at `:244-247, 327-360`).  This module is the in-process equivalent: VCF
and UCSC parsers producing the same per-chromosome variant/haplotype
structures, which db.genome.build_genotype_genome splices into the
output coordinates.

Variant tuples follow the reference's read_variants shape
(typing_common.py:339-369): per chrom, position-sorted
(left, type, data, id) with type in {single, deletion, insertion},
deletion data = length, 0-based positions.
"""
from __future__ import annotations

import gzip
from collections import defaultdict


def _open(path):
    return gzip.open(path, "rt") if str(path).endswith(".gz") \
        else open(path)


def read_vcf_variants(path):
    """Parse a (ClinVar-style) VCF into (vars, clnsig).

    vars: {chrom: [(left, type, data, id)] position-sorted}
    clnsig: {var_id: (gene, significance)} from GENEINFO/CLNSIG INFO
    fields (ref read_clnsig consumes exactly (gene, clnsig) pairs,
    build_genome.py:35-40).
    """
    out = defaultdict(list)
    clnsig = {}
    with _open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 8:
                continue
            chrom, pos, vid, ref, alts, _qual, _filt, info = cols[:8]
            pos = int(pos) - 1            # VCF is 1-based
            info_d = {}
            for item in info.split(";"):
                if "=" in item:
                    k, v = item.split("=", 1)
                    info_d[k] = v
            for ai, alt in enumerate(alts.split(",")):
                if not alt or alt == ".":
                    continue
                sub_id = vid if ai == 0 else "%s.%d" % (vid, ai)
                if len(ref) == 1 and len(alt) == 1:
                    if alt not in "ACGT":
                        continue
                    out[chrom].append((pos, "single", alt, sub_id))
                elif len(ref) > 1 and len(alt) == 1 and ref[0] == alt:
                    out[chrom].append(
                        (pos + 1, "deletion", str(len(ref) - 1), sub_id))
                elif len(alt) > 1 and len(ref) == 1 and alt[0] == ref:
                    if alt[1:].strip("ACGT"):
                        continue
                    out[chrom].append((pos + 1, "insertion", alt[1:],
                                       sub_id))
                else:
                    continue              # complex substitution: skip
                gene = info_d.get("GENEINFO", ":").split(":")[0] or "-"
                sig = info_d.get("CLNSIG", "")
                if sig:
                    clnsig[sub_id] = (gene, sig)
    for chrom in out:
        out[chrom].sort()
    return dict(out), clnsig


def read_ucsc_common(path):
    """Parse a UCSC snpNNNCommon.txt(.gz) table (the reference pipes it
    through hisat2_extract_snps_haplotypes_UCSC.py,
    build_genome.py:107-142).  Columns per the UCSC snp table schema:
    bin chrom chromStart chromEnd name score strand refNCBI refUCSC
    observed molType class ...

    Returns {chrom: [(left, type, data, id)]} position-sorted; "chr"
    prefixes are stripped and chrM becomes MT, mirroring the awk
    renaming the reference applies (:125-129).
    """
    out = defaultdict(list)
    with _open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 12:
                continue
            chrom = cols[1]
            if chrom.startswith("chr"):
                chrom = chrom[3:]
            if chrom == "M":
                chrom = "MT"
            start = int(cols[2])
            end = int(cols[3])
            name = cols[4]
            ref_allele = cols[8]
            observed = cols[9]
            klass = cols[11]
            if klass == "single":
                alts = [a for a in observed.split("/")
                        if a in "ACGT" and a != ref_allele and len(a) == 1]
                for ai, alt in enumerate(alts):
                    sub_id = name if ai == 0 else "%s.%d" % (name, ai)
                    out[chrom].append((start, "single", alt, sub_id))
            elif klass == "deletion":
                if end > start:
                    out[chrom].append((start, "deletion",
                                       str(end - start), name))
            elif klass == "insertion":
                ins = [a for a in observed.split("/") if a != "-"
                       and not a.strip("ACGT")]
                if ins:
                    out[chrom].append((start, "insertion", ins[0], name))
    for chrom in out:
        out[chrom].sort()
    return dict(out)


def group_haplotypes(vars_per_chrom, inter_gap: int = 30):
    """Cluster nearby external variants into haplotype windows:
    consecutive variants whose span gap is <= inter_gap share a window
    (the same inter-gap rule the DB builder applies,
    typing_process.py:1130-1224).  Returns
    {chrom: [(left, right, [ids])]}.
    """
    out = {}
    for chrom, vars_ in vars_per_chrom.items():
        hts = []
        cur = []
        cur_right = 0
        for left, vtype, data, vid in vars_:
            right = left + int(data) - 1 if vtype == "deletion" else left
            if cur and left - cur_right > inter_gap:
                hts.append((cur[0][0], cur_right, [v[3] for v in cur]))
                cur = []
            cur_right = right if not cur else max(cur_right, right)
            cur.append((left, vtype, data, vid))
        if cur:
            hts.append((cur[0][0], cur_right, [v[3] for v in cur]))
        out[chrom] = hts
    return out
