# Copy of hgtpu/tools/compare.py.
"""Accuracy comparison against external truth tables.

Offline port of the reference's comparison harnesses
(etc/compare_HLA.py:1-147, compare_HLA_Omixon.py): two
typing tables — ours and an external truth (UTSW panel, Omixon export,
Platinum Genomes gold calls, ...) — are collapsed to a field resolution
level (1 = allele group, 2 = protein), and per gene each sample's truth
alleles are looked up in our ranked calls.  A truth allele found inside
the top two ranked calls counts toward the "top two" concordance, inside
the top ten toward "top ten"; a homozygous truth (one allele) counts
double, exactly as the reference scores it.

Table format (TSV, one call per line — the reference's cp_hla.txt):
    sample  GENE*allele [  abundance [  vars_covered ]]
"""
from __future__ import annotations

import dataclasses

HLA_GENES = ("A", "B", "C", "DQA1", "DQB1", "DRB1")


def _collapse(allele: str, level: int) -> str:
    fields = allele.split(":")
    return ":".join(fields[:level]) if level < len(fields) else allele


def read_typing_table(path_or_lines, level: int):
    """{sample: {gene: [[allele, abundance], ...] sorted desc}} with
    alleles collapsed to `level` fields and abundances of collapsed
    duplicates summed (ref compare_HLA.py:16-64)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.read().splitlines()
    else:
        lines = list(path_or_lines)
    table = {}
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split("\t")
        sample, full = fields[0], fields[1]
        abundance = float(fields[2]) if len(fields) >= 3 else 0.0
        gene, allele = full.split("*")
        allele = _collapse(allele, level)
        per_gene = table.setdefault(sample, {}).setdefault(gene, [])
        for entry in per_gene:
            if entry[0] == allele:
                entry[1] += abundance
                break
        else:
            per_gene.append([allele, abundance])
    for sample in table.values():
        for gene in sample:
            sample[gene].sort(key=lambda a: a[1], reverse=True)
    return table


@dataclasses.dataclass
class GeneConcordance:
    gene: str
    level: int
    # count[k] = samples with k truth alleles matched (top-2 / top-10)
    top2: list
    top10: list

    @property
    def pct2(self):
        tot = sum(self.top2) * 2
        return 100.0 * (self.top2[1] + 2 * self.top2[2]) / tot if tot else 0.0

    @property
    def pct10(self):
        tot = sum(self.top10) * 2
        return (100.0 * (self.top10[1] + 2 * self.top10[2]) / tot
                if tot else 0.0)


def _matches(truth_allele, ranked, level):
    """Index in `ranked` of the first allele agreeing with the truth on
    the first `level` fields (ref compare_HLA.py:82-103), or -1."""
    t = truth_allele.split(":")
    for idx, (allele, _ab) in enumerate(ranked):
        c = allele.split(":")
        if all(t[i] == c[i] for i in range(min(len(t), len(c), level))):
            return idx
    return -1


def compare_tables(calls, truth, levels=(1, 2), genes=HLA_GENES):
    """Concordance of `calls` against `truth` (both table paths or line
    lists).  Returns {level: {gene: GeneConcordance}}."""
    out = {}
    for level in levels:
        calls_t = read_typing_table(calls, level)
        truth_t = read_typing_table(truth, level)
        per_gene = {}
        for gene in genes:
            c2, c10 = [0, 0, 0], [0, 0, 0]
            seen = False
            for sample, truth_genes in truth_t.items():
                if sample not in calls_t or gene not in truth_genes \
                        or gene not in calls_t[sample]:
                    continue
                seen = True
                ranked = calls_t[sample][gene]
                homozygous = len(truth_genes[gene]) == 1
                n2 = n10 = 0
                for t_allele, _ab in truth_genes[gene]:
                    idx = _matches(t_allele, ranked, level)
                    if idx < 0:
                        continue
                    if idx < 2:
                        n2 += 2 if homozygous else 1
                    # the reference's "top ten" tally counts a match at
                    # ANY rank (compare_HLA.py:99-103)
                    n10 += 2 if homozygous else 1
                c2[min(n2, 2)] += 1
                c10[min(n10, 2)] += 1
            if seen:
                per_gene[gene] = GeneConcordance(gene, level, c2, c10)
        out[level] = per_gene
    return out


def format_report(results) -> str:
    lines = []
    for level, per_gene in sorted(results.items()):
        lines.append("Level: %d" % level)
        for gene, gc in per_gene.items():
            lines.append("\t%s" % gene)
            lines.append("\t\tTop two\t0: %d, 1: %d, 2: %d (%.2f%%)"
                         % (gc.top2[0], gc.top2[1], gc.top2[2], gc.pct2))
            lines.append("\t\tTop ten\t0: %d, 1: %d, 2: %d (%.2f%%)"
                         % (gc.top10[0], gc.top10[1], gc.top10[2],
                            gc.pct10))
    return "\n".join(lines)
