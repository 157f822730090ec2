# Copy of hgtpu/tools/results.py.
"""Results parser: collapse .report files into final allele calls.

Equivalent of hisatgenotype_tools/hisatgenotype_parse_results.py plus
build_tree/call_nuance_results (typing_common.py:1965-2010): reads the
abundance sections of report files, groups by sample and gene, and
collapses allele fields to the most specific unambiguous level
(e.g. A*01:01:01:01 + A*01:01:01:02 -> "A*01:01:01 Partial").
"""
from __future__ import annotations

import os
import re

_RANKED = re.compile(
    r"\*{0,3}\s*(\d+) ranked ([\w*:.-]+) \(abundance: ([\d.]+)%\)")


def parse_report(path):
    """[(allele, abundance%)] in rank order from one report file."""
    out = []
    for line in open(path):
        m = _RANKED.search(line)
        if m:
            out.append((m.group(2), float(m.group(3))))
    return out


def collapse_calls(alleles):
    """Collapse a list of equally-likely alleles to the longest shared
    field prefix (ref: call_nuance_results, typing_common.py:1984-2010)."""
    if len(alleles) <= 1:
        return list(alleles)
    splits = [a.split(":") for a in alleles]
    prefix_len = 0
    for fields in zip(*splits):
        if len(set(fields)) == 1:
            prefix_len += 1
        else:
            break
    if prefix_len == 0:
        return list(alleles)
    return [":".join(splits[0][:prefix_len]) + " Partial"]


def parse_report_dir(in_dir):
    """{sample: {gene: [top alleles]}} over every .report in a directory."""
    calls = {}
    for fname in sorted(os.listdir(in_dir)):
        if not fname.endswith(".report"):
            continue
        sample = fname[:-len(".report")]
        ranked = parse_report(os.path.join(in_dir, fname))
        genes = {}
        for allele, ab in ranked:
            gene = allele.split("*")[0]
            genes.setdefault(gene, [])
            if len(genes[gene]) < 2 and ab >= 10.0:
                genes[gene].append(allele)
        calls[sample] = genes
    return calls


def to_csv(calls, path):
    with open(path, "w") as f:
        print("sample,gene,allele1,allele2", file=f)
        for sample, genes in sorted(calls.items()):
            for gene, alleles in sorted(genes.items()):
                row = [sample, gene] + alleles + [""] * (2 - len(alleles))
                print(",".join(row[:4]), file=f)
