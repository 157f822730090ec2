# Copy of hgtpu/utils/names.py.
"""Allele/gene name sort keys.

Ports of key_sortGene / key_sortAllele / sort_genall
(typing_common.py:112-152): genes sort by (letters, number); alleles by
gene key then the numeric parts of up to four colon-separated fields.
Used for deterministic reference-style ordering of sequence files and
report tie-breaks.
"""
from __future__ import annotations

import re


def key_sort_gene(x: str):
    digits = [c for c in x if c.isdigit()]
    chars = [c for c in x if not c.isdigit()]
    return ("".join(chars), int("".join(digits)) if digits else -1)


def key_sort_allele(x: str):
    gene, allele = x.split("*")
    gen, val = key_sort_gene(gene)
    fields = []
    for f in allele.split(":"):
        num = re.sub(r"[^0-9]", "", f)
        fields.append(int(num) if num else -1)
    while len(fields) < 4:
        fields.append(-1)
    return tuple([gen, val] + fields[:4])


def sort_genall(names, alleles=False):
    try:
        return sorted(names, key=key_sort_allele if alleles
                      else key_sort_gene)
    except (ValueError, IndexError):
        return sorted(names)
