# Copy of hgtpu/tools/codis.py.
"""CODIS STR database converter.

Equivalent of hisatgenotype_tools/hisatgenotype_convert_codis.py: turn STR
repeat-structure tables (NIST STRBase-style bracket notation, e.g.
"[TCTA]5 [TCTG]3 TCA [TCTA]9") into an MSF-style multiple alignment ready
for the DB compiler.

Allele structures are merged with a repeat-aware global block alignment —
the same mechanism as the reference's SW_alignment/combine_alleles/
msf_alignment trio (convert_codis.py:283-401): blocks carrying the same
repeat unit align at no cost regardless of copy number, two distinct
single-copy literals may pair as a substitution column, gaps cost -1.
The merged backbone accumulates every unit/copy-number observed; each
allele is then re-aligned against it and emitted with '.' padding to the
block width.

Input table format (TSV): <allele name> <tab> <structure>
Flanking sequences are supplied separately (the reference pulls them from
GRCh38 via samtools faidx, :186).
"""
from __future__ import annotations

import re

_TOKEN = re.compile(r"\[([ACGT]+)\](\d+)|([ACGT]+)")


def parse_structure(s: str):
    """'[TCTA]3 TCA [TCTG]2' -> [("TCTA", 3), ("TCA", 1), ("TCTG", 2)]."""
    out = []
    for m in _TOKEN.finditer(s.replace(" ", "")):
        if m.group(1):
            out.append((m.group(1), int(m.group(2))))
        else:
            out.append((m.group(3), 1))
    return out


def _pair_score(units_i, counts_i, unit_j, count_j):
    """Block-pair score for the repeat-aware alignment.

    Same repeat unit aligns free of charge whatever the copy numbers
    (the reference zeroes its experimental copy-count penalty,
    convert_codis.py:259-277); two distinct single-copy literal blocks
    may pair as a substitution column (-1); anything else (-2) is worse
    than an indel pair so it gaps instead."""
    if unit_j in units_i:
        return 0
    # count 0 only marks alleles that skip the block — it doesn't stop
    # the column being a single-copy literal
    if counts_i <= {0, 1} and count_j == 1:
        return -1
    return -2


def _block_align(backbone, blocks):
    """Global alignment of allele `blocks` [(unit, count)] against
    `backbone` [[units set, counts set]]; gap = -1.

    Returns the traceback as [(i|None, j|None)] pairs over backbone and
    allele block indices, in left-to-right order."""
    n, m = len(backbone), len(blocks)
    score = [[-(i + j) if i == 0 or j == 0 else 0
              for j in range(m + 1)] for i in range(n + 1)]
    for i in range(n):
        units_i, counts_i = backbone[i]
        for j in range(m):
            unit_j, count_j = blocks[j]
            s = _pair_score(units_i, counts_i, unit_j, count_j)
            score[i + 1][j + 1] = max(score[i][j + 1] - 1,
                                      score[i + 1][j] - 1,
                                      score[i][j] + s)
    path = []
    i, j = n - 1, m - 1
    while i >= 0 or j >= 0:
        if j < 0:
            path.append((i, None))
            i -= 1
        elif i < 0:
            path.append((None, j))
            j -= 1
        elif score[i][j + 1] - 1 == score[i + 1][j + 1]:
            path.append((i, None))
            i -= 1
        elif score[i + 1][j] - 1 == score[i + 1][j + 1]:
            path.append((None, j))
            j -= 1
        else:
            path.append((i, j))
            i -= 1
            j -= 1
    path.reverse()
    return path


def merge_structures(structs):
    """Fold every allele's block list into one backbone layout
    [[units set, counts set]] — count 0 marks alleles that skip the
    block (ref combine_alleles, convert_codis.py:300-345)."""
    backbone = []
    for blocks in structs:
        if not backbone:
            backbone = [[{u}, {c}] for u, c in blocks]
            continue
        merged = []
        for i, j in _block_align(backbone, blocks):
            if j is None:
                units, counts = backbone[i]
                merged.append([set(units), counts | {0}])
            elif i is None:
                unit, count = blocks[j]
                merged.append([{unit}, {count, 0}])
            else:
                units, counts = backbone[i]
                unit, count = blocks[j]
                merged.append([units | {unit}, counts | {count}])
        backbone = merged
    return backbone


def _block_width(units, counts):
    return max(len(u) for u in units) * max(counts)


def _emit_row(backbone, blocks):
    """One MSA row: the allele's blocks aligned to the merged backbone,
    '.'-padded to each block's width (ref msf_alignment,
    convert_codis.py:347-401)."""
    parts = []
    for i, j in _block_align(backbone, blocks):
        assert i is not None, "allele block outside merged backbone"
        units, counts = backbone[i]
        width = _block_width(units, counts)
        if j is None:
            parts.append("." * width)
        else:
            unit, count = blocks[j]
            seq = unit * count
            parts.append(seq + "." * (width - len(seq)))
    return "".join(parts)


def codis_msa(table, flank5="", flank3=""):
    """table: [(allele_name, structure string)] ->
    (names, msa rows) with '.' padding aligning repeat blocks."""
    names = [n for n, _ in table]
    structs = [parse_structure(s) for _, s in table]
    backbone = merge_structures(structs)
    rows = [flank5 + _emit_row(backbone, blocks) + flank3
            for blocks in structs]
    return names, rows


def convert_codis_table(path, flank5="", flank3=""):
    table = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, struct = line.split("\t")[:2]
        table.append((name, struct))
    return codis_msa(table, flank5, flank3)
