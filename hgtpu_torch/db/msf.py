# Copy of hgtpu/db/msf.py.
"""MSF multiple-alignment reader.

Parses GCG MSF files as used by IMGT/HLA ("*_gen.msf", "*_nuc.msf").
Ref behavior: read_MSF_file (hisatgenotype_typing_common.py:425-488) —
"Name" header lines register alleles; body lines append sequence chunks.
Returns allele names in first-seen order plus the alignment rows.
"""
from __future__ import annotations


def read_msf(path_or_lines, left_ext: str = "", right_ext: str = ""):
    """Return (names: dict name->row index, rows: list[str])."""
    if isinstance(path_or_lines, str):
        lines = open(path_or_lines)
    else:
        lines = path_or_lines
    names = {}
    rows = []
    for line in lines:
        line = line.strip()
        if (not line or not line[0].isalnum()
                or line.startswith("MSF") or line.startswith("PileUp")):
            continue
        if line.startswith("Name"):
            try:
                name = line.split("\t")[0].split()[1]
            except (ValueError, IndexError):
                continue
            if name in names:
                continue
            names[name] = len(names)
        else:
            cols = line.split()
            if len(cols) < 2:
                continue
            name, chunks = cols[0], cols[1:]
            if not rows:
                rows = [left_ext for _ in range(len(names))]
            if name not in names:
                names[name] = len(names)
            idx = names[name]
            if idx >= len(rows):
                rows.append(left_ext)
            rows[idx] += "".join(chunks)
    if right_ext:
        rows = [r + right_ext for r in rows]
    return names, rows
