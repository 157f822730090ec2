# Copy of hgtpu/db/clinvar.py, only group_haplotypes (the VCF and UCSC
# parsers wait for the CLI).
"""External variant import: haplotype windows of external variants,
as db.genome.build_genotype_genome splices them into the output
coordinates (the reference's hisatgenotype_build_genome.py:205-290).
"""
from __future__ import annotations


def group_haplotypes(vars_per_chrom, inter_gap: int = 30):
    """Cluster nearby external variants into haplotype windows:
    consecutive variants whose span gap is <= inter_gap share a window
    (the same inter-gap rule db.build applies,
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
