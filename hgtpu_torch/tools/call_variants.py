# Copy of hgtpu/tools/call_variants.py.
"""Variant caller: VCF output from typing evidence.

Equivalent of hisatgenotype_tools/hisatgenotype_call_variants.py
(component #21, partially implemented in the reference): emit the variants
supported by the read pileup — known catalog variants carried by the
called alleles plus novel variants observed with sufficient support — as
VCF 4.2 records against the backbone (or lifted to genome coordinates
via a .coord map).
"""
from __future__ import annotations

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION


def call_variants(gene: GeneRef, result, mpileup=None, min_ab=0.1,
                  min_novel_count=3):
    """result: GeneTypingResult.  Returns list of VCF record tuples
    (pos0, ref, alt, qual, info)."""
    called = [a for a, p in result.prob[:2] if p >= min_ab]
    records = []
    seen = set()
    for allele in called:
        gt_half = "1" if len(called) == 1 or called.count(allele) == 2 \
            else "0/1"
        for vi in gene.allele_var_indices(allele):
            if vi in seen:
                continue
            seen.add(vi)
            vt = int(gene.var_type[vi])
            pos = int(gene.var_pos[vi])
            if vt == VT_SINGLE:
                ref_a = gene.backbone[pos]
                alt_a = gene.var_data[vi]
                vpos = pos
            elif vt == VT_DELETION:
                dlen = int(gene.var_len[vi])
                vpos = pos - 1
                ref_a = gene.backbone[vpos:pos + dlen]
                alt_a = gene.backbone[vpos]
            else:
                vpos = pos - 1
                ref_a = gene.backbone[vpos]
                alt_a = gene.backbone[vpos] + gene.var_data[vi]
            hom = all(vi in set(gene.allele_var_indices(a)) for a in called)
            records.append((vpos, ref_a, alt_a, 60,
                            "ID=%s;TYPE=known" % gene.var_ids[vi],
                            "1/1" if hom else "0/1"))
    # novel variants with read support
    for vid, (vtype, pos, data) in (result.novel_vars or {}).items():
        if mpileup is not None and vtype == "single":
            base = "ACGTN".find(data)
            if base < 0 or mpileup.counts[pos, base] < min_novel_count:
                continue
        if vtype == "single":
            rec = (pos, gene.backbone[pos], data)
        elif vtype == "deletion":
            d = int(data)
            rec = (pos - 1, gene.backbone[pos - 1:pos + d],
                   gene.backbone[pos - 1])
        else:
            rec = (pos - 1, gene.backbone[pos - 1],
                   gene.backbone[pos - 1] + data)
        records.append((*rec, 30, "ID=%s;TYPE=novel" % vid, "./."))
    records.sort(key=lambda r: r[0])
    return records


def write_vcf(path, gene: GeneRef, records, sample="sample"):
    with open(path, "w") as f:
        print("##fileformat=VCFv4.2", file=f)
        print("##source=hgtpu", file=f)
        print("##contig=<ID=%s,length=%d>"
              % (gene.backbone_name, len(gene.backbone)), file=f)
        print('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
              file=f)
        print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t%s"
              % sample, file=f)
        for pos0, ref_a, alt_a, qual, info, gt in records:
            vid = info.split("ID=")[1].split(";")[0]
            print("%s\t%d\t%s\t%s\t%s\t%d\tPASS\t%s\tGT\t%s"
                  % (gene.backbone_name, pos0 + 1, vid, ref_a, alt_a, qual,
                     info, gt), file=f)
