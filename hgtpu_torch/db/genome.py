# Copy of hgtpu/db/genome.py.
"""Whole-genome ("genotype genome") construction.

Equivalent of hisatgenotype_tools/hisatgenotype_build_genome.py:46-521:
splice every family's backbone (consensus) into the host genome at its
locus, shift variant/haplotype coordinates into genome space, and write
the combined database:

  <out>.fa         spliced genome
  <out>.locus      family-tagged loci (genome format, read_locus isgenome
                   path: typing_common.py:279-309)
  <out>.snp/.index.snp/.haplotype/.link  coordinate-shifted tables
  <out>.coord      liftover segments (new_pos -> old_pos, length)
  <out>.allele/.partial  family-tagged allele lists
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from .catalog import Catalog, GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION

_VT_NAME = {VT_SINGLE: "single", VT_DELETION: "deletion",
            VT_INSERTION: "insertion"}


def build_genotype_genome(genome: dict, catalogs: dict, out_prefix: str,
                          external_vars: dict = None, clnsig: dict = None,
                          inter_gap: int = 30):
    """genome: {chrom: seq}; catalogs: {family: Catalog} whose genes carry
    chrom/chrom_left/chrom_right placements.  Returns the spliced genome
    dict (also written to <out_prefix>.fa).

    external_vars ({chrom: [(left, type, data, id)]} as produced by
    db.clinvar.read_vcf_variants / read_ucsc_common) are renumbered into
    spliced coordinates, clustered into haplotype windows, and written
    into the combined .snp/.index.snp/.haplotype tables; clnsig
    ({id: (gene, significance)}) rows land in <out>.clnsig — the
    reference's ClinVar/dbSNP import (build_genome.py:65-142, the
    add_vars interleave at :205-290, clnsig output :244-247).  Variants
    overlapping a spliced gene region are dropped, as the reference
    skips them (:231-234)."""
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    # genes grouped per chromosome, sorted by placement
    per_chrom = defaultdict(list)
    for family, cat in catalogs.items():
        for gene in cat.genes.values():
            per_chrom[gene.chrom].append((family, gene))
    for genes in per_chrom.values():
        genes.sort(key=lambda fg: fg[1].chrom_left)

    spliced = {}
    offsets = {}      # (family, gene) -> new left coordinate
    coord_lines = []
    segments = defaultdict(list)   # chrom -> (old_start, old_end, new_start)
    for chrom, seq in genome.items():
        parts = []
        cur = 0          # old coordinate
        new_pos = 0
        for family, gene in per_chrom.get(chrom, []):
            left, right = gene.chrom_left, gene.chrom_right
            assert left >= cur, "overlapping loci on %s" % chrom
            parts.append(seq[cur:left])
            coord_lines.append("%s\t%d\t%d\t%d"
                               % (chrom, new_pos, cur, left - cur))
            segments[chrom].append((cur, left, new_pos))
            new_pos += left - cur
            offsets[(family, gene.gene)] = new_pos
            parts.append(gene.backbone)
            new_pos += len(gene.backbone)
            cur = right
        parts.append(seq[cur:])
        coord_lines.append("%s\t%d\t%d\t%d"
                           % (chrom, new_pos, cur, len(seq) - cur))
        segments[chrom].append((cur, len(seq), new_pos))
        spliced[chrom] = "".join(parts)

    with open(out_prefix + ".fa", "w") as f:
        for chrom, seq in spliced.items():
            print(">%s" % chrom, file=f)
            for s in range(0, len(seq), 60):
                print(seq[s:s + 60], file=f)
    with open(out_prefix + ".coord", "w") as f:
        f.write("\n".join(coord_lines) + "\n")

    locus_f = open(out_prefix + ".locus", "w")
    snp_f = open(out_prefix + ".snp", "w")
    isnp_f = open(out_prefix + ".index.snp", "w")
    hap_f = open(out_prefix + ".haplotype", "w")
    link_f = open(out_prefix + ".link", "w")
    allele_f = open(out_prefix + ".allele", "w")
    partial_f = open(out_prefix + ".partial", "w")
    nh = 0
    for family, cat in catalogs.items():
        for gene in cat.genes.values():
            base = offsets[(family, gene.gene)]
            exon_str = ",".join(
                "%d-%d%s" % (l + base, r + base,
                             "p" if (l, r) in [tuple(e) for e in
                                               gene.primary_exons] else "")
                for l, r in gene.exons)
            print("%s\t%s\t%s\t%d\t%d\t%s\t%s"
                  % (family, gene.backbone_name, gene.chrom, base,
                     base + len(gene.backbone) - 1, exon_str, gene.strand),
                  file=locus_f)
            for i, vid in enumerate(gene.var_ids):
                line = "%s\t%s\t%s\t%d\t%s" % (
                    vid, _VT_NAME[int(gene.var_type[i])], gene.chrom,
                    base + int(gene.var_pos[i]), gene.var_data[i])
                print(line, file=snp_f)
                if gene.var_freq[i] >= gene.min_var_freq:
                    print(line, file=isnp_f)
                members = [gene.allele_names[a]
                           for a in np.flatnonzero(gene.links[i])]
                print("%s\t%s" % (vid, " ".join(sorted(members))),
                      file=link_f)
            for left, right, vidxs in gene.haplotypes:
                print("ht%d\t%s\t%d\t%d\t%s"
                      % (nh, gene.chrom, base + left, base + right,
                         ",".join(gene.var_ids[v] for v in vidxs)),
                      file=hap_f)
                nh += 1
            for name in gene.allele_names:
                print("%s\t%s" % (family, name), file=allele_f)
                if name in gene.partial:
                    print("%s\t%s" % (family, name), file=partial_f)

    # ---- external (ClinVar/dbSNP) variants: shift into spliced
    # coordinates, drop ones overlapping gene splices, emit haplotype
    # windows and clinical-significance rows ---- #
    if external_vars:
        from .clinvar import group_haplotypes

        clnsig = clnsig or {}
        clnsig_f = open(out_prefix + ".clnsig", "w")
        kept = defaultdict(list)    # chrom -> (new_left, type, data, id)
        for chrom, vars_ in external_vars.items():
            segs = segments.get(chrom, [])
            starts = [s for s, _e, _n in segs]
            for left, vtype, data, vid in vars_:
                right = left + int(data) - 1 if vtype == "deletion" \
                    else left
                si = np.searchsorted(starts, left, "right") - 1
                if si < 0:
                    continue
                old_s, old_e, new_s = segs[si]
                if right >= old_e:      # overlaps a gene splice: drop
                    continue
                kept[chrom].append((new_s + (left - old_s), vtype, data,
                                    vid))
        for chrom in sorted(kept):
            for new_left, vtype, data, vid in kept[chrom]:
                line = "%s\t%s\t%s\t%d\t%s" % (vid, vtype, chrom,
                                               new_left, data)
                print(line, file=snp_f)
                print(line, file=isnp_f)
                if vid in clnsig:
                    print("%s\t%s\t%s" % (vid, clnsig[vid][0],
                                          clnsig[vid][1]), file=clnsig_f)
        for chrom, hts in group_haplotypes(kept, inter_gap).items():
            for left, right, vids in hts:
                print("ht%d\t%s\t%d\t%d\t%s"
                      % (nh, chrom, left, right, ",".join(vids)),
                      file=hap_f)
                nh += 1
        clnsig_f.close()

    for f in (locus_f, snp_f, isnp_f, hap_f, link_f, allele_f, partial_f):
        f.close()
    return spliced, offsets


def region_gene(prefix: str, chrom: str, left: int, right: int,
                name: str = None):
    """Build a typable GeneRef for an arbitrary region of the genotype
    genome — the reference's `--base genome` region mode
    (typing_core.py:372-377, region locus lists).

    The region's backbone is the spliced genome slice; variants are the
    genotype-genome rows falling inside it (positions shifted to region
    coordinates) with their allele links restricted accordingly.
    """
    from collections import defaultdict

    from .catalog import GeneRef, _read_fasta

    genome = _read_fasta(prefix + ".fa")
    assert chrom in genome, chrom
    backbone = genome[chrom][left:right]
    vids, vtypes, vpos, vdata = [], [], [], []
    code = {"single": VT_SINGLE, "deletion": VT_DELETION,
            "insertion": VT_INSERTION}
    for line in open(prefix + ".snp"):
        vid, vt, vchrom, pos, data = line.rstrip("\n").split("\t")
        pos = int(pos)
        if vchrom != chrom or not (left <= pos < right):
            continue
        vids.append(vid)
        vtypes.append(code[vt])
        vpos.append(pos - left)
        vdata.append(data)
    # region may span several genes whose table blocks are not globally
    # position-sorted; sort now (GeneRef requires non-decreasing pos)
    order = sorted(range(len(vids)), key=lambda i: vpos[i])
    vids = [vids[i] for i in order]
    vtypes = [vtypes[i] for i in order]
    vpos = [vpos[i] for i in order]
    vdata = [vdata[i] for i in order]
    vid_set = set(vids)
    links_raw = {}
    for line in open(prefix + ".link"):
        parts = line.split()
        if parts[0] in vid_set:
            links_raw[parts[0]] = parts[1:]
    allele_names = sorted({a for vs in links_raw.values() for a in vs})
    aidx = {a: i for i, a in enumerate(allele_names)}
    links = np.zeros((len(vids), max(1, len(allele_names))), dtype=bool)
    for i, vid in enumerate(vids):
        for a in links_raw.get(vid, []):
            links[i, aidx[a]] = True
    if not allele_names:
        allele_names = ["GRCh38.ref"]
        links = np.zeros((len(vids), 1), dtype=bool)
    vlen = np.array(
        [int(d) if t == VT_DELETION else len(d)
         for d, t in zip(vdata, vtypes)], dtype=np.int32)
    region_name = name or "%s:%d-%d" % (chrom, left, right)
    return GeneRef(
        gene=region_name,
        backbone_name=region_name,
        backbone=backbone,
        allele_names=allele_names,
        var_ids=vids,
        var_type=np.array(vtypes, np.int8),
        var_pos=np.array(vpos, np.int32),
        var_len=vlen,
        var_data=vdata,
        var_freq=np.full(len(vids), 100.0, np.float32),
        links=links,
        exons=[(0, max(0, len(backbone) - 1))],
        primary_exons=[(0, max(0, len(backbone) - 1))],
        haplotypes=[],
        chrom=chrom,
        chrom_left=left,
        chrom_right=right,
    )


def liftover(coord_path):
    """Load the .coord liftover map: returns a function
    (chrom, new_pos) -> old_pos or None inside spliced gene regions."""
    segs = defaultdict(list)
    for line in open(coord_path):
        chrom, new_pos, old_pos, length = line.split()
        segs[chrom].append((int(new_pos), int(old_pos), int(length)))

    def f(chrom, pos):
        for new_pos, old_pos, length in segs.get(chrom, []):
            if new_pos <= pos < new_pos + length:
                return old_pos + (pos - new_pos)
        return None
    return f
