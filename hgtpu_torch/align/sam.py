# Copy of hgtpu/align/sam.py.
"""SAM interop: export ReadAln records as SAM, and import SAM back.

The reference's entire data plane is SAM text through samtools pipes
(component #5, typing_common.py:1038-1056).  hgtpu keeps alignments
in memory, but emits/consumes the same SAM representation — including
HISAT2's Zs known-variant annotation (format `offset|S/I/D|varID`,
consumed at typing_core.py:876-944) — so reference tooling and ours
interoperate.
"""
from __future__ import annotations

import re as _re

import numpy as np

from ..db.catalog import GeneRef


def aln_to_sam_fields(gene: GeneRef, aln, novel_ids=None):
    """One ReadAln -> (cigar, md, zs, nm) strings."""
    cigar = []
    md = []
    zs = []
    md_match = 0
    nm = 0
    read_pos = 0
    zs_prev_end = 0   # read offset after the last Zs event
    n_m = 0           # current CIGAR M run

    def flush_m():
        nonlocal n_m
        if n_m:
            cigar.append("%dM" % n_m)
            n_m = 0

    for entry in aln.cmp:
        kind, pos, length = entry[0], entry[1], entry[2]
        var_idx = entry[3] if len(entry) > 3 else None
        data = entry[4] if len(entry) > 4 else ""
        if kind == "match":
            n_m += length
            md_match += length
            read_pos += length
        elif kind == "mismatch":
            n_m += 1
            md.append("%d%s" % (md_match, gene.backbone[pos]))
            md_match = 0
            if var_idx is not None and var_idx >= 0:
                zs.append("%d|S|%s" % (read_pos - zs_prev_end,
                                       gene.var_ids[var_idx]))
                zs_prev_end = read_pos + 1
            else:
                nm += 1
            read_pos += 1
        elif kind == "deletion":
            flush_m()
            cigar.append("%dD" % length)
            md.append("%d^%s" % (md_match, gene.backbone[pos:pos + length]))
            md_match = 0
            if var_idx is not None and var_idx >= 0:
                zs.append("%d|D|%s" % (read_pos - zs_prev_end,
                                       gene.var_ids[var_idx]))
                zs_prev_end = read_pos
            else:
                nm += length
        else:  # insertion
            flush_m()
            cigar.append("%dI" % length)
            if var_idx is not None and var_idx >= 0:
                zs.append("%d|I|%s" % (read_pos - zs_prev_end,
                                       gene.var_ids[var_idx]))
                zs_prev_end = read_pos + length
            else:
                nm += length
            read_pos += length
    flush_m()
    md.append(str(md_match))
    return "".join(cigar), "".join(md), ",".join(zs), nm


def write_sam(path, gene: GeneRef, alns_by_read, rg_sample="hgtpu"):
    """alns_by_read: iterable of (read_id, [ReadAln])."""
    with open(path, "w") as f:
        print("@HD\tVN:1.6\tSO:queryname", file=f)
        print("@SQ\tSN:%s\tLN:%d" % (gene.backbone_name, len(gene.backbone)),
              file=f)
        print("@PG\tID:hgtpu\tPN:hgtpu", file=f)
        for read_id, alns in alns_by_read:
            alns = [a for a in alns if a is not None]
            for a in alns:
                flag = 0
                if len(alns) > 1:
                    flag |= 0x1 | 0x2
                    flag |= 0x40 if a.mate == "L" else 0x80
                if a.is_rc:
                    flag |= 0x10
                cigar, md, zs, nm = aln_to_sam_fields(gene, a)
                opt = "NM:i:%d\tMD:Z:%s\tNH:i:1" % (nm, md)
                if zs:
                    opt += "\tZs:Z:%s" % zs
                print("%s\t%d\t%s\t%d\t60\t%s\t*\t0\t0\t%s\t%s\t%s"
                      % (read_id, flag, gene.backbone_name, a.pos + 1, cigar,
                         a.seq, "I" * len(a.seq), opt), file=f)


def parse_sam_line(gene: GeneRef, line):
    """SAM line -> ReadAln-equivalent dict (pos, cigar ops, tags).

    Provides the reference's decode path (typing_core.py:805-844) for
    SAM produced by hisat2 or hgtpu.
    """
    cols = line.rstrip("\n").split("\t")
    read_id, flag, rname, pos, _mapq, cigar = cols[:6]
    seq = cols[9]
    tags = {}
    for col in cols[11:]:
        k, _t, v = col.split(":", 2)
        tags[k] = v
    return dict(read_id=read_id, flag=int(flag), rname=rname,
                pos=int(pos) - 1, cigar=cigar, seq=seq, tags=tags)


_CIGAR_RE = _re.compile(r"(\d+)([MIDNSH])")
_MD_RE = _re.compile(r"(\d+)|\^([A-Z]+)|([A-Z])")


def sam_to_readaln(gene: GeneRef, rec, num_editdist=2):
    """Decode one parsed SAM record into a ReadAln.

    Literal port of the reference's CIGAR+MD+Zs walk
    (typing_core.py:876-1124): M runs split at MD mismatches, each
    mismatch/indel resolved against the Zs known-variant annotations or
    looked up in the catalog; soft clips trimmed as the reference does
    (:1097-1107).  Returns None for unmapped/filtered records.
    """
    from ..align.types import ReadAln
    from ..utils.dna import encode_seq

    flag = rec["flag"]
    if flag & 0x4:
        return None
    pos = rec["pos"]
    seq = rec["seq"]
    tags = rec["tags"]
    nm = int(tags.get("NM", "0"))
    nh = int(tags.get("NH", "1"))
    if nh > 1:
        return None

    cigars = [(op, int(n)) for n, op in _CIGAR_RE.findall(rec["cigar"])]
    # strip soft clips
    if cigars and cigars[0][0] == "S":
        seq = seq[cigars[0][1]:]
        cigars = cigars[1:]
    if cigars and cigars[-1][0] == "S":
        seq = seq[: -cigars[-1][1]]
        cigars = cigars[:-1]

    # MD events: list of (matched-run, mismatched ref base | ^deletion)
    md_events = _MD_RE.findall(tags.get("MD", ""))
    zs_events = []
    if tags.get("Zs"):
        for ev in tags["Zs"].split(","):
            off, typ, vid = ev.split("|")
            zs_events.append([int(off), typ, vid])
    zs_i = 0
    zs_pos = zs_events[0][0] if zs_events else -1

    cmp = []
    read_pos = 0
    ref_pos = pos
    md_i = 0
    md_run = 0  # remaining matched bases from MD

    def take_md_run():
        nonlocal md_i, md_run
        while md_i < len(md_events) and md_run == 0:
            num, dele, sub = md_events[md_i]
            if num != "":
                md_run += int(num)
                md_i += 1
                if md_run == 0:
                    continue
            else:
                break

    def next_zs(consumed):
        nonlocal zs_i, zs_pos
        zs_i += 1
        if zs_i < len(zs_events):
            zs_pos = zs_pos + consumed + zs_events[zs_i][0]

    for op, length in cigars:
        if op == "M":
            left = length
            while left > 0:
                take_md_run()
                if md_run >= left:
                    cmp.append(("match", ref_pos, left, None, ""))
                    md_run -= left
                    read_pos += left
                    ref_pos += left
                    left = 0
                    break
                if md_run > 0:
                    cmp.append(("match", ref_pos, md_run, None, ""))
                    read_pos += md_run
                    ref_pos += md_run
                    left -= md_run
                    md_run = 0
                # mismatch at current position
                num, dele, sub = md_events[md_i]
                assert sub != "", "MD desync"
                md_i += 1
                base = seq[read_pos]
                var_idx = -1
                if zs_i < len(zs_events) and read_pos == zs_pos \
                        and zs_events[zs_i][1] == "S":
                    vid = zs_events[zs_i][2]
                    if vid in gene._id2idx:
                        var_idx = gene.var_index(vid)
                    next_zs(1)
                else:
                    # catalog lookup (ref: typing_core.py:946-961)
                    vi = np.searchsorted(gene.var_pos, ref_pos, "left")
                    while vi < gene.n_vars and gene.var_pos[vi] == ref_pos:
                        if int(gene.var_type[vi]) == 0 \
                                and gene.var_data[vi] == base:
                            var_idx = vi
                            break
                        vi += 1
                cmp.append(("mismatch", ref_pos, 1, var_idx, base))
                read_pos += 1
                ref_pos += 1
                left -= 1
        elif op == "D":
            var_idx = -1
            if zs_i < len(zs_events) and read_pos == zs_pos \
                    and zs_events[zs_i][1] == "D":
                vid = zs_events[zs_i][2]
                if vid in gene._id2idx:
                    var_idx = gene.var_index(vid)
                next_zs(0)
            else:
                vi = np.searchsorted(gene.var_pos, ref_pos, "left")
                while vi < gene.n_vars and gene.var_pos[vi] == ref_pos:
                    if int(gene.var_type[vi]) == 1 \
                            and int(gene.var_len[vi]) == length:
                        var_idx = vi
                        break
                    vi += 1
            cmp.append(("deletion", ref_pos, length, var_idx, str(length)))
            # consume MD deletion event
            take_md_run()
            if md_i < len(md_events) and md_events[md_i][1] != "":
                md_i += 1
            ref_pos += length
        elif op == "I":
            data = seq[read_pos:read_pos + length]
            var_idx = -1
            if zs_i < len(zs_events) and read_pos == zs_pos \
                    and zs_events[zs_i][1] == "I":
                vid = zs_events[zs_i][2]
                if vid in gene._id2idx:
                    var_idx = gene.var_index(vid)
                next_zs(length)
            else:
                vi = np.searchsorted(gene.var_pos, ref_pos, "left")
                while vi < gene.n_vars and gene.var_pos[vi] == ref_pos:
                    if int(gene.var_type[vi]) == 2 \
                            and len(gene.var_data[vi]) == length:
                        var_idx = vi
                        break
                    vi += 1
            cmp.append(("insertion", ref_pos, length, var_idx, data))
            read_pos += length
        elif op == "N":
            ref_pos += length

    if ref_pos > len(gene.backbone):
        return None
    mate = "L" if flag & 0x40 else ("R" if flag & 0x80 else "U")
    codes = encode_seq(seq)
    return ReadAln(read_id=rec["read_id"], mate=mate, pos=pos, right=ref_pos,
                   cmp=cmp, nm=nm, is_rc=bool(flag & 0x10), seq=seq,
                   codes=codes)


def read_sam(gene: GeneRef, path, num_editdist=2):
    """SAM file -> [(read_id, [ReadAln])] grouped by read id (the
    reference's sort -k1,1 grouping, typing_core.py:463-468)."""
    from collections import defaultdict

    by_read = defaultdict(list)
    for line in open(path):
        if line.startswith("@"):
            continue
        rec = parse_sam_line(gene, line)
        aln = sam_to_readaln(gene, rec, num_editdist)
        if aln is not None:
            by_read[aln.read_id.split("|")[0]].append(aln)
    return sorted(by_read.items(), key=lambda kv: kv[0])
