# Copy of hgtpu/tools/starallele.py.
"""Star-allele (CYP) and blood-group (RBG) database conversion.

Equivalents of hisatgenotype_extract_cyp_data.py (#23) and
hisatgenotype_extract_RBG.py (#24): both reference tools scrape remote
databases and render per-allele variant lists against a reference
sequence into MSF alignments.  Offline, the same conversion runs from
local variant tables:

  <allele name> <tab> <comma-separated events>
  events: <pos><ref>><alt>    SNP        e.g. 100A>G
          <pos>del<len>       deletion   e.g. 230del2
          <pos>ins<SEQ>       insertion  e.g. 58insTT

Positions are 0-based against the supplied reference sequence; the
reference tool's NT-position validation (checkNTloc,
extract_cyp_data.py:184) is enforced for SNPs.
"""
from __future__ import annotations

import re
from collections import defaultdict

_SNP = re.compile(r"^(\d+)([ACGT])>([ACGT])$")
_DEL = re.compile(r"^(\d+)del(\d+)$")
_INS = re.compile(r"^(\d+)ins([ACGT]+)$")


def parse_events(s: str):
    events = []
    for tok in s.split(","):
        tok = tok.strip()
        if not tok or tok == "ref":
            continue
        m = _SNP.match(tok)
        if m:
            events.append(("S", int(m.group(1)), m.group(2), m.group(3)))
            continue
        m = _DEL.match(tok)
        if m:
            events.append(("D", int(m.group(1)), int(m.group(2)), None))
            continue
        m = _INS.match(tok)
        if m:
            events.append(("I", int(m.group(1)), m.group(2), None))
            continue
        raise ValueError("bad event: %r" % tok)
    return events


def msa_from_variant_table(refseq: str, allele_events: dict):
    """{allele: [events]} -> (names, rows) MSA including the reference
    allele as the first row."""
    # insertion slots: pos -> max inserted length
    ins_len = defaultdict(int)
    for events in allele_events.values():
        for ev in events:
            if ev[0] == "I":
                ins_len[ev[1]] = max(ins_len[ev[1]], len(ev[2]))
    names = []
    rows = []
    for name, events in allele_events.items():
        snp = {}
        dele = set()
        ins = {}
        for ev in events:
            kind, pos = ev[0], ev[1]
            if kind == "S":
                assert refseq[pos] == ev[2], \
                    "NT validation failed for %s at %d" % (name, pos)
                snp[pos] = ev[3]
            elif kind == "D":
                dele.update(range(pos, pos + ev[2]))
            else:
                ins[pos] = ev[2]
        row = []
        for p in range(len(refseq) + 1):
            if p in ins_len:
                i_seq = ins.get(p, "")
                row.append(i_seq + "." * (ins_len[p] - len(i_seq)))
            if p == len(refseq):
                break
            if p in dele:
                row.append(".")
            else:
                row.append(snp.get(p, refseq[p]))
        names.append(name)
        rows.append("".join(row))
    return names, rows


def convert_star_table(path, refseq: str):
    allele_events = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        name = parts[0]
        events = parse_events(parts[1]) if len(parts) > 1 else []
        allele_events[name] = events
    return msa_from_variant_table(refseq, allele_events)


# ---- CYP star-nomenclature notation (cDNA-relative coordinates) ---- #
#
# CYP allele tables (cypalleles.ki.se scrapes) report variants against
# cDNA numbering: 1-based downstream of the transcription start, negative
# upstream (no position 0).  The genomic reference the MSA is built on
# starts elsewhere, so the converter must *discover* the offset between
# the two frames; the reference brute-force slides every offset and keeps
# the one where the annotated reference bases agree with the sequence
# (checkNTloc, extract_cyp_data.py:184-313).

_CYP_SNP = re.compile(r"^(-?\d+)([ACGT])>([ACGT])$")
_CYP_DEL = re.compile(r"^(-?\d+)(?:_(-?\d+))?del([ACGT]+)$")
_CYP_INS = re.compile(r"^(-?\d+)(?:_(-?\d+))?ins([ACGT]+)$")


def parse_cyp_events(s: str):
    """'100A>G;-1584C>G;120_122delTAC;58insTT' (';' or ',' separated) ->
    [("S", pos, ref, alt) | ("D", start, end, seq) | ("I", pos, seq)],
    positions in signed cDNA numbering."""
    events = []
    for tok in re.split("[;,]", s):
        tok = tok.strip()
        if not tok or tok.lower() in ("ref", "none"):
            continue
        m = _CYP_SNP.match(tok)
        if m:
            events.append(("S", int(m.group(1)), m.group(2), m.group(3)))
            continue
        m = _CYP_DEL.match(tok)
        if m:
            start = int(m.group(1))
            end = int(m.group(2)) if m.group(2) else start
            events.append(("D", start, end, m.group(3)))
            continue
        m = _CYP_INS.match(tok)
        if m:
            events.append(("I", int(m.group(1)), m.group(3)))
            continue
        raise ValueError("bad CYP event: %r" % tok)
    return events


def _expected_bases(allele_events):
    """Signed cDNA position -> annotated reference base, split into
    positive- and negative-frame sets (insertions carry no reference
    base and are skipped, as in checkNTloc)."""
    pos_frame, neg_frame = {}, {}
    for events in allele_events.values():
        for ev in events:
            if ev[0] == "S":
                (pos_frame if ev[1] > 0 else neg_frame)[ev[1]] = ev[2]
            elif ev[0] == "D":
                start, end, seq = ev[1], ev[2], ev[3]
                span = [p for p in range(start, end + 1) if p != 0]
                if len(span) != len(seq):
                    continue    # malformed row: skip, as the reference does
                for p, base in zip(span, seq):
                    (pos_frame if p > 0 else neg_frame)[p] = base
    return pos_frame, neg_frame


def find_cyp_offset(refseq: str, allele_events: dict):
    """Slide every offset of the positive cDNA frame against `refseq`
    and keep the best-scoring one; the negative frame sits at offset+1
    because cDNA numbering skips 0 (checkNTloc,
    extract_cyp_data.py:253-313).

    Returns (oset_pos, oset_neg, frac_pos, frac_neg, frac_total).
    """
    pos_frame, neg_frame = _expected_bases(allele_events)
    L = len(refseq)
    best_off, best_hits = 0, -1
    for off in range(-L, L):
        hits = 0
        for p, base in pos_frame.items():
            i = p + off
            if 0 <= i < L and refseq[i] == base:
                hits += 1
        if hits > best_hits:
            best_off, best_hits = off, hits
    oset_neg = best_off + 1
    neg_hits = sum(1 for p, base in neg_frame.items()
                   if 0 <= p + oset_neg < L and refseq[p + oset_neg] == base)
    frac_pos = best_hits / len(pos_frame) if pos_frame else 1.0
    frac_neg = neg_hits / len(neg_frame) if neg_frame else 1.0
    denom = len(pos_frame) + len(neg_frame)
    frac_total = (best_hits + neg_hits) / denom if denom else 1.0
    return best_off, oset_neg, frac_pos, frac_neg, frac_total


def cyp_to_zero_based(events, oset_pos: int, oset_neg: int):
    """Signed cDNA events -> the converter's 0-based event tuples."""
    def shift(p):
        return p + (oset_pos if p > 0 else oset_neg)

    out = []
    for ev in events:
        if ev[0] == "S":
            out.append(("S", shift(ev[1]), ev[2], ev[3]))
        elif ev[0] == "D":
            start = shift(ev[1])
            end = shift(ev[2])
            out.append(("D", start, end - start + 1, None))
        else:
            out.append(("I", shift(ev[1]), ev[2], None))
    return out


def convert_cyp_table(path, refseq: str, min_score: float = 0.95):
    """CYP star-allele table (allele <TAB> cDNA-notation events) ->
    (names, rows) MSA, after offset discovery + NT validation.

    Raises ValueError when fewer than `min_score` of the annotated
    reference bases agree at the best offset (the gene would silently
    mis-map, which checkNTloc guards against)."""
    allele_events = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        allele_events[parts[0]] = \
            parse_cyp_events(parts[1]) if len(parts) > 1 else []
    oset_pos, oset_neg, _fp, _fn, frac = \
        find_cyp_offset(refseq, allele_events)
    if frac < min_score:
        raise ValueError(
            "CYP offset validation failed: best offset %d matches only "
            "%.0f%% of annotated reference bases" % (oset_pos, frac * 100))
    shifted = {name: cyp_to_zero_based(evs, oset_pos, oset_neg)
               for name, evs in allele_events.items()}
    return msa_from_variant_table(refseq, shifted)
