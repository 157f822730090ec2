# Copy of hgtpu/tools/rbg.py.
"""Red-blood-group (RBG) database ingestion from GenBank flat files.

Equivalent of hisatgenotype_tools/hisatgenotype_extract_RBG.py: the
reference fetches NCBI nuccore records per allele accession
(get_seqbyRef, extract_RBG.py:94-198), slices each record to the named
gene, collects its mRNA/CDS exon ranges, then multiple-aligns the allele
sequences into MSF files (write_msf, :266-436, via clustalo).

Offline equivalent: parse the same GenBank flat-file format from local
files — multi-record (``//``-separated), multi-line ``join(...)`` exon
lists, ``/gene`` qualifiers, per-exon ``/number`` labels — and build the
MSA with a reference-anchored alignment (each allele globally aligned to
the first record; insertion columns merged), replacing the clustalo
subprocess with an in-process DP.
"""
from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

_RANGE = re.compile(r"[<>]?(\d+)\.\.[<>]?(\d+)")


def split_records(text: str):
    """A GenBank flat file may concatenate many records, each closed by
    a ``//`` line (extract_RBG.py:119-120 stops at ``//``)."""
    recs = []
    cur = []
    for line in text.splitlines():
        if line.startswith("//"):
            if cur:
                recs.append("\n".join(cur))
            cur = []
        else:
            cur.append(line)
    if any(l.strip() for l in cur):
        recs.append("\n".join(cur))
    return recs


def parse_record(rec: str):
    """One GenBank record -> dict(accession, seq, genes, exons).

    genes: {gene: (left, right)} 0-based half-open record coordinates;
    exons: {gene: [(number, left, right)]} — from explicit ``exon``
    features when every one carries ``/number`` (the reference prefers
    the given numbers, extra_RBG.py:175-186), else from the first
    mRNA/CDS ``join(...)`` list numbered 1..n.
    """
    accession = ""
    seq_parts = []
    in_origin = False
    genes = {}
    exon_spans = []          # (left, right) of exon features, in order
    exon_numbers = []
    join_exons = {}          # gene -> [(l, r)] from mRNA/CDS join
    cur_gene_range = None    # (l, r) of the gene feature awaiting /gene
    cur_gene = None          # gene the following features belong to
    pending_join = None      # accumulating multi-line join(...) text
    for raw in rec.splitlines():
        line = raw.strip()
        if not line:
            continue
        if in_origin:
            seq_parts.append(re.sub(r"[\d\s/]", "", line).upper())
            continue
        if line.startswith("ORIGIN"):
            in_origin = True
            continue
        if raw.startswith("LOCUS"):
            accession = line.split()[1]
            continue
        if pending_join is not None:
            pending_join += line
            if pending_join.count("(") <= pending_join.count(")"):
                spans = [(int(l) - 1, int(r))
                         for l, r in _RANGE.findall(pending_join)]
                if cur_gene and cur_gene not in join_exons:
                    join_exons[cur_gene] = spans
                pending_join = None
            continue
        if line.startswith("gene "):
            m = _RANGE.search(line)
            if m:
                cur_gene_range = (int(m.group(1)) - 1, int(m.group(2)))
                cur_gene = None
            continue
        if line.startswith("/gene=") and cur_gene_range:
            name = line.split("=", 1)[1].strip('"')
            if name not in genes:
                genes[name] = cur_gene_range
            cur_gene = name
            continue
        if (line.startswith("mRNA ") or line.startswith("CDS ")) \
                and cur_gene:
            body = line.split(None, 1)[1]
            if "(" in body and body.count("(") > body.count(")"):
                pending_join = body
            else:
                spans = [(int(l) - 1, int(r))
                         for l, r in _RANGE.findall(body)]
                if cur_gene not in join_exons:
                    join_exons[cur_gene] = spans
            continue
        if line.startswith("exon "):
            m = _RANGE.search(line)
            if m:
                exon_spans.append((int(m.group(1)) - 1, int(m.group(2))))
            continue
        if "/number=" in line and exon_spans and \
                len(exon_numbers) < len(exon_spans):
            exon_numbers.append(line.split("=", 1)[1].strip('"'))
            continue

    seq = "".join(seq_parts)
    exons = {}
    for gene, (gl, _gr) in genes.items():
        spans = join_exons.get(gene, [])
        use_given = len(exon_numbers) == len(exon_spans) == len(spans)
        exons[gene] = [
            (exon_numbers[i] if use_given else str(i + 1),
             l - gl, r - gl)
            for i, (l, r) in enumerate(spans)]
    return dict(accession=accession, seq=seq, genes=genes, exons=exons)


def gene_slice(record: dict, gene: str):
    """(sequence of the gene span, its exon list) — the getall path of
    get_seqbyRef (extract_RBG.py:173-192)."""
    if gene not in record["genes"]:
        raise KeyError("gene %s not in record %s"
                       % (gene, record["accession"]))
    left, right = record["genes"][gene]
    return record["seq"][left:right], record["exons"].get(gene, [])


def _align_ops(ref: str, seq: str):
    """Global edit alignment (unit costs) of seq against ref; returns
    per-ref-position allele bases plus insertion strings keyed by the
    ref position they precede."""
    n, m = len(ref), len(seq)
    a = np.frombuffer(ref.encode(), np.uint8)
    b = np.frombuffer(seq.encode(), np.uint8)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[0] = np.arange(m + 1)
    ramp = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        prev = dp[i - 1]
        cur = dp[i]
        cur[0] = i
        np.minimum(prev[:-1] + (b != a[i - 1]), prev[1:] + 1, out=cur[1:])
        # left (insertion) dependency, vectorized:
        # cur[j] = min_{k<=j} cur0[k] + (j-k)  ==  prefix-min of cur0-k, +j
        cur -= ramp
        np.minimum.accumulate(cur, out=cur)
        cur += ramp
    cols = [""] * n          # aligned base per ref position ('.' = del)
    ins = defaultdict(str)   # ref position -> inserted sequence before it
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                dp[i][j] == dp[i - 1][j - 1] + (ref[i - 1] != seq[j - 1]):
            cols[i - 1] = seq[j - 1]
            i -= 1
            j -= 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            cols[i - 1] = "."
            i -= 1
        else:
            ins[i] = seq[j - 1] + ins[i]
            j -= 1
    return cols, ins


def msa_from_sequences(seqs: dict):
    """{allele: sequence} -> (names, rows): every allele globally
    aligned to the first entry (the reference record), insertion columns
    merged across alleles — the offline stand-in for the clustalo MSF
    build (extract_RBG.py:252-436)."""
    names = list(seqs)
    ref = seqs[names[0]]
    aligned = {names[0]: (list(ref), {})}
    for name in names[1:]:
        aligned[name] = _align_ops(ref, seqs[name])
    ins_len = defaultdict(int)
    for cols, ins in aligned.values():
        for p, s in ins.items():
            ins_len[p] = max(ins_len[p], len(s))
    rows = []
    for name in names:
        cols, ins = aligned[name]
        row = []
        for p in range(len(ref) + 1):
            if p in ins_len:
                s = ins.get(p, "")
                row.append(s + "." * (ins_len[p] - len(s)))
            if p < len(ref):
                row.append(cols[p])
        rows.append("".join(row))
    return names, rows


def convert_rbg_genbank(paths, gene: str, allele_names=None):
    """GenBank flat files (possibly multi-record) -> (names, rows, exons)
    for `gene`: record 0 is the reference allele; exon coordinates are
    reported against it."""
    records = []
    for path in paths:
        records.extend(parse_record(r)
                       for r in split_records(open(path).read()))
    records = [r for r in records if gene in r["genes"]]
    if not records:
        raise ValueError("no record carries gene %s" % gene)
    seqs = {}
    exons = None
    for k, rec in enumerate(records):
        seq, ex = gene_slice(rec, gene)
        name = (allele_names[k] if allele_names
                else "%s*%s" % (gene, rec["accession"] or str(k + 1)))
        seqs[name] = seq
        if exons is None and ex:
            exons = [(l, r - 1) for _n, l, r in ex]
    names, rows = msa_from_sequences(seqs)
    return names, rows, exons or []
