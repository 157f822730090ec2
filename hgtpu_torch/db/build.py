# Copy of hgtpu/db/build.py.
"""Graph-reference compiler: MSF multiple alignments -> GeneRef catalogs.

Re-implements the semantics of the reference's extract_vars
(hisatgenotype_typing_process.py:313-1255):

  MSA rows -> consensus backbone (create_consensus_seq, :68-154)
           -> optional partial-allele exon grafting (:646-730)
           -> '~' fill with consensus (:733-755)
           -> duplicate/substring allele collapse (collapse_alleles,
              typing_common.py:205-275)
           -> left-shift normalization of deletions (leftshift_deletions,
              :159-230)
           -> per-allele variant extraction (insertVar loop, :823-917)
           -> haplotype window clustering by inter_gap/intra_gap (:1130-1224)

The column-wise passes are vectorized over a (n_alleles, L) uint8 matrix;
the per-allele variant scan walks only "event" columns (where the allele
differs from the backbone, plus the single match column that closes each
indel run) so it is O(#variants) instead of O(L) per allele.
"""
from __future__ import annotations

import bisect

import numpy as np

from .catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION, Catalog

# MSA char codes
_A, _C, _G, _T, _DOT, _E, _N, _TILDE = range(8)
_MSA_ENC = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate("ACGT.EN~"):
    _MSA_ENC[ord(_ch)] = _i
_MSA_DEC = np.frombuffer(b"ACGT.EN~", dtype=np.uint8)


def encode_msa(rows) -> np.ndarray:
    L = len(rows[0])
    mat = np.empty((len(rows), L), dtype=np.uint8)
    for i, r in enumerate(rows):
        codes = _MSA_ENC[np.frombuffer(r.encode("ascii"), dtype=np.uint8)]
        assert not np.any(codes == 255), "invalid MSA character"
        mat[i] = codes
    return mat


def decode_msa_row(row: np.ndarray) -> str:
    return _MSA_DEC[row.astype(np.int64)].tobytes().decode("ascii")


def find_seq_len(rows) -> int:
    """Majority row length (ref: find_seq_len, typing_process.py:258-272)."""
    lens, counts = np.unique([len(r) for r in rows], return_counts=True)
    return int(lens[np.argmax(counts)])


# --------------------------------------------------------------------------- #
# Consensus
# --------------------------------------------------------------------------- #
def consensus_matrix(mat: np.ndarray, min_var_freq: float,
                     remove_empty: bool = True):
    """Column consensus over an MSA matrix.

    Returns (backbone codes over 'ACGT.', per-column freq%, matrix with
    all-empty columns removed).  Ref: create_consensus_seq
    (typing_process.py:68-154): '.', 'E', 'N' pool into one "empty" class,
    '~' columns don't count toward coverage.
    """
    counts = np.stack([(mat == k).sum(axis=0) for k in range(7)])  # [7, L]
    coverage = counts.sum(axis=0)
    assert np.all(coverage > 0), "column with no coverage"
    freq = counts.astype(np.float64) / coverage * 100.0
    empty_freq = freq[_DOT] + freq[_E] + freq[_N]
    acgt = freq[:4]

    all_empty = counts[_DOT] + counts[_E] + counts[_N] == coverage
    if remove_empty and np.any(all_empty):
        keep = ~all_empty
        mat = mat[:, keep]
        counts = counts[:, keep]
        freq = freq[:, keep]
        empty_freq = empty_freq[keep]
        acgt = acgt[:, keep]
        all_empty = np.zeros(mat.shape[1], dtype=bool)

    backbone = np.argmax(acgt, axis=0).astype(np.uint8)  # first-max tie rule
    near_empty = empty_freq >= (100.0 - min_var_freq)
    backbone[near_empty] = _DOT
    if not remove_empty:
        backbone[all_empty] = _E

    # freq table: rows A C G T '.'(pooled empty)
    freq5 = np.concatenate([acgt, empty_freq[None, :]], axis=0)
    return backbone, freq5, mat


# --------------------------------------------------------------------------- #
# Left-shift of deletions
# --------------------------------------------------------------------------- #
def leftshift_deletions(backbone: np.ndarray, row: np.ndarray) -> np.ndarray:
    """Normalize gap runs leftward where flanking bases permit.

    Ref: leftshift_deletions (typing_process.py:159-230).  Operates on MSA
    codes; bases are codes < 4.
    """
    if len(row) != len(backbone):
        return row
    seq = row.copy()
    n = len(seq)
    is_dot = seq == _DOT
    if not is_dot.any():
        return seq
    # maximal gap runs [start, end), found in one vectorized pass; runs
    # preceded by a non-base shift 0 bases through the flank test below,
    # so no explicit skip bookkeeping is needed.
    edge = np.diff(is_dot.astype(np.int8))
    starts = np.flatnonzero(edge == 1) + 1
    ends = np.flatnonzero(edge == -1) + 1
    if is_dot[0]:
        starts = np.concatenate([[0], starts])
    if is_dot[-1]:
        ends = np.concatenate([ends, [n]])
    for run_start, run_end in zip(starts.tolist(), ends.tolist()):
        if run_start == 0 or run_end >= n:
            continue
        # The run slides left as one block: the shift distance is the
        # longest stretch where the allele's left flank (read inward-out)
        # keeps matching the backbone directly under the run's right edge.
        flank = seq[run_start - 1::-1]
        under = backbone[run_end - 1::-1][:run_start]
        ok = (flank < 4) & (under < 4) & (flank == under)
        shift = int(np.argmin(ok)) if not ok.all() else len(ok)
        if shift:
            seq[run_end - shift:run_end] = \
                seq[run_start - shift:run_start].copy()
            seq[run_start - shift:run_end - shift] = _DOT
    return seq


# --------------------------------------------------------------------------- #
# Variant extraction
# --------------------------------------------------------------------------- #
def _scan_allele_vars(b: np.ndarray, c: np.ndarray, dots_before: np.ndarray):
    """Yield (pos, type, data_or_len, msf_col) variants of one allele row `c`
    against backbone row `b` (both in MSA space).

    Ref: the insertVar state machine (typing_process.py:877-917).  Columns
    where nothing can change state ('~' on either side, or '.' on both) are
    skipped; indel runs legitimately continue across them, matching the
    reference's fall-through behavior.
    """
    b_base = b < 4
    c_base = c < 4
    b_dot = b == _DOT
    c_dot = c == _DOT
    mism = b_base & c_base & (b != c)
    insext = b_dot & c_base
    delext = b_base & c_dot
    interesting = np.flatnonzero(mism | insext | delext)
    if len(interesting) == 0:
        return []
    match_cols = np.flatnonzero(b_base & c_base & (b == c))
    # the first match column after each interesting column closes runs
    pos_in_match = np.searchsorted(match_cols, interesting)
    closers = match_cols[pos_in_match[pos_in_match < len(match_cols)]]
    events = np.union1d(interesting, closers)

    out = []
    ins = None  # [pos, msf_col, [base codes]]
    dele = None  # [pos, msf_col, length]
    for s in events.tolist():
        bb, cc = b[s], c[s]
        if bb < 4 and cc < 4:
            if ins is not None:
                out.append((ins[0], VT_INSERTION, bytes(ins[2]), ins[1]))
                ins = None
            elif dele is not None:
                out.append((dele[0], VT_DELETION, dele[2], dele[1]))
                dele = None
            if bb != cc:
                out.append((s - int(dots_before[s]), VT_SINGLE, bytes([cc]), s))
        elif bb == _DOT and cc < 4:
            if dele is not None:
                out.append((dele[0], VT_DELETION, dele[2], dele[1]))
                dele = None
            if ins is not None:
                ins[2].append(cc)
            else:
                ins = [s - int(dots_before[s]), s, [cc]]
        elif bb < 4 and cc == _DOT:
            if ins is not None:
                out.append((ins[0], VT_INSERTION, bytes(ins[2]), ins[1]))
                ins = None
            if dele is not None:
                dele[2] += 1
            else:
                dele = [s - int(dots_before[s]), s, 1]
    if ins is not None:
        out.append((ins[0], VT_INSERTION, bytes(ins[2]), ins[1]))
    elif dele is not None:
        out.append((dele[0], VT_DELETION, dele[2], dele[1]))
    return out


_NT_ORDER = {0: 0, 1: 1, 2: 2, 3: 3}  # A C G T codes are already ordered


def _var_sort_key(v):
    """(pos, type-order I<M<D, data-order).  Ref: key_varKey
    (typing_process.py:275-295)."""
    pos, vtype, data = v
    type_ord = {VT_INSERTION: 0, VT_SINGLE: 1, VT_DELETION: 2}[vtype]
    if vtype == VT_DELETION:
        last = data
    else:
        last = 0
        for ch in data:
            last = last * 4 + "ACGT".index(ch)
    return (pos, type_ord, last)


# --------------------------------------------------------------------------- #
# Allele collapse
# --------------------------------------------------------------------------- #
def collapse_alleles(names, rows, verbose=False):
    """Remove duplicate alleles and alleles whose stripped sequence is a
    substring of another's.  Ref: collapse_alleles
    (typing_common.py:205-275); substring search accelerated with one
    concatenated haystack instead of the O(A^2) scan.
    """
    stripped = [r.replace(".", "").replace("~", "") for r in rows]
    keep = np.ones(len(rows), dtype=bool)
    collapsed = {}

    # exact duplicates (on the full, dotted row)
    by_row = {}
    for i, r in enumerate(rows):
        by_row.setdefault(r, []).append(i)
    for idxs in by_row.values():
        if len(idxs) < 2:
            continue
        # keep the allele with the shortest (then smallest) name
        idxs = sorted(idxs, key=lambda i: (len(names[i]), names[i]))
        keeper = idxs[0]
        for i in idxs[1:]:
            keep[i] = False
            collapsed[names[i]] = names[keeper]

    # substring containment on stripped sequences
    order = sorted((i for i in range(len(rows)) if keep[i]),
                   key=lambda i: -len(stripped[i]))
    hay_parts, owners, offsets = [], [], [0]
    for i in order:
        hay_parts.append(stripped[i])
        owners.append(i)
        offsets.append(offsets[-1] + len(stripped[i]) + 1)
    hay = "#".join(hay_parts)
    starts = np.array(offsets[:-1])
    # Anchor index: rolling 64-gram hashes of the haystack (vectorized,
    # one pass) so each needle costs O(candidates) instead of a full
    # hay.find scan — the reference's O(A x total_len) loop collapses to
    # O(total_len + A x hits) at IMGT scale (thousands of alleles).
    ANCHOR = 64
    occ_of = None
    if len(hay) >= ANCHOR:
        codes = np.frombuffer(hay.encode("ascii"), np.uint8).astype(
            np.uint64)
        n = len(codes)
        B = 1099511628211                       # odd -> invertible mod 2^64
        binv = pow(B, -1, 1 << 64)
        pw = np.full(n, np.uint64(B)); pw[0] = 1
        np.cumprod(pw, out=pw)                  # B^i (wrapping)
        pwi = np.full(n, np.uint64(binv)); pwi[0] = 1
        np.cumprod(pwi, out=pwi)                # B^-i (wrapping)
        pref = np.cumsum(codes * pwi, dtype=np.uint64)
        win = pref[ANCHOR - 1:].copy()
        win[1:] -= pref[:n - ANCHOR]
        win *= pw[ANCHOR - 1:]                  # hash of hay[i:i+ANCHOR]
        sort_ix = np.argsort(win)
        win_sorted = win[sort_ix]

        def occ_of(needle):
            """Candidate start positions of `needle` in hay, ascending."""
            h = 0
            for ch in needle[:ANCHOR].encode("ascii"):
                h = (h * B + ch) & 0xFFFFFFFFFFFFFFFF
            h = np.uint64(h)
            lo = int(np.searchsorted(win_sorted, h, side="left"))
            hi = int(np.searchsorted(win_sorted, h, side="right"))
            return np.sort(sort_ix[lo:hi])

    def _occurrences(si):
        if occ_of is not None and len(si) >= ANCHOR:
            for a in occ_of(si):
                if hay.startswith(si, int(a)):
                    yield int(a)
        else:
            at = hay.find(si)
            while at != -1:
                yield at
                at = hay.find(si, at + 1)

    for i in order:
        if not keep[i]:
            continue
        si = stripped[i]
        for at in _occurrences(si):
            j = owners[int(np.searchsorted(starts, at, side="right")) - 1]
            if j != i and keep[j] and len(stripped[i]) < len(stripped[j]):
                ni, nj = names[i], names[j]
                if "HG38.ref" in ni or "exon" in ni:
                    keep[i] = False
                    collapsed[ni] = nj
                elif "refSeq" in nj or ("refSeq" in ni and "." not in nj):
                    keep[j] = False
                    collapsed[nj] = ni
                else:
                    keep[i] = False
                    collapsed[ni] = nj
                if not keep[i]:
                    break
    new_names = [n for i, n in enumerate(names) if keep[i]]
    new_rows = [r for i, r in enumerate(rows) if keep[i]]
    return new_names, new_rows, collapsed


# --------------------------------------------------------------------------- #
# Main build
# --------------------------------------------------------------------------- #
def graft_partial_alleles(names, rows, nuc_names, nuc_rows, ref_allele,
                          exons_ref_coords, min_var_freq):
    """Splice exon-only (nuc MSA) alleles into genomic context.

    Ref: typing_process.py:646-730 — for every allele present only in the
    nuc alignment, build a full-length row from the genomic consensus with
    the allele's exon sequence grafted into each exon span.  Returns
    (names, rows) extended with the partial alleles, and the set of
    grafted (partial) allele names.
    """
    seq_len = find_seq_len(rows)
    mat = encode_msa([r for r in rows if len(r) == seq_len])
    backbone, _f, _m = consensus_matrix(mat, min_var_freq,
                                        remove_empty=False)
    backbone_str = decode_msa_row(backbone)

    def seq_to_cols(row):
        return [i for i, ch in enumerate(row) if ch in "ACGT"]

    ref_row = rows[names.index(ref_allele)]
    ref_cols = seq_to_cols(ref_row)
    ref_nuc_row = nuc_rows[nuc_names.index(ref_allele)]
    ref_nuc_cols = seq_to_cols(ref_nuc_row)

    ref_exons = []
    ref_partial_exons = []
    exon_len = 0
    for left, right in exons_ref_coords:
        ref_exons.append((ref_cols[left], ref_cols[right]))
        next_len = right - left + exon_len
        if next_len >= len(ref_nuc_cols):
            return names, rows, set()  # incomplete nuc data
        ref_partial_exons.append((ref_nuc_cols[exon_len],
                                  ref_nuc_cols[next_len]))
        exon_len += right - left + 1
        span_gen = ref_exons[-1][1] - ref_exons[-1][0] + 1
        span_nuc = ref_partial_exons[-1][1] - ref_partial_exons[-1][0] + 1
        assert span_gen == span_nuc, "gen/nuc exon alignment widths differ"

    nuc_seq_len = find_seq_len(nuc_rows)
    partial = set()
    out_names = list(names)
    out_rows = list(rows)
    present = set(names)
    for name in nuc_names:
        if name in present:
            continue
        row = nuc_rows[nuc_names.index(name)]
        if len(row) != nuc_seq_len:
            continue
        new_seq = []
        right = 0
        for (gl, gr), (nl, nr) in zip(ref_exons, ref_partial_exons):
            new_seq.append(backbone_str[right:gl])
            exon_seq = row[nl:nr + 1]
            if not exon_seq.replace(".", "").replace("~", ""):
                exon_seq = backbone_str[gl:gr + 1]
            new_seq.append(exon_seq)
            right = gr + 1
        new_seq.append(backbone_str[right:])
        out_names.append(name)
        out_rows.append("".join(new_seq))
        partial.add(name)
    return out_names, out_rows, partial


def build_gene_ref(
    gene: str,
    names,                      # list of allele names (row order)
    rows,                       # list of MSA strings over ACGT.EN~
    ref_allele: str,            # reference allele name (e.g. "A*01:01:01:01")
    exons_ref_coords=(),        # [(left,right)] in ref-allele seq coords
    primary_exon_idx=(),        # indices into exons marking primary exons
    min_var_freq: float = 0.1,
    inter_gap: int = 30,
    intra_gap: int = 50,
    leftshift: bool = True,
    collapse: bool = True,
    whole_haplotype: bool = False,
    partial_names=(),           # allele names that are partial (exon-grafted)
    partial_msa=None,           # (nuc_names, nuc_rows) to graft exon-only alleles
    base_var_id: int = 0,
    chrom: str = "chrU",
    chrom_left: int = 0,
    strand: str = "+",
):
    """Compile one gene's MSA into a GeneRef.  Returns (GeneRef, next_var_id)."""
    partial_names = set(partial_names)
    if partial_msa is not None and exons_ref_coords:
        nuc_names, nuc_rows = partial_msa
        names, rows, grafted = graft_partial_alleles(
            names, rows, list(nuc_names), list(nuc_rows), ref_allele,
            exons_ref_coords, min_var_freq)
        partial_names |= grafted

    seq_len = find_seq_len(rows)
    use = [i for i in range(len(rows)) if len(rows[i]) == seq_len]
    names = [names[i] for i in use]
    rows = [rows[i] for i in use]
    # reference-style allele ordering (ref: sort_genall over names before
    # writing sequences, typing_process.py:1229-1244)
    from ..utils.names import key_sort_allele
    try:
        order = sorted(range(len(names)), key=lambda i: key_sort_allele(names[i]))
        names = [names[i] for i in order]
        rows = [rows[i] for i in order]
    except (ValueError, IndexError):
        pass  # non-standard names keep their input order
    # any leftover empty markers behave as unsequenced regions
    rows = [r.replace("E", "~") for r in rows]
    mat = encode_msa(rows)

    backbone, freq5, mat = consensus_matrix(mat, min_var_freq, remove_empty=True)

    # fill '~' with the consensus (ref: typing_process.py:733-755)
    tilde = mat == _TILDE
    if np.any(tilde):
        mat = np.where(tilde, backbone[None, :], mat)

    if collapse:
        rows_s = [decode_msa_row(mat[i]) for i in range(len(names))]
        names, rows_s, _collapsed = collapse_alleles(names, rows_s)
        if ref_allele in _collapsed:
            ref_allele = _collapsed[ref_allele]
        mat = encode_msa(rows_s)
        backbone, freq5, mat = consensus_matrix(mat, min_var_freq,
                                                remove_empty=True)

    if leftshift:
        for i in range(mat.shape[0]):
            mat[i] = leftshift_deletions(backbone, mat[i])
        backbone, freq5, mat = consensus_matrix(mat, min_var_freq,
                                                remove_empty=True)

    L = mat.shape[1]
    dots_before = np.concatenate([[0], np.cumsum(backbone == _DOT)[:-1]])

    # ---- variant extraction over all alleles ---------------------------- #
    _dec_cache = {}

    def dec(bs):
        """Decode variant payload codes -> str, memoized (the same SNP
        payload recurs once per carrying allele)."""
        key = bs if isinstance(bs, bytes) else bs.tobytes()
        out = _dec_cache.get(key)
        if out is None:
            out = _MSA_DEC[np.frombuffer(
                key, dtype=np.uint8).astype(np.int64)].tobytes().decode()
            _dec_cache[key] = out
        return out
    var_table = {}   # key (pos, type, data) -> [freq, [allele names]]
    for i, name in enumerate(names):
        for pos, vtype, data, msf_col in _scan_allele_vars(backbone, mat[i],
                                                           dots_before):
            if vtype == VT_DELETION:
                key = (pos, vtype, int(data))
            else:
                key = (pos, vtype, dec(data))
            if key not in var_table:
                # frequency from backbone column stats
                # (ref: insertVar, typing_process.py:844-871)
                if vtype == VT_SINGLE:
                    f = freq5[_MSA_ENC[ord(key[2])], msf_col]
                elif vtype == VT_DELETION:
                    f = freq5[4, msf_col:msf_col + key[2]].min()
                else:
                    cols = np.arange(msf_col, msf_col + len(key[2]))
                    codes = _MSA_ENC[np.frombuffer(key[2].encode(), np.uint8)]
                    f = freq5[codes, cols].min()
                var_table[key] = [float(f), [name]]
            else:
                var_table[key][1].append(name)

    keys = sorted(var_table.keys(), key=_var_sort_key)
    V = len(keys)
    A = len(names)
    aidx = {n: i for i, n in enumerate(names)}
    var_type = np.array([k[1] for k in keys], dtype=np.int8)
    var_pos = np.array([k[0] for k in keys], dtype=np.int32)
    var_len = np.array(
        [k[2] if k[1] == VT_DELETION else len(k[2]) for k in keys],
        dtype=np.int32,
    )
    var_data = [str(k[2]) for k in keys]
    var_freq = np.array([var_table[k][0] for k in keys], dtype=np.float32)
    links = np.zeros((V, A), dtype=bool)
    for vi, k in enumerate(keys):
        for n in var_table[k][1]:
            links[vi, aidx[n]] = True
    var_ids = ["hv%d" % (base_var_id + i) for i in range(V)]

    # ---- haplotype windows (ref: typing_process.py:1110-1224) ----------- #
    haplotypes = _build_haplotypes(
        keys, var_table, var_freq, min_var_freq, inter_gap, intra_gap,
        whole_haplotype, names, links,
    )

    # ---- exon mapping to backbone coords -------------------------------- #
    exons = []
    if exons_ref_coords and ref_allele in aidx:
        ref_row = mat[aidx[ref_allele]]
        ref_cols = np.flatnonzero(ref_row < 4)  # seq pos -> msf col
        for l, r in exons_ref_coords:
            cl, cr = int(ref_cols[l]), int(ref_cols[r])
            exons.append((cl - int(dots_before[cl]) - int(backbone[cl] == _DOT),
                          cr - int(dots_before[cr]) - int(backbone[cr] == _DOT)))
    else:
        bb_len = int((backbone != _DOT).sum())
        exons = [(0, bb_len - 1)]
    primary = [exons[i] for i in primary_exon_idx] if primary_exon_idx else list(exons)

    backbone_str = decode_msa_row(backbone[backbone != _DOT])
    ref_out = GeneRef(
        gene=gene,
        backbone_name="%s*BACKBONE" % gene,
        backbone=backbone_str,
        allele_names=names,
        var_ids=var_ids,
        var_type=var_type,
        var_pos=var_pos,
        var_len=var_len,
        var_data=var_data,
        var_freq=var_freq,
        links=links,
        exons=exons,
        primary_exons=primary,
        haplotypes=haplotypes,
        partial=set(partial_names) & set(names),
        chrom=chrom,
        chrom_left=chrom_left,
        chrom_right=chrom_left + len(backbone_str),
        strand=strand,
        min_var_freq=min_var_freq,
    )
    from ..validate import SANITY_CHECK, validate_gene
    if SANITY_CHECK:
        nuc_names, nuc_rows = partial_msa or (None, None)
        validate_gene(ref_out,
                      [decode_msa_row(mat[i]) for i in range(len(names))],
                      names, nuc_names=nuc_names, nuc_rows=nuc_rows)
    return ref_out, base_var_id + V


def _key_right(k):
    pos, vtype, data = k
    return pos + data - 1 if vtype == VT_DELETION else pos


def _build_haplotypes(keys, var_table, var_freq, min_var_freq, inter_gap,
                      intra_gap, whole_haplotype, names, links):
    """Cluster variants into haplotype windows and enumerate the observed
    haplotypes.  Faithful port of typing_process.py:1110-1224 including its
    window-advance quirk (the first variant's deletion length keeps being
    re-added to prev_locus at every step of the inner scan)."""
    V = len(keys)
    if V == 0:
        return []
    key_index = {k: i for i, k in enumerate(keys)}
    excluded = {i for i in range(V) if var_freq[i] < min_var_freq}
    if whole_haplotype:
        var_leftmost = keys[0][0]
        var_rightmost = max(_key_right(k) for k in keys)

    allele_key_idxs = {}  # allele -> sorted list of key indices
    for vi in range(V):
        for n in var_table[keys[vi]][1]:
            allele_key_idxs.setdefault(n, []).append(vi)

    haplotypes = []
    i = 0
    while i < V:
        pos_i, type_i, data_i = keys[i]
        locus = pos_i + (data_i - 1 if type_i == VT_DELETION else 0)
        prev_locus = locus
        if whole_haplotype:
            j = V
        else:
            j = i + 1
            while j < V:
                locus2 = keys[j][0]
                if prev_locus + inter_gap < locus2:
                    break
                prev_locus = locus2
                if type_i == VT_DELETION:  # ref quirk: uses key_i's type/data
                    prev_locus += data_i - 1
                j += 1

        alleles = set()
        for k in range(i, j):
            if var_freq[k] < min_var_freq:
                continue
            alleles |= set(var_table[keys[k]][1])

        hap_set = set()
        for allele in alleles:
            lst = allele_key_idxs[allele]      # sorted; window is [i, j)
            lo = bisect.bisect_left(lst, i)
            hi = bisect.bisect_left(lst, j)
            avars = [v for v in lst[lo:hi] if v not in excluded] \
                if excluded else lst[lo:hi]
            if avars:
                hap_set.add(tuple(avars))
        if not whole_haplotype:
            hap_set = _split_haplotypes(hap_set, keys, intra_gap)

        def hap_key(h):
            first, last = keys[h[0]], keys[h[-1]]
            return (first[0], _key_right(last))

        haps = sorted(hap_set, key=hap_key)
        for h_i, h in enumerate(haps):
            if whole_haplotype:
                h_begin, h_end = var_leftmost, var_rightmost
            else:
                h_begin = keys[h[0]][0]
                h_end = _key_right(keys[h[-1]])
                h_new_begin = h_begin
                for h_j in reversed(range(h_i)):
                    hc_end = _key_right(keys[haps[h_j][-1]])
                    if hc_end + inter_gap < h_begin:
                        break
                    if h_new_begin > hc_end:
                        h_new_begin = hc_end
                h_begin = h_new_begin
            haplotypes.append((h_begin, h_end, list(h)))
        i = j
    return haplotypes


def _split_haplotypes(hap_set, keys, intra_gap):
    """Split haplotypes containing internal gaps > intra_gap.
    Ref: split_haplotypes (typing_process.py:233-255)."""
    out = set()
    for h in hap_set:
        if len(h) == 0:
            continue
        if len(h) == 1:
            out.add(h)
            continue
        prev_s = 0
        s = 1
        while s < len(h):
            prev_pos, prev_type, prev_data = keys[h[s - 1]]
            pos = keys[h[s]][0]
            if prev_type == VT_DELETION:
                prev_pos += prev_data - 1
            if prev_pos + intra_gap < pos:
                out.add(h[prev_s:s])
                prev_s = s
            s += 1
            if s == len(h):
                out.add(h[prev_s:s])
    return out


def build_catalog_from_msa(family: str, gene_msas: dict, **kw) -> Catalog:
    """gene_msas: gene -> dict(names=.., rows=.., ref_allele=.., exons=..,
    primary_exon_idx=.., partial_names=..)."""
    genes = {}
    next_id = 0
    for gene, spec in gene_msas.items():
        ref, next_id = build_gene_ref(
            gene,
            spec["names"],
            spec["rows"],
            spec.get("ref_allele", spec["names"][0]),
            exons_ref_coords=spec.get("exons", ()),
            primary_exon_idx=spec.get("primary_exon_idx", ()),
            base_var_id=next_id,
            partial_names=spec.get("partial_names", ()),
            **kw,
        )
        genes[gene] = ref
    return Catalog(family=family, genes=genes)
