# Copy of hgtpu/typer/mpileup.py; only the imports differ.
"""Pileup statistics, sequencing-error correction, pair inter-distance.

Ports of get_mpileup (typing_common.py:1059-1184), error_correct
(typing_core.py:119-243) and get_pair_interdist
(typing_common.py:1187-1265), built from ReadAln records instead of a
samtools view pipe.  Column counts are accumulated vectorized.
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION

_NT = "ACGTND"
_NT_IDX = {c: i for i, c in enumerate(_NT)}


class Mpileup:
    """counts: [P, 6] over A C G T N D; rep[P]: representative base strings.

    Representative rule (ref: typing_common.py:1124-1134): positions with
    >= 20 total coverage keep bases with count >= 20% or >= 7.
    """

    def __init__(self, gene: GeneRef):
        self.gene = gene
        self.counts = np.zeros((len(gene.backbone), 6), dtype=np.int32)
        self.rep = None

    def add_alignment(self, aln):
        """Accumulate one ReadAln's bases (M -> read nt, D -> 'D')."""
        from ..utils.dna import encode_seq

        counts = self.counts
        P = counts.shape[0]
        codes = aln.codes if aln.codes is not None else encode_seq(aln.seq)
        read_pos = 0
        for entry in aln.cmp:
            kind, pos, length = entry[0], entry[1], entry[2]
            if kind in ("match", "mismatch"):
                n = min(length, P - pos)
                if n > 0:
                    seg = codes[read_pos:read_pos + n]
                    np.add.at(counts, (pos + np.arange(n), seg), 1)
                read_pos += length
            elif kind == "deletion":
                hi = min(pos + length, P)
                counts[pos:hi, 5] += 1
            else:  # insertion consumes read only
                read_pos += length

    def add_alignments_bulk(self, alns, weights=None):
        """Accumulate many ReadAlns in one pass: base columns through a
        single bincount over flattened (pos, code) keys, deletion columns
        through a difference array — same totals as repeated
        add_alignment calls without the per-read ufunc dispatch.
        `weights` (optional, aligned with alns) counts each alignment
        that many times — the caller's pair-level dedup weight."""
        from ..utils.dna import encode_seq

        P = self.counts.shape[0]
        seg_start = []
        seg_len = []
        seg_w = []
        code_chunks = []
        ddiff = np.zeros(P + 1, dtype=np.int32)
        # tiled/simulated batches repeat (pos, seq) heavily and the
        # aligner's cmp list is a deterministic function of those two, so
        # only distinct alignments are walked; duplicates contribute via
        # integer weights in the bincount
        from ..align.types import aln_key

        grouped = {}
        for i, aln in enumerate(alns):
            if not aln.cmp:
                continue
            key = aln_key(aln)
            wi = 1 if weights is None else weights[i]
            hit = grouped.get(key)
            if hit is None:
                grouped[key] = [aln, wi]
            else:
                hit[1] += wi
        for aln, w in grouped.values():
            codes = aln.codes if aln.codes is not None \
                else encode_seq(aln.seq)
            # indel-free alignments (the common case) cover one contiguous
            # backbone span with the whole read: one segment, no walk
            # (the aligner pre-classifies; SAM-parsed alns walk cmp)
            clean = aln.has_indel is False
            if clean is False and aln.has_indel is None:
                for entry in aln.cmp:
                    if entry[0] not in ("match", "mismatch"):
                        break
                else:
                    clean = True
            if clean:
                pos = aln.cmp[0][1]
                n = min(len(codes), P - pos)
                if n > 0:
                    seg_start.append(pos)
                    seg_len.append(n)
                    seg_w.append(w)
                    code_chunks.append(codes[:n])
                continue
            read_pos = 0
            for entry in aln.cmp:
                kind, pos, length = entry[0], entry[1], entry[2]
                if kind in ("match", "mismatch"):
                    n = min(length, P - pos)
                    if n > 0:
                        seg_start.append(pos)
                        seg_len.append(n)
                        seg_w.append(w)
                        code_chunks.append(codes[read_pos:read_pos + n])
                    read_pos += length
                elif kind == "deletion":
                    hi = min(pos + length, P)
                    if hi > pos:
                        ddiff[pos] += w
                        ddiff[hi] -= w
                else:
                    read_pos += length
        if seg_start:
            S = np.asarray(seg_start, dtype=np.int64)
            L = np.asarray(seg_len, dtype=np.int64)
            W = np.asarray(seg_w, dtype=np.int64)
            tot = int(L.sum())
            # positions for all segments without a per-segment arange
            pos_flat = np.repeat(S - (np.cumsum(L) - L), L) \
                + np.arange(tot, dtype=np.int64)
            flat = pos_flat * 6 + \
                np.concatenate(code_chunks).astype(np.int64)
            self.counts += np.bincount(
                flat, weights=np.repeat(W, L).astype(np.float64),
                minlength=P * 6).reshape(P, 6).astype(np.int32)
        self.counts[:, 5] += np.cumsum(ddiff[:-1], dtype=np.int32)
        return self

    def finalize(self):
        total = self.counts.sum(axis=1)
        acgt = self.counts[:, :4]
        keep = (total >= 20)[:, None] & \
               ((acgt >= total[:, None] * 0.2) | (acgt >= 7))
        self.rep = keep  # bool [P, 4]
        self.rep_any = keep.any(axis=1)
        # [P, 6] with N/'.'/sentinel columns False: lets the support test
        # index directly with base codes (no clip / <4 masking)
        self.rep6 = np.zeros((keep.shape[0], 6), dtype=bool)
        self.rep6[:, :4] = keep
        self._ramp = np.arange(keep.shape[0], dtype=np.int64)
        return self

    def rep_set(self, pos):
        return [("ACGT"[k]) for k in np.flatnonzero(self.rep[pos])]

    def deletion_plausible(self, pos):
        """Ref misalignment heuristic (typing_core.py:1064-1077): a
        deletion op is implausible when del_count * 6 < nt_count."""
        if pos >= len(self.counts):
            return True
        del_count = int(self.counts[pos, 5])
        nt_count = int(self.counts[pos, :5].sum())
        return del_count * 6 >= nt_count


def error_correct(gene: GeneRef, mpileup: Mpileup, cmp_list, read_seq,
                  read_codes=None):
    """Correct read bases unsupported by the pileup representative sets.

    Port of error_correct (typing_core.py:119-243), applied to the whole
    reference-style cmp list (runs of match/mismatch are walked; del/ins
    entries pass through untouched).  Returns
    (new cmp_list, new read_seq, num_corrections).
    """
    if mpileup is None or mpileup.rep is None:
        return cmp_list, read_seq, 0
    ref_seq = gene.backbone
    # (pos, base) -> catalog SNP id, built once per pileup session (the
    # gene's catalog is immutable for the life of the Mpileup)
    single_lookup = getattr(mpileup, "_single_lookup", None)
    if single_lookup is None:
        single_lookup = {}
        for vi in np.flatnonzero(gene.var_type == VT_SINGLE):
            single_lookup[(int(gene.var_pos[vi]), gene.var_data[vi])] = \
                gene.var_ids[vi]
        mpileup._single_lookup = single_lookup

    out = []
    num_correction = 0
    read_pos = 0
    seq = read_seq
    from ..utils.dna import encode_seq

    if read_codes is None:
        read_codes = encode_seq(read_seq)
    rep = mpileup.rep
    rep_any = mpileup.rep_any

    # identity fast path: corrections fire only where a read base falls
    # outside a non-empty representative set, and that condition is a
    # pure gather over (backbone pos, base) pairs — one vectorized
    # support test over every match/mismatch-covered position proves
    # correction is a no-op for the vast majority of reads.  Indel-free
    # alignments (the common case) need no segment walk at all.
    indel_free = True
    for e in cmp_list:
        if e[0] not in ("match", "mismatch"):
            indel_free = False
            break
    if indel_free:
        start = cmp_list[0][1]
        n = min(len(read_codes), len(ref_seq) - start)
        ok = mpileup.rep6[mpileup._ramp[start:start + n], read_codes[:n]]
        if not (rep_any[start:start + n] & ~ok).any():
            return cmp_list, read_seq, 0
    else:
        # segment-mapped twin for indel-bearing cmp lists: collect the
        # (pos, code) pairs each match/mismatch segment covers
        pos_parts, code_parts = [], []
        rp = 0
        for e in cmp_list:
            kind, left, length = e[0], e[1], e[2]
            if kind == "match" or kind == "mismatch":
                n = min(length, len(read_codes) - rp, len(ref_seq) - left)
                if n > 0:
                    pos_parts.append(mpileup._ramp[left:left + n])
                    code_parts.append(read_codes[rp:rp + n])
                rp += length
            elif kind == "insertion":
                rp += length
        if pos_parts:
            pos_all = np.concatenate(pos_parts)
            code_all = np.concatenate(code_parts)
            ok = mpileup.rep6[pos_all, code_all]
            if not (rep_any[pos_all] & ~ok).any():
                return cmp_list, read_seq, 0
        else:
            return cmp_list, read_seq, 0
    for entry in cmp_list:
        kind, left, length = entry[0], entry[1], entry[2]
        if kind == "match":
            # vectorized scan: flag positions whose base is outside the
            # representative set (the rare case); the common all-supported
            # segment costs one numpy expression
            n = min(length, len(seq) - read_pos, len(ref_seq) - left)
            if n > 0:
                codes = read_codes[read_pos:read_pos + n]
                in_rep = (codes < 4) & rep[mpileup._ramp[left:left + n],
                                           np.clip(codes, 0, 3)]
                bad = rep_any[left:left + n] & ~in_rep
                bad_js = np.flatnonzero(bad)
            else:
                bad_js = ()
            middle = []
            last_j = 0
            for j in bad_js.tolist() if len(bad_js) else []:
                read_bp = seq[read_pos + j]
                nt_set = mpileup.rep_set(left + j)
                if True:
                    read_bp = "N" if len(nt_set) > 1 else nt_set[0]
                    seq = seq[:read_pos + j] + read_bp + seq[read_pos + j + 1:]
                    new_cmp = ["mismatch", left + j, 1, "unknown"]
                    num_correction += 1
                    if read_bp != "N":
                        vid = single_lookup.get((left + j, read_bp))
                        if vid:
                            new_cmp[3] = vid
                    if j > last_j:
                        middle.append(["match", left + last_j, j - last_j])
                    middle.append(new_cmp)
                    last_j = j + 1
            if last_j < length:
                middle.append(["match", left + last_j, length - last_j])
            out.extend(middle)
            read_pos += length
        elif kind == "mismatch":
            read_bp = seq[read_pos] if read_pos < len(seq) else "N"
            ref_bp = ref_seq[left] if left < len(ref_seq) else "N"
            nt_set = mpileup.rep_set(left) if left < len(ref_seq) else []
            e = list(entry)
            if nt_set and read_bp not in nt_set:
                read_bp = "N" if len(nt_set) > 1 else nt_set[0]
                seq = seq[:read_pos] + read_bp + seq[read_pos + 1:]
                if read_bp == "N":
                    e[3] = "unknown"
                elif read_bp == ref_bp:
                    e = ["match", left, 1]
                    num_correction += 1
                else:
                    e[3] = single_lookup.get((left, read_bp), "unknown")
            out.append(e)
            read_pos += length
        else:
            out.append(list(entry))
            if kind == "insertion":
                read_pos += length
    # merge adjacent matches (ref: typing_core.py:226-235)
    merged = []
    for e in out:
        if e[0] == "match" and merged and merged[-1][0] == "match" \
                and merged[-1][1] + merged[-1][2] == e[1]:
            merged[-1][2] += e[2]
        else:
            merged.append(e)
    return merged, seq, num_correction


def pair_interdist(read_alns):
    """Median inner distance between concordant mate pairs.

    Port of get_pair_interdist (typing_common.py:1187-1265) over
    (read_id, [ReadAln]) groups.
    """
    dist_list = []
    for _read_id, alns in read_alns:
        alns = [a for a in alns if a is not None]
        if len(alns) != 2:
            continue
        (l1, r1), (l2, r2) = [(a.pos, a.right - 1) for a in alns]
        if l1 <= l2:
            dist = l2 - r1 - 1
        else:
            dist = l1 - r2 - 1
        dist_list.append(dist)
    dist_list.sort()
    if not dist_list:
        return -1
    return dist_list[len(dist_list) // 2]
