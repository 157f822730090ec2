# Copy of hgtpu/align/verify.py; only the imports differ.
"""Variant-aware verification: turn a candidate diagonal into an edit
script over the variant graph.

Produces the information the reference extracts from the SAM stream's
CIGAR/MD/Zs tags (typing_core.py:899-1124): known catalog variants
(SNP/del/ins) are free, novel differences cost novel-edit distance (the
graph aligner's NM).  The search walks match runs with numpy and branches
only at indel-variant positions and observed mismatches, memoized over
(read offset, backbone position) states.  Ties prefer the spelling
closest to the backbone (fewest indel variants); equivalent end spellings
are canonicalized later by the alternative-haplotype trimming
(ref: typing_common.py:1663-1955).
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION
from ..utils.dna import encode_seq


def build_haplotype_constraint(gene: GeneRef):
    """(disallowed pair set, cover_right map) for catalog indel variants.

    A pair (u, v) is disallowed when some haplotype row's interval covers
    both variants' spans yet no allele carries both (links AND empty).
    cover_right[u] = the rightmost row end among rows starting at or
    before u — past it, u can no longer constrain later branches.
    """
    indels = [vi for vi in range(gene.n_vars)
              if int(gene.var_type[vi]) != VT_SINGLE]
    if not indels or not gene.haplotypes:
        return frozenset(), {}
    rows = [(int(l), int(r)) for l, r, _ in gene.haplotypes]
    row_l = np.array([l for l, _ in rows], dtype=np.int64)
    row_r = np.array([r for _, r in rows], dtype=np.int64)
    disallowed = set()
    cover_right = {}
    for u in indels:
        pu = int(gene.var_pos[u])
        starts_before = row_l <= pu
        cover_right[u] = int(row_r[starts_before].max()) \
            if starts_before.any() else -1
    for a_i, u in enumerate(indels):
        for v in indels[a_i + 1:]:
            lo = min(int(gene.var_pos[u]), int(gene.var_pos[v]))
            hi = max(int(gene.var_right[u]), int(gene.var_right[v]))
            covered = bool(((row_l <= lo) & (row_r >= hi)).any())
            if not covered:
                continue
            together = bool((gene.links[u] & gene.links[v]).any())
            if not together:
                disallowed.add((u, v))
                disallowed.add((v, u))
    return frozenset(disallowed), cover_right


class GeneVerifier:
    def __init__(self, gene: GeneRef, max_novel: int = 2,
                 allow_novel_indels: bool = True,
                 haplotype_paths: bool = True):
        self.gene = gene
        self.max_novel = max_novel
        self.allow_novel_indels = allow_novel_indels
        self.bb = gene.backbone_enc.astype(np.int16)
        self.single_at = {}   # (pos, base code) -> var index
        self.dels_at = {}     # pos -> [(len, var index)]
        self.ins_at = {}      # pos -> [(codes, var index)]
        for vi in range(gene.n_vars):
            vt = int(gene.var_type[vi])
            pos = int(gene.var_pos[vi])
            if vt == VT_SINGLE:
                self.single_at[(pos, "ACGT".index(gene.var_data[vi]))] = vi
            elif vt == VT_DELETION:
                self.dels_at.setdefault(pos, []).append(
                    (int(gene.var_len[vi]), vi))
            else:
                self.ins_at.setdefault(pos, []).append(
                    (encode_seq(gene.var_data[vi]), vi))
        self.indel_pos = np.array(
            sorted(set(self.dels_at) | set(self.ins_at)), dtype=np.int64
        )
        # haplotype-window path constraint (reference --haplotype,
        # typing_common.py:995-1027 / hisat2-build --haplotype): within a
        # span covered by an observed haplotype window, two catalog indels
        # may only combine when some allele carries both; outside covered
        # spans recombination is unconstrained (hisat2 chains across
        # windows).  hap_disallowed holds the forbidden ordered pairs;
        # hap_cover_right[v] bounds how far v's constraint can reach.
        self.hap_disallowed = frozenset()
        self.hap_cover_right = {}
        if haplotype_paths and gene.haplotypes:
            self.hap_disallowed, self.hap_cover_right = \
                build_haplotype_constraint(gene)

    # ------------------------------------------------------------------ #
    def verify(self, read: np.ndarray, start_pos: int):
        """Best-cost edit script for `read` (int8 codes) starting at
        backbone position `start_pos`.

        Returns (cost, ops) or None; ops entries are
        (kind, pos, length, var_idx, data) with kind in
        {'mismatch','deletion','insertion'} — match runs are implicit.
        """
        m = len(read)
        P = len(self.bb)
        if start_pos < 0 or start_pos >= P or m == 0:
            return None
        best = {"cost": self.max_novel + 1, "ops": None}
        memo = {}
        read16 = read.astype(np.int16)
        dels_at, ins_at, single_at = self.dels_at, self.ins_at, self.single_at

        def next_mismatch(ri, pos, span):
            neq = np.flatnonzero(read16[ri:ri + span] != self.bb[pos:pos + span])
            return int(neq[0]) if len(neq) else span

        def next_indel_after(pos):
            i = np.searchsorted(self.indel_pos, pos + 1)
            return int(self.indel_pos[i]) if i < len(self.indel_pos) else P + m

        def finish(budget, ops):
            cost = self.max_novel - budget
            if cost < best["cost"]:
                best["cost"] = cost
                best["ops"] = list(ops)

        hap_disallowed = self.hap_disallowed
        hap_cover_right = self.hap_cover_right

        def hap_ok(vi, ops):
            if not hap_disallowed:
                return True
            for e in ops:
                if e[3] >= 0 and e[0] != "mismatch" \
                        and (e[3], vi) in hap_disallowed:
                    return False
            return True

        def dfs(ri, pos, budget, ops, skip_indel=False, act_r=-1):
            if ri == m:
                finish(budget, ops)
                return
            if pos >= P:
                return  # read would run off the backbone
            if not skip_indel:
                key = (ri, pos)
                seen = memo.get(key)
                if seen is not None and seen >= budget:
                    return
                if pos > act_r:
                    # store only constraint-free states: a memoized visit
                    # must represent the maximal exploration for (ri, pos)
                    memo[key] = budget
                if ri > 0 and (pos in dels_at or pos in ins_at):
                    # plain (backbone-closest) spelling explored first
                    dfs(ri, pos, budget, ops, skip_indel=True, act_r=act_r)
                    for dlen, vi in dels_at.get(pos, ()):
                        if not hap_ok(vi, ops):
                            continue
                        ops.append(("deletion", pos, dlen, vi, str(dlen)))
                        dfs(ri, pos + dlen, budget, ops,
                            act_r=max(act_r, hap_cover_right.get(vi, -1)))
                        ops.pop()
                    for ins_codes, vi in ins_at.get(pos, ()):
                        d = len(ins_codes)
                        if ri + d <= m and np.array_equal(read[ri:ri + d],
                                                          ins_codes):
                            if not hap_ok(vi, ops):
                                continue
                            ops.append(("insertion", pos, d, vi,
                                        "".join("ACGT"[c] for c in ins_codes)))
                            dfs(ri + d, pos, budget, ops,
                                act_r=max(act_r,
                                          hap_cover_right.get(vi, -1)))
                            ops.pop()
                    return
            # --- advance along the diagonal to the next event --- #
            span = min(m - ri, P - pos)
            nm = next_mismatch(ri, pos, span)
            if nm > 0:
                ni = next_indel_after(pos) - pos
                adv = min(nm, ni, span)
                if not (adv == nm and nm < ni and nm < span):
                    # stop at an indel-var position, read end, or ref end
                    dfs(ri + adv, pos + adv, budget, ops, act_r=act_r)
                    return
                # otherwise: plain mismatch event strictly before any
                # indel-variant position
                ri += nm
                pos += nm
            # --- mismatch event at (ri, pos) --- #
            base = int(read[ri])
            vi = single_at.get((pos, base), -1)
            if vi >= 0:
                ops.append(("mismatch", pos, 1, vi, "ACGT"[base]))
                dfs(ri + 1, pos + 1, budget, ops, act_r=act_r)
                ops.pop()
                return
            if budget > 0:
                ops.append(("mismatch", pos, 1, -1, "ACGTN."[base]))
                dfs(ri + 1, pos + 1, budget - 1, ops, act_r=act_r)
                ops.pop()
            if self.allow_novel_indels and ri > 0:
                for d in (1, 2):
                    if budget - d < 0:
                        continue
                    ops.append(("deletion", pos, d, -1, str(d)))
                    dfs(ri, pos + d, budget - d, ops, act_r=act_r)
                    ops.pop()
                    if ri + d <= m:
                        ins_seq = "".join("ACGTN."[int(c)]
                                          for c in read[ri:ri + d])
                        ops.append(("insertion", pos, d, -1, ins_seq))
                        dfs(ri + d, pos, budget - d, ops, act_r=act_r)
                        ops.pop()

        dfs(0, start_pos, self.max_novel, [])
        if best["ops"] is None:
            return None
        return best["cost"], best["ops"]

    # ------------------------------------------------------------------ #
    @staticmethod
    def ops_to_cmp_list(ops, start_pos: int, read_len: int):
        """Expand an edit script into the reference's cmp_list form
        (match segments made explicit).  Entries:
        (type, pos, length, var_idx, data)."""
        cmp_list = []
        pos = start_pos
        consumed = 0  # read bases consumed
        for kind, vpos, length, vidx, data in ops:
            if vpos > pos:
                seg = vpos - pos
                cmp_list.append(("match", pos, seg, None, ""))
                consumed += seg
                pos = vpos
            if kind == "mismatch":
                cmp_list.append(("mismatch", vpos, 1, vidx, data))
                pos += 1
                consumed += 1
            elif kind == "deletion":
                cmp_list.append(("deletion", vpos, length, vidx, data))
                pos += length
            else:
                cmp_list.append(("insertion", vpos, length, vidx, data))
                consumed += length
        if consumed < read_len:
            cmp_list.append(("match", pos, read_len - consumed, None, ""))
            pos += read_len - consumed
        return cmp_list, pos
