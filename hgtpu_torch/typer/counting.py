# Copy of hgtpu/typer/counting.py; the imports differ, and the port hands
# the staged EM its classes as masks (ClassLevel, name_order) where
# hgtpu joins them into names (cmpt_names).
"""Read-haplotype -> allele compatibility counting.

Vectorized re-formulation of the reference's add_count set algebra
(typing_core.py:626-677): for a read haplotype ht spanning [left, right]
with known variant set V,

    compatible(a) = (a carries every v in V)
                  & not (a carries any other variant overlapping [left,right])

expressed over the [V, A] link matrix as an AND-reduce plus a range-count
(prefix sums over position-sorted non-deletion variants; the handful of
deletion variants are tested directly, mirroring the reference's
boundary-overlap rule `var_left in [l,r] or var_right in [l,r]`).
Novel variants ('nv*', not in Links) never constrain — same as the
reference's skip.
"""
from __future__ import annotations

import functools

import numpy as np

from ..db.catalog import GeneRef, VT_DELETION


class HtOp:
    """One non-match op inside a read haplotype."""
    __slots__ = ("kind", "pos", "length", "var_idx", "data")

    def __init__(self, kind, pos, length, var_idx, data):
        self.kind = kind          # 'mismatch' | 'deletion' | 'insertion'
        self.pos = pos
        self.length = length
        self.var_idx = var_idx    # >=0 catalog index, <0 novel
        self.data = data

    def key(self):
        return (self.kind, self.pos, self.length, self.var_idx, self.data)

    @property
    def right(self):
        if self.kind == "deletion":
            return self.pos + self.length - 1
        return self.pos


class GeneCounter:
    def __init__(self, gene: GeneRef):
        self.gene = gene
        A = gene.n_alleles
        self.A = A
        nondel = gene.var_type != VT_DELETION
        self.nd_pos = gene.var_pos[nondel].astype(np.int64)
        self.nd_prefix = np.zeros((int(nondel.sum()) + 1, A), dtype=np.int32)
        np.cumsum(gene.links[nondel].astype(np.int32), axis=0,
                  out=self.nd_prefix[1:])
        self.del_idx = np.flatnonzero(gene.var_type == VT_DELETION)
        self.del_pos = gene.var_pos[self.del_idx].astype(np.int64)
        self.del_right = gene.var_right[self.del_idx].astype(np.int64)
        self.del_links = gene.links[self.del_idx]
        # batch-path tables: links with an all-True sentinel row (padding
        # variant), variant pos/right with sentinel entries
        V = gene.n_vars
        self._links_ext = np.ones((V + 1, A), dtype=bool)
        self._links_ext[:V] = gene.links
        self._vp_ext = np.concatenate(
            [gene.var_pos.astype(np.int64), [-(1 << 40)]])
        self._vr_ext = np.concatenate(
            [gene.var_right.astype(np.int64), [-(1 << 40)]])

    # ------------------------------------------------------------------ #
    def alleles_for_ht(self, left: int, right: int, ops) -> np.ndarray:
        """Boolean [A] mask of alleles compatible with the haplotype."""
        g = self.gene
        incl = np.ones(self.A, dtype=bool)
        known = [op for op in ops if op.var_idx >= 0]
        for op in known:
            incl &= g.links[op.var_idx]
        # count of each allele's variants overlapping [left, right]
        i0 = np.searchsorted(self.nd_pos, left, "left")
        i1 = np.searchsorted(self.nd_pos, right, "right")
        cnt = self.nd_prefix[i1] - self.nd_prefix[i0]
        dmask = ((self.del_pos >= left) & (self.del_pos <= right)) | \
                ((self.del_right >= left) & (self.del_right <= right))
        if dmask.any():
            cnt = cnt + self.del_links[dmask].sum(axis=0, dtype=np.int32)
        # how many of the ht's own known vars fall in that overlap set
        kv = 0
        for op in known:
            vt = int(g.var_type[op.var_idx])
            p = int(g.var_pos[op.var_idx])
            r = int(g.var_right[op.var_idx])
            if vt == VT_DELETION:
                if (left <= p <= right) or (left <= r <= right):
                    kv += 1
            elif left <= p <= right:
                kv += 1
        excl = (cnt - kv) > 0
        return incl & ~excl

    def alleles_for_hts_batch(self, sub_hts):
        """Vectorized alleles_for_ht over many haplotypes at once.

        sub_hts: [(left, right, [var idx])] (novel idx < 0 allowed, they
        constrain nothing).  Returns int32 [H, A], row h identical to
        alleles_for_ht(*sub_hts[h]).
        """
        H = len(sub_hts)
        A = self.A
        if H == 0:
            return np.zeros((0, A), dtype=np.int32)
        V = self.gene.n_vars
        lefts = np.fromiter((h[0] for h in sub_hts), np.int64, H)
        rights = np.fromiter((h[1] for h in sub_hts), np.int64, H)
        K = max(1, max(sum(1 for v in h[2] if v >= 0) for h in sub_hts))
        vars_ = np.full((H, K), V, dtype=np.int64)   # sentinel pad
        for i, (_, _, vs) in enumerate(sub_hts):
            ks = [v for v in vs if v >= 0]
            vars_[i, : len(ks)] = ks
        incl = self._links_ext[vars_].all(axis=1)                  # [H, A]
        i0 = np.searchsorted(self.nd_pos, lefts, side="left")
        i1 = np.searchsorted(self.nd_pos, rights, side="right")
        cnt = self.nd_prefix[i1] - self.nd_prefix[i0]              # [H, A]
        if len(self.del_pos):
            dmask = (((self.del_pos[None, :] >= lefts[:, None])
                      & (self.del_pos[None, :] <= rights[:, None]))
                     | ((self.del_right[None, :] >= lefts[:, None])
                        & (self.del_right[None, :] <= rights[:, None])))
            cnt = cnt + dmask.astype(np.int32) @ \
                self.del_links.astype(np.int32)
        vp = self._vp_ext[vars_]                                   # [H, K]
        vr = self._vr_ext[vars_]
        in_range = (((vp >= lefts[:, None]) & (vp <= rights[:, None]))
                    | ((vr >= lefts[:, None]) & (vr <= rights[:, None])))
        kv = in_range.sum(axis=1).astype(np.int32)                 # [H]
        excl = (cnt - kv[:, None]) > 0
        return (incl & ~excl).astype(np.int32)


class StatAccumulator:
    """Per-level equivalence-class statistics.

    Mirrors add_stat (typing_core.py:1171-1236): per read, alleles at the
    max compatibility count form the read's class; class counts feed EM,
    per-allele firsts feed the ranked count report.
    """

    def __init__(self, allele_names, include_mask=None):
        self.allele_names = allele_names
        self.A = len(allele_names)
        self.include = (np.ones(self.A, bool)
                        if include_mask is None else include_mask)
        self.counts = np.zeros(self.A, dtype=np.int64)   # Gene_counts
        self.cmpt = {}                                    # key -> count
        self.cmpt_order = {}                              # key -> first-seen
        self.cmpt_mask = {}                               # key -> bool[A]

    def add_read(self, count_per_read: np.ndarray, weight: int = 1):
        """count_per_read: int [A] compatibility counts for one read.

        Faithful to add_stat: the max count may be 0, in which case the
        read contributes the uniform all-include-alleles class
        (typing_core.py:1177-1186 takes every allele at max_count).
        `weight` folds identical reads into one call (tiled/simulated
        batches repeat ht sets heavily); equivalent to `weight`
        consecutive add_read calls.
        """
        if not self.include.any():
            return None
        mx = count_per_read[self.include].max()
        cur = (count_per_read == mx) & self.include
        if not cur.any():
            return None
        self.counts[cur] += weight
        key = cur.tobytes()
        if key not in self.cmpt:
            self.cmpt[key] = 0
            self.cmpt_order[key] = len(self.cmpt_order)
            self.cmpt_mask[key] = cur.copy()
        self.cmpt[key] += weight
        return key

    def add_reads_batch(self, counts_mat: np.ndarray, weights: np.ndarray):
        """Vectorized add_read over many reads at once.

        counts_mat: int [G, A] per-read compatibility counts; weights:
        int [G].  Equivalent to `add_read(counts_mat[g], weights[g])` for
        g in order — per-allele totals are sums, and class first-seen
        order (which fixes cmpt_order / dense() row order) is the first
        occurrence along G.
        """
        if not self.include.any() or len(counts_mat) == 0:
            return
        mx = counts_mat[:, self.include].max(axis=1)
        cur = (counts_mat == mx[:, None]) & self.include       # [G, A]
        self.counts += (cur * weights[:, None]).sum(axis=0, dtype=np.int64)
        uniq, first, inv = np.unique(cur, axis=0, return_index=True,
                                     return_inverse=True)
        wsum = np.bincount(inv, weights=weights)
        for u in np.argsort(first, kind="stable"):
            row = uniq[u]
            key = row.tobytes()
            if key not in self.cmpt:
                self.cmpt[key] = 0
                self.cmpt_order[key] = len(self.cmpt_order)
                self.cmpt_mask[key] = row.copy()
            self.cmpt[key] += int(wsum[u])

    def add_packed_batch(self, packed: np.ndarray, weights: np.ndarray,
                         totals: np.ndarray):
        """Device-fold twin of add_reads_batch.

        packed: uint32 [G, W] bit-packed class rows (bit b of word w is
        allele w*32+b), computed on device by typer.device_fold; weights:
        int [G]; totals: int [A] weighted per-allele sums (the device's
        `(cur * weights).sum(0)`).  Class identity, first-seen order,
        and counts are identical to add_reads_batch on the unpacked rows.
        """
        if not self.include.any() or len(packed) == 0:
            return
        self.counts += totals.astype(np.int64)
        uniq, first, inv = np.unique(packed, axis=0, return_index=True,
                                     return_inverse=True)
        wsum = np.bincount(inv, weights=weights)
        a_idx = np.arange(self.A)
        for u in np.argsort(first, kind="stable"):
            row_bits = uniq[u]
            key = row_bits.tobytes()
            if key not in self.cmpt:
                self.cmpt[key] = 0
                self.cmpt_order[key] = len(self.cmpt_order)
                self.cmpt_mask[key] = (
                    (row_bits[a_idx // 32] >> (a_idx % 32)) & 1
                ).astype(bool)
            self.cmpt[key] += int(wsum[u])

    # ------------------------------------------------------------------ #
    def ranked_counts(self):
        order = np.argsort(-self.counts, kind="stable")
        return [(self.allele_names[i], int(self.counts[i]))
                for i in order if self.counts[i] > 0]

    def classes(self):
        """The classes as a ClassLevel: rows in first-seen order (as
        dense() orders them), columns in name order; a class held under
        two keys (packed and unpacked rows) is one row."""
        names = name_order(self.allele_names)
        C = len(self.cmpt)
        if C:
            M = np.stack(list(self.cmpt_mask.values())).take(names.order,
                                                             axis=1)
        else:
            M = np.zeros((0, self.A), dtype=bool)
        counts = np.fromiter(self.cmpt.values(), np.int64, C)
        return ClassLevel.merged(M, counts, names)

    def dense(self):
        """(membership [C, A] bool, counts [C]) for the device EM."""
        C = len(self.cmpt)
        M = np.zeros((C, self.A), dtype=bool)
        c = np.zeros(C, dtype=np.float32)
        for key, cnt in self.cmpt.items():
            i = self.cmpt_order[key]
            M[i] = self.cmpt_mask[key]
            c[i] = cnt
        return M, c


class NameOrder:
    """A gene's alleles in the order `sorted` gives their names: allele
    `order[r]` has name rank r, `rank` is its inverse, `sorted_names`
    the names in rank order (an object array) and `index` maps a name to
    its allele index.  Shared by every caller (name_order), so its
    arrays are read-only."""

    __slots__ = ("order", "rank", "sorted_names", "index")

    def __init__(self, allele_names):
        A = len(allele_names)
        self.order = np.array(sorted(range(A), key=allele_names.__getitem__),
                              dtype=np.int64)
        self.rank = np.empty(A, dtype=np.int64)
        self.rank[self.order] = np.arange(A)
        self.sorted_names = np.array(allele_names, dtype=object)[self.order]
        for a in (self.order, self.rank, self.sorted_names):
            a.setflags(write=False)
        self.index = {n: i for i, n in enumerate(allele_names)}


@functools.lru_cache(maxsize=32)
def _name_order(allele_names: tuple) -> NameOrder:
    return NameOrder(allele_names)


def name_order(allele_names) -> NameOrder:
    """The NameOrder of an allele list, computed once per list."""
    return _name_order(tuple(allele_names))


class ClassLevel:
    """One projection level's classes as the staged EM takes them: `M`
    bool [C, A], row c the alleles of class c with column r the allele
    of name rank r (`names.order[r]`), rows distinct and in first-seen
    order; `counts` int64 [C]."""

    __slots__ = ("M", "counts", "names")

    def __init__(self, M, counts, names: NameOrder):
        self.M = M
        self.counts = counts
        self.names = names

    @classmethod
    def merged(cls, M, counts, names):
        """Equal rows of M merged into the first, their counts summed."""
        if len(counts) > 1:
            packed = np.packbits(M, axis=1)
            keys = packed.view(np.dtype((np.void, packed.shape[1]))).ravel()
            _, first, inv = np.unique(keys, return_index=True,
                                      return_inverse=True)
            sums = np.zeros(len(first), dtype=np.int64)
            np.add.at(sums, inv.ravel(), counts)
            keep = np.argsort(first)
            M, counts = M[first[keep]], sums[keep]
        return cls(M, counts, names)

    def __len__(self):
        return len(self.counts)

    def cmpt(self) -> dict:
        """{'A1-A2': count}, each key the class's allele names in sorted
        order joined by '-', in row order."""
        A = self.M.shape[1]
        names = self.names.sorted_names.take(
            np.flatnonzero(self.M) % A).tolist()
        ends = np.cumsum(np.count_nonzero(self.M, axis=1)).tolist()
        keys = ["-".join(names[s:e]) for s, e in zip([0] + ends, ends)]
        return dict(zip(keys, self.counts.tolist()))

    def restrict(self, alleles) -> "ClassLevel":
        """The classes projected onto a set of allele indices: other
        alleles dropped, emptied classes dropped, classes made equal
        merged (the reference re-keys Gene_cmpt rows onto the expanded
        set before the full-length EM, typing_core.py:1767-1780)."""
        keep = np.zeros(self.M.shape[1], dtype=bool)
        keep[self.names.rank[np.fromiter(alleles, np.int64)]] = True
        M = self.M & keep
        rows = M.any(axis=1)
        return ClassLevel.merged(M[rows], self.counts[rows], self.names)
