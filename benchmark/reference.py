"""The plain reference: HISAT-genotype's typing semantics in NumPy.

It works from the generator's MSA rows and the reads alone, and imports
nothing of the program under test.  For each gene it derives its own
catalog (the column consensus at a minimum variant frequency of 0, every
gap run shifted left where its flanks allow, the exons mapped through
the reference allele), places every read by exact match, and computes
for each read pair the compatibility classes at the three levels the
reference reports (full length, exons, primary exons), the per-allele
counts and the staged EM abundance.

Semantics, as HISAT-genotype states them (typing_core.py add_count,
get_exon_haplotypes, add_stat, single_abundance):

- a read is compatible with an allele when the allele carries every
  variant the read carries over the read's span and no other variant
  overlapping it; for an error-free read at a minimum variant frequency
  of 0 that is: the allele's MSA row equals the read's source row over
  the span's columns;
- at the exon levels the read's span is clipped to each exon (a deletion
  of the read that straddles the exon edge moves the edge past it), and
  an allele counts once per clipped piece it is compatible with; an
  allele whose own deletion covers a whole piece is not excluded by it;
- a pair's class at a level is the set of the level's alleles at the
  pair's maximal count (all of them when that maximum is 0); only the
  alleles that carry an exonic variant take part at the exon level, one
  per group of equal exonic variants (the first by name), and at the
  primary level one per group of the exon level's alleles;
- abundance: the exon-level EM, expansion of the winning groups, then
  the length-normalised full-length EM over the expanded alleles;
- a read that places exactly in two genes or more of a multi-gene
  configuration is dropped, as HISAT-genotype drops an alignment with
  NH > 1 (typing_core.py:846-848); the port applies the same rule by
  cost in FamilyAligner.align_batch (hgtpu_torch/align/family.py);
- a pair is typed only when both mates place, in one gene, within
  MAX_FRAGMENT: a pair one of whose mates the NH==1 rule dropped is
  dropped whole, as the port's type_family treats it (it groups each
  gene's surviving mates by fragment, and type_gene's concordance
  filter, hgtpu_torch/typer/engine.py:_concordant, drops a fragment
  that lacks a mate unless allow_discordant is set, which the typing
  options leave off).

Not modelled: the reference aligner's trimming of read ends that an
alternative haplotype could explain (it makes a few pairs compatible
with one more allele).  The comparison's limits carry that gap; see
PERF.md.
"""
from __future__ import annotations

import math

import numpy as np

DOT = 4
_ENC = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENC[_c] = _i
_ENC[ord(".")] = DOT
KMER = 32           # placement index: exact 32-mers ...
STRIDE = 16         # ... at every 16th base of every allele
MAX_FRAGMENT = 1000  # concordant pair span, as hisat2 -X 1000
OVERHANG = 30       # bases a read may hang over a gene's end


def _leftshift(row: np.ndarray, backbone: np.ndarray) -> np.ndarray:
    """Slide each gap run of `row` left while the base left of the run
    equals the backbone base under the run's right end."""
    row = row.copy()
    n = len(row)
    is_dot = np.concatenate([[False], row == DOT, [False]])
    edges = np.flatnonzero(is_dot[1:] != is_dot[:-1])
    for s, e in zip(edges[0::2].tolist(), edges[1::2].tolist()):
        if s == 0 or e >= n:
            continue
        shift = 0
        while (s - shift - 1 >= 0 and row[s - shift - 1] < 4
               and backbone[e - shift - 1] < 4
               and row[s - shift - 1] == backbone[e - shift - 1]):
            shift += 1
        if shift:
            moved = row[s - shift:s].copy()
            row[s - shift:e - shift] = DOT
            row[e - shift:e] = moved
    return row


def _consensus(mat):
    keep = (mat != DOT).any(axis=0)
    mat = mat[:, keep]
    counts = np.stack([(mat == k).sum(axis=0) for k in range(4)])
    return mat, np.argmax(counts, axis=0).astype(np.uint8)


class RefGene:
    """One gene's catalog as the reference derives it from the MSA."""

    def __init__(self, name, spec, min_var_freq=0.0):
        self.name = name
        names = list(spec["names"])
        if names != sorted(names) or len(set(spec["rows"])) != len(names):
            raise ValueError("%s: the reference wants distinct rows under "
                             "sorted names" % name)
        self.names = names
        self.A = len(names)
        mat = _ENC[np.frombuffer("".join(spec["rows"]).encode(),
                                 np.uint8)].reshape(self.A, -1)
        if (mat == 255).any():
            raise ValueError("%s: rows hold characters outside ACGT." % name)
        mat, bb = _consensus(mat)
        mat = np.stack([_leftshift(r, bb) for r in mat])
        mat, bb = _consensus(mat)
        self.cols = [np.flatnonzero(r < 4).astype(np.int32) for r in mat]
        if min_var_freq > 0:
            # a coarser catalog: an allele's code at a column counts as
            # the backbone's where under min_var_freq % of alleles hold it
            # (the control; the configurations state 0)
            freq = np.stack([(mat == k).mean(axis=0) for k in range(5)])
            rare = freq[mat, np.arange(mat.shape[1])[None, :]] * 100 \
                < min_var_freq
            mat = np.where(rare, bb[None, :], mat)
        self.M, self.backbone = mat, bb
        self.C = mat.shape[1]
        self.seqs = [r.replace(".", "") for r in spec["rows"]]
        self.lengths = {n: len(s) for n, s in zip(names, self.seqs)}
        ref_cols = self.cols[names.index(spec["ref_allele"])]
        self.exons = [(int(ref_cols[l]), int(ref_cols[r]))
                      for l, r in spec["exons"]]
        self.primary = [self.exons[i] for i in spec["primary_exon_idx"]]
        # columns where some allele departs from the backbone, and per
        # (code, such column) the alleles holding that code, bit-packed
        diff = (mat != bb[None, :])
        self.vcols = np.flatnonzero(diff.any(axis=0))
        sub = mat[:, self.vcols]
        self.bits = np.stack([np.packbits(sub == k, axis=0,
                                          bitorder="little")
                              for k in range(5)])       # [5, A/8, nv]
        self.bits = np.ascontiguousarray(self.bits.transpose(0, 2, 1))
        self.rep = self._reps(self.exons, np.ones(self.A, bool))
        self.primary_rep = self._reps(self.primary, self.rep[0])
        self._vc = {}

    # ------------------------------------------------------------------ #
    def _variants(self, a):
        """Allele a's variants: ("S", col, col) and ("D", first, last)."""
        row, bb = self.M[a], self.backbone
        out = [("S", int(c), int(c))
               for c in np.flatnonzero((row < 4) & (row != bb))]
        dot = np.concatenate([[False], row == DOT, [False]])
        ed = np.flatnonzero(dot[1:] != dot[:-1])
        out += [("D", int(s), int(e) - 1)
                for s, e in zip(ed[0::2], ed[1::2])]
        return sorted(out, key=lambda v: (v[1], v[0]))

    def _reps(self, exons, include):
        """(rep mask, {rep: members}): alleles with an exonic variant,
        grouped by their exonic variant sets, the first of each group
        (by name) representing it."""
        groups = {}
        for a in np.flatnonzero(include):
            key = tuple(v for v in self._variants(a)
                        if any(l <= v[1] and v[2] <= r for l, r in exons))
            if key:
                groups.setdefault(key, []).append(int(a))
        mask = np.zeros(self.A, bool)
        out = {}
        for members in groups.values():
            mask[members[0]] = True
            out[members[0]] = members
        return mask, out

    # ------------------------------------------------------------------ #
    def compatible(self, x, left, right, cover_rule=False):
        """bool [A]: alleles whose rows equal allele x's over the columns
        [left, right]; with cover_rule, also those whose own deletion
        covers the whole span where x's row is the backbone's."""
        j0, j1 = np.searchsorted(self.vcols, [left, right + 1])
        if j1 > j0:
            codes = self.M[x, self.vcols[j0:j1]]
            sel = self.bits[codes, np.arange(j0, j1)]
            packed = np.bitwise_and.reduce(sel, axis=0)
            ok = np.unpackbits(packed, bitorder="little")[:self.A] \
                .astype(bool)
        else:
            ok = np.ones(self.A, bool)
        if cover_rule and left > 0 and right + 1 < self.C \
                and (self.M[x, left:right + 1]
                     == self.backbone[left:right + 1]).all():
            ok |= (self.M[:, left - 1:right + 2] == DOT).all(axis=1)
        return ok

    def span_ops(self, x, left, right):
        """Allele x's variants inside [left, right], by position."""
        if x not in self._vc:
            self._vc[x] = self._variants(x)
        return [v for v in self._vc[x] if left <= v[1] and v[2] <= right]


def clip_to_exon(left, right, ops, e_left, e_right):
    """A read span clipped to one exon, with the reference's deletion
    edge rules (get_exon_haplotypes); None when nothing is left."""
    if e_left > right or e_right < left:
        return None
    if left < e_left:
        new = None
        for kind, pos, last in ops:
            if (kind != "D" and pos >= e_left) or \
                    (kind == "D" and pos - 1 >= e_left):
                new = e_left
                break
            if kind == "D" and last + 1 >= e_left:
                new = last + 1
                break
        left = e_left if new is None else new
    if right > e_right:
        new = None
        for kind, pos, last in reversed(ops):
            if (kind != "D" and last <= e_right) or \
                    (kind == "D" and last + 1 <= e_right):
                new = e_right
                break
            if kind == "D" and pos - 1 <= e_right:
                new = pos - 1
                break
        right = e_right if new is None else new
    return (left, right) if left <= right else None


# --------------------------------------------------------------------- #
# Read placement
# --------------------------------------------------------------------- #
def _pack(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 keys of every k-mer along the last axis of a code array."""
    n = codes.shape[-1] - k + 1
    key = np.zeros(codes.shape[:-1] + (n,), np.uint64)
    for t in range(k):
        key = (key << np.uint64(2)) | codes[..., t:t + n].astype(np.uint64)
    return key


class Placer:
    """Exact placement of reads over every allele of every gene.  With
    two genes or more a read that places exactly in more than one gene
    is dropped (NH==1, module doc); with one gene the first exact hit
    is kept and the search stops there."""

    def __init__(self, genes):
        if len(genes) > 64:
            raise ValueError("the placer masks genes in 64 bits")
        self.genes = genes
        keys, owner = [], []
        for gi, g in enumerate(genes):
            for a, s in enumerate(g.seqs):
                c = _ENC[np.frombuffer(s.encode(), np.uint8)]
                pos = np.arange(0, len(s) - KMER + 1, STRIDE)
                win = c[pos[:, None] + np.arange(KMER)[None, :]]
                keys.append(_pack(win, KMER)[:, 0])
                owner.append(np.stack([np.full(len(pos), gi),
                                       np.full(len(pos), a), pos], 1))
        keys = np.concatenate(keys)
        owner = np.concatenate(owner)
        order = np.argsort(keys, kind="stable")
        self.keys, self.owner = keys[order], owner[order]
        if len(genes) > 1:
            # per distinct k-mer the bit mask of the genes holding it:
            # a read whose k-mers all lie in its hit's gene alone cannot
            # place exactly in another
            self.ukeys, first = np.unique(self.keys, return_index=True)
            bit = np.left_shift(np.uint64(1),
                                self.owner[:, 0].astype(np.uint64))
            self.gene_bits = np.bitwise_or.reduceat(bit, first)

    def place(self, seqs):
        """[(gene index, allele, first, last) or None] per read
        (forward): the allele bases the read covers."""
        if not seqs:
            return []
        L = len(seqs[0])
        if any(len(s) != L for s in seqs):
            raise ValueError("reads of one call must share a length")
        codes = _ENC[np.frombuffer("".join(seqs).encode(),
                                   np.uint8)].reshape(len(seqs), L)
        k = _pack(codes, KMER)                           # [R, L-K+1]
        lo = np.searchsorted(self.keys, k, "left")
        hi = np.searchsorted(self.keys, k, "right")
        out = []
        for i, s in enumerate(seqs):
            found = None
            for j in np.flatnonzero(hi[i] > lo[i]).tolist():
                for gi, a, p in self.owner[lo[i, j]:hi[i, j]].tolist():
                    found = self._verify(s, gi, a, p - j)
                    if found:
                        break
                if found:
                    break
            if found and len(self.genes) > 1 and \
                    self._elsewhere(s, found[0], k[i], lo[i], hi[i]):
                found = None
            out.append(found)
        return out

    def _elsewhere(self, s, gi, keys, lo, hi):
        """Whether read s also places exactly in a gene other than gi."""
        u = np.minimum(np.searchsorted(self.ukeys, keys), len(self.ukeys) - 1)
        bits = np.where(self.ukeys[u] == keys, self.gene_bits[u],
                        np.uint64(0))
        if not (np.bitwise_or.reduce(bits)
                & ~(np.uint64(1) << np.uint64(gi))):
            return False
        for j in np.flatnonzero(hi > lo).tolist():
            rows = self.owner[lo[j]:hi[j]]
            for g, a, p in rows[rows[:, 0] != gi].tolist():
                if self._verify(s, g, a, p - j):
                    return True
        return False

    def _verify(self, s, gi, a, st):
        """(gene, allele, first, last) of the read bases that lie in the
        allele when the read equals the allele there; a read may hang
        over either end of the gene by up to OVERHANG bases (it is
        clipped there, as the reference aligner clips it)."""
        seq = self.genes[gi].seqs[a]
        lo, hi = max(st, 0), min(st + len(s), len(seq))
        if lo - st > OVERHANG or st + len(s) - hi > OVERHANG:
            return None
        if seq[lo:hi] != s[lo - st:hi - st]:
            return None
        return (gi, a, lo, hi - 1)


# --------------------------------------------------------------------- #
# Classes and abundance
# --------------------------------------------------------------------- #
class Level:
    """One level's class counts and per-allele counts."""

    def __init__(self, names, include):
        self.names, self.include = names, include
        self.cmpt = {}
        self.counts = np.zeros(len(names), np.int64)

    def add(self, count):
        if not self.include.any():
            return
        mx = count[self.include].max()
        cur = (count == mx) & self.include
        self.counts += cur
        key = "-".join(sorted(self.names[i] for i in np.flatnonzero(cur)))
        self.cmpt[key] = self.cmpt.get(key, 0) + 1


def single_abundance(cmpt, remove_low=False, lengths=None):
    """HISAT-genotype's single_abundance: read-class EM with a SQUAREM
    step, L1 change under 1e-4 or 1,000 iterations, optional length
    normalisation and pruning under a tenth of the best.  [[allele,
    prob]] by prob, descending."""
    if not cmpt:
        return []
    alleles, index = [], {}
    for cls in cmpt:
        for a in cls.split("-"):
            if a not in index:
                index[a] = len(alleles)
                alleles.append(a)
    C, A = len(cmpt), len(alleles)
    M = np.zeros((C, A))
    for ci, cls in enumerate(cmpt):
        M[ci, [index[a] for a in cls.split("-")]] = 1.0
    cnt = np.array([float(v) for v in cmpt.values()])
    inv = (np.array([1.0 / lengths[a] for a in alleles])
           if lengths else np.ones(A))

    def norm(p):
        p = p * inv
        return p / p.sum()

    def step(p):
        den = M @ p
        w = np.divide(cnt, den, out=np.zeros_like(cnt), where=den > 0)
        return norm((M.T @ w) * p)

    p = norm(M.T @ (cnt / M.sum(axis=1)))
    active = np.ones(A, bool)
    diff, it = 1.0, 0
    while diff > 1e-4 and it < 1000:
        p1 = step(p)
        p2 = step(p1)
        r = p1 - p
        v = p2 - p1 - r
        vv = float(v @ v)
        if vv > 0:
            g = -math.sqrt(float(r @ r) / vv)
            p1 = step(np.maximum(0.0, p - 2 * g * r + g * g * v))
        diff = float(np.abs(p - p1).sum())
        p = p1
        if it >= 10 and remove_low and p.any():
            active &= p >= p.max() / 10.0
            p = np.where(active, p, 0.0)
        it += 1
    if remove_low and p.any():
        active &= p >= p.max() / 10.0
        p = np.where(active, p, 0.0)
    p = norm(p)
    out = [[alleles[i], float(p[i])] for i in np.flatnonzero(active)]
    out.sort(key=lambda x: x[1], reverse=True)
    return out


def _restrict(cmpt, keep):
    out = {}
    for cls, n in cmpt.items():
        k = "-".join(a for a in cls.split("-") if a in keep)
        if k:
            out[k] = out.get(k, 0) + n
    return out


def staged_abundance(gene: RefGene, full, exon):
    """Exon-representative EM, expansion of the winning groups (the
    first ten ranks, then while prob >= 0.03), length-normalised
    full-length EM over the expanded alleles."""
    exon_prob = single_abundance(exon, True)
    idx = {n: i for i, n in enumerate(gene.names)}
    sel, psum = set(), 0.0
    for rank, (a, p) in enumerate(exon_prob):
        if rank >= 10 and p < 0.03:
            break
        group = gene.rep[1].get(idx[a])
        if group and len(group) > 1:
            psum += p
            sel.update(gene.names[i] for i in group)
    if not sel:
        return exon_prob
    full_prob = single_abundance(_restrict(full, sel), True, gene.lengths)
    out = {a: p for a, p in exon_prob if a not in sel}
    for a, p in full_prob:
        out[a] = p * psum
    return sorted(([a, p] for a, p in out.items()), key=lambda x: -x[1])


def type_sample(genes, placer, reads_1, reads_2):
    """{gene: dict(num_pairs, cmpt, exon_cmpt, primary_exon_cmpt,
    counts, prob)} for one sample's pairs."""
    from gen import revcomp

    p1 = placer.place([s for _, s in reads_1])
    p2 = placer.place([revcomp(s) for _, s in reads_2])
    levels = {gi: (Level(g.names, np.ones(g.A, bool)),
                   Level(g.names, g.rep[0]), Level(g.names, g.primary_rep[0]))
              for gi, g in enumerate(genes)}
    for h1, h2 in zip(p1, p2):
        if h1 is None or h2 is None or h1[0] != h2[0]:
            continue
        gi = h1[0]
        g = genes[gi]
        spans = [(x, int(g.cols[x][first]), int(g.cols[x][last]))
                 for _, x, first, last in (h1, h2)]
        if max(s[2] for s in spans) - min(s[1] for s in spans) \
                > MAX_FRAGMENT:
            continue
        full = np.zeros(g.A, np.int32)
        exon = np.zeros(g.A, np.int32)
        prim = np.zeros(g.A, np.int32)
        for x, left, right in spans:
            full += g.compatible(x, left, right)
            ops = g.span_ops(x, left, right)
            for exons, acc in ((g.exons, exon), (g.primary, prim)):
                for el, er in exons:
                    c = clip_to_exon(left, right, ops, el, er)
                    if c is not None:
                        acc += g.compatible(x, c[0], c[1], cover_rule=True)
        for lev, cnt in zip(levels[gi], (full, exon, prim)):
            lev.add(cnt)
    out = {}
    for gi, g in enumerate(genes):
        f, e, p = levels[gi]
        out[g.name] = dict(
            num_pairs=int(sum(f.cmpt.values())), cmpt=f.cmpt,
            exon_cmpt=e.cmpt, primary_exon_cmpt=p.cmpt,
            counts={g.names[i]: int(c) for i, c in enumerate(f.counts)
                    if c},
            prob=staged_abundance(g, f.cmpt, e.cmpt))
    return out
