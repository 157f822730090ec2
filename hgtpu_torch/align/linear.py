"""Linear-index alignment path (port of hgtpu/align/linear.py, on the
port's FMIndex).

Reference component #3: HISAT2/Bowtie2 with `-k 10` against the linear
index of all allele sequences (typing_common.py:995-1027; counting
consumed at typing_core.py:1597-1648).  The reference's linear run is a
REAL alignment — its default scoring (`--score-min L,0,-0.6`, mismatch
penalty 6) admits roughly one mismatch per 10 bases — so errored reads
still type.  Here: seed + verify against one FM-index over the
concatenation of every allele sequence.

  seed    — non-overlapping SEED_LEN-mers of the read, exact backward
            search (ops/fm.py), both orientations.  A read with m
            mismatches keeps >= n_seeds - m clean seeds, so any read
            within the budget is found while seeds outnumber its errors.
  verify  — vectorized Hamming check of the whole read at each candidate
            diagonal (seed position minus seed offset); the N separators
            between alleles fail overhanging candidates naturally.

Exact full-read matches are the m=0 special case and resolve on the
first seed.
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import GeneRef
from ..ops.fm import FMIndex, pack_queries
from ..utils.dna import encode_seq, revcomp

SEED_LEN = 16


class LinearAligner:
    def __init__(self, gene: GeneRef, device=None):
        self.gene = gene
        parts = []
        bounds = []
        pos = 0
        for name in gene.allele_names:
            seq = gene.allele_seq(name)
            parts.append(encode_seq(seq))
            parts.append(np.array([4], np.int8))  # N separator
            bounds.append(pos)
            pos += len(seq) + 1
        self.starts = np.array(bounds, np.int64)
        self.codes = np.concatenate(parts) if parts else np.zeros(0, np.int8)
        self.fm = FMIndex(self.codes, device=device)

    # ------------------------------------------------------------------ #
    def _default_budget(self, length: int) -> int:
        """hisat2's default acceptance window: --score-min L,0,-0.6 with
        max mismatch penalty 6 admits ~0.6*L/6 = L/10 mismatches
        (typing_common.py:1014 runs the linear aligner with default
        scoring)."""
        return max(0, length // 10)

    def allele_sets(self, seqs, max_hits=128, max_mm=None):
        """For each read: set of allele indices aligning within the
        mismatch budget (either orientation).  max_mm=None uses the
        hisat2-default-equivalent per-read budget; 0 = exact only."""
        n = len(seqs)
        if n == 0:
            return []
        lens = np.fromiter((len(s) for s in seqs), np.int64, n)
        Lmax = int(lens.max())
        read_codes = np.full((2 * n, Lmax), 4, np.int8)
        for i, s in enumerate(seqs):
            read_codes[i, : len(s)] = encode_seq(s)
            read_codes[n + i, : len(s)] = encode_seq(revcomp(s))

        # ---- seed: one exact FM batch over every seed of every read --- #
        n_seeds = max(1, Lmax // SEED_LEN)
        queries = []
        meta = []                       # (row, seed offset)
        for r in range(2 * n):
            L = int(lens[r % n])
            for k in range(n_seeds):
                off = k * SEED_LEN
                if off + SEED_LEN > L:
                    break
                queries.append(read_codes[r, off:off + SEED_LEN])
                meta.append((r, off))
        if not queries:
            return [set() for _ in range(n)]
        q = np.stack(queries)
        lo, hi = (np.asarray(x) for x in self.fm.search_batch(q))

        # ---- candidate diagonals ---- #
        cand_row = []
        cand_pos = []
        per_row_seen = [set() for _ in range(2 * n)]
        for qi, (r, off) in enumerate(meta):
            l, h = int(lo[qi]), int(hi[qi])
            if h <= l:
                continue
            for p in self.fm.locate(l, h, max_hits):
                start = int(p) - off
                if start < 0 or start + int(lens[r % n]) > len(self.codes):
                    continue
                if start in per_row_seen[r]:
                    continue
                per_row_seen[r].add(start)
                cand_row.append(r)
                cand_pos.append(start)
        results = [set() for _ in range(n)]
        if not cand_row:
            return results
        cand_row = np.asarray(cand_row, np.int64)
        cand_pos = np.asarray(cand_pos, np.int64)

        # ---- verify: vectorized Hamming over all candidates ---- #
        j = np.arange(Lmax, dtype=np.int64)
        text = self.codes[np.minimum(cand_pos[:, None] + j[None, :],
                                     len(self.codes) - 1)]
        reads = read_codes[cand_row]
        live = j[None, :] < lens[cand_row % n][:, None]
        mism = ((text != reads) & live).sum(axis=1)
        if max_mm is None:
            budget = lens[cand_row % n] // 10
        else:
            budget = np.full(len(cand_row), max_mm, np.int64)
        ok = mism <= budget
        alleles = np.searchsorted(self.starts, cand_pos[ok], "right") - 1
        for r, a in zip(cand_row[ok] % n, alleles):
            results[int(r)].add(int(a))
        return results

    def type_linear(self, seqs, max_mm=None):
        """The reference's linear-path counting (typing_core.py:1597-1648):
        per read, the allele set feeds Gene_cmpt/Gene_counts directly."""
        counts = np.zeros(self.gene.n_alleles, np.int64)
        cmpt = {}
        for alleles in self.allele_sets(seqs, max_mm=max_mm):
            if not alleles:
                continue
            names = sorted(self.gene.allele_names[a] for a in alleles)
            for a in alleles:
                counts[a] += 1
            key = "-".join(names)
            cmpt[key] = cmpt.get(key, 0) + 1
        order = np.argsort(-counts, kind="stable")
        ranked = [(self.gene.allele_names[i], int(counts[i]))
                  for i in order if counts[i] > 0]
        return ranked, cmpt
