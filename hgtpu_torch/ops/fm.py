"""FM-index with batched backward search on the device (port of
hgtpu/ops/fm.py).

The counterpart of the reference's HISAT2 FM machinery (components
#1/#3: `hisat2-build` linear index + `-k` search).  The index is built
natively (SA-IS, hgtpu_torch.native) on the host with hgtpu's numpy
code; the tables then move to the device, and a query batch runs as a
loop over query positions from the right, each step a few [N] gathers
into the occurrence table and `where`s — plain torch, as hgtpu's search
is XLA and not Pallas.

Occurrence layout: full-resolution occ[i, c] (int32, 24 B/base) for
locus panels and genotype-genome regions, or (checkpoint=True) occ every
CKPT_BLOCK positions plus the BWT, counted within the block at query
time — the genome-scale layout.

XLA clamps an out-of-range gather where torch faults (a device-side
assert on CUDA): the port clamps the BWT block row explicitly and keeps
the unclamped block for the lane mask and the checkpoint row, which is
what hgtpu's `dynamic_index_in_dim` computes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..native import build_suffix_array, bwt_from_sa


CKPT_BLOCK = 64


class FMIndex:
    """FM-index over int8 base codes (A..T=0..3, N=4; sentinel 5).

    checkpoint=False keeps the full occ table (24 B/base — fastest rank,
    fine for locus panels); checkpoint=True stores occ every CKPT_BLOCK
    positions plus the BWT (≈1.5 B/base) and counts within blocks at
    query time — the genome-scale layout (SURVEY.md §7 "FM-index rank on
    TPU": checkpointed occ sized for memory, batched queries).
    """

    def __init__(self, codes: np.ndarray, checkpoint: bool = False,
                 device=None):
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        self.device = resolve_device(device)
        self.n = len(codes)
        self.checkpoint = checkpoint
        self.sa = build_suffix_array(codes)          # [n+1]
        bwt = bwt_from_sa(codes, self.sa)            # [n+1], codes 0..5
        counts = np.bincount(bwt, minlength=6)
        # C[c] = number of symbols strictly smaller (sentinel smallest)
        order = [5, 0, 1, 2, 3, 4]  # sentinel first
        c_arr = np.zeros(6, np.int64)
        total = 0
        for sym in order:
            c_arr[sym] = total
            total += counts[sym]
        self.C = c_arr.astype(np.int32)
        self._C_dev = self._dev(self.C)
        if checkpoint:
            B = CKPT_BLOCK
            n1 = len(bwt)
            nblk = (n1 + B - 1) // B
            pad = nblk * B - n1
            bwt_p = np.concatenate([bwt, np.full(pad, 5, np.int8)]) \
                if pad else bwt
            onehot = np.eye(6, dtype=np.int32)[bwt_p].reshape(nblk, B, 6)
            ckpt = np.zeros((nblk + 1, 6), np.int32)
            np.cumsum(onehot.sum(axis=1), axis=0, out=ckpt[1:])
            self._ckpt_dev = self._dev(ckpt)
            self._bwt_dev = self._dev(bwt_p.reshape(nblk, B))
            self._occ_dev = None
        else:
            onehot = np.eye(6, dtype=np.int32)[bwt]
            occ = np.concatenate(
                [np.zeros((1, 6), np.int32), np.cumsum(onehot, axis=0)],
                axis=0)
            self._occ_dev = self._dev(occ)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------ #
    def search_batch(self, queries: np.ndarray):
        """Exact backward search.

        queries: int8 [N, L] (pad with code 4/N on the LEFT — padding
        collapses the range to empty only if mid-query, so put real bases
        at the right end; use `pack_queries`).
        Returns (lo, hi) int32 numpy [N]: SA interval of each full query.
        """
        q = torch.from_numpy(np.ascontiguousarray(queries, np.int8)).to(
            self.device)
        if self.checkpoint:
            lo, hi = _search_ckpt(self._ckpt_dev, self._bwt_dev, self._C_dev,
                                  q, self.n + 1)
        else:
            lo, hi = _search(self._occ_dev, self._C_dev, q)
        return (lo.to(torch.int32).cpu().numpy(),
                hi.to(torch.int32).cpu().numpy())

    def locate(self, lo: int, hi: int, max_hits: int = 64):
        return self.sa[lo:min(hi, lo + max_hits)]

    def count(self, query_codes: np.ndarray) -> int:
        lo, hi = self.search_batch(query_codes[None])
        return int(hi[0] - lo[0])


def _backward(queries, n1, rank_pair):
    """The scan of both searches: per query, from the last position to
    the first, narrow [lo, hi) by one symbol; pad codes (>= 4) keep the
    range, a range that empties stays dead and returns (0, 0).
    rank_pair(c, lo, hi) gives the new (lo, hi) for symbol codes c."""
    N, L = queries.shape
    lo = torch.zeros(N, dtype=torch.int64, device=queries.device)
    hi = torch.full_like(lo, n1)
    alive = torch.ones(N, dtype=torch.bool, device=queries.device)
    for j in range(L - 1, -1, -1):
        c = queries[:, j].to(torch.int64)
        # codes are encode_seq's 0..5; the clamp keeps any other code
        # inside the tables (past 5 as XLA's clamp does), and every code
        # >= 4 is a pad that keeps the range anyway
        c32 = c.clamp(0, 5)
        new_lo, new_hi = rank_pair(c32, lo, hi)
        keep = (c >= 4) | ~alive
        lo = torch.where(keep, lo, new_lo)
        hi = torch.where(keep, hi, new_hi)
        alive = alive & (lo < hi)
    zero = torch.zeros_like(lo)
    return torch.where(alive, lo, zero), torch.where(alive, hi, zero)


def _search(occ, C, queries):
    n1 = occ.shape[0] - 1
    C = C.to(torch.int64)

    def rank_pair(c, lo, hi):
        base = C[c]
        return base + occ[lo, c], base + occ[hi, c]

    return _backward(queries, n1, rank_pair)


def _search_ckpt(ckpt, bwt_blocks, C, queries, n1):
    nblk, B = bwt_blocks.shape
    lane = torch.arange(B, dtype=torch.int64, device=queries.device)
    C = C.to(torch.int64)

    def rank(c, i):
        blk = i // B
        # i == n1 with n1 % B == 0 gives blk == nblk: XLA clamps the
        # block row to nblk - 1 (the lane mask below is then empty) and
        # ckpt has nblk + 1 rows; torch would fault on row nblk
        rows = bwt_blocks[blk.clamp(max=nblk - 1)]            # [N, B]
        within = ((rows.to(torch.int64) == c[:, None])
                  & (lane[None, :] < (i - blk * B)[:, None])).sum(1)
        return ckpt[blk, c].to(torch.int64) + within

    def rank_pair(c, lo, hi):
        base = C[c]
        return base + rank(c, lo), base + rank(c, hi)

    return _backward(queries, n1, rank_pair)


def pack_queries(seqs, length: int) -> np.ndarray:
    """Left-pad with N so real bases sit at the right end (processed
    first by the backward scan)."""
    from ..utils.dna import encode_seq

    out = np.full((len(seqs), length), 4, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes = encode_seq(s[-length:]) if len(s) > length else encode_seq(s)
        out[i, length - len(codes):] = codes
    return out
