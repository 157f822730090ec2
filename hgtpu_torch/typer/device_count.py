"""Device-side read->allele compatibility counting (port of
hgtpu/typer/device_count.py).

The device form of GeneCounter.alleles_for_ht (the reference's add_count
set algebra, typing_core.py:626-677) over whole haplotype batches:

    incl[h]  = AND over the ht's known variants of links[v]      (bitsets)
    excl[h]  = any extra allele variant overlapping [left,right]
               (prefix-sum range count minus the ht's own in-range vars)

Bit rows hold uint32 bit patterns stored as int32 (torch's uint32 support
is thin).  ``incl`` always goes through kernel K2
(``ops.compat_kernel.and_reduce``); the rest is plain torch.  The int32
product ``dmask @ del_links`` runs in float32 (CUDA torch has no integer
matmul), exact below 2**24 with TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..db.catalog import GeneRef, VT_DELETION
from .. import resolve_device
from ..utils.trace import to_host
from ..ops.compat_kernel import and_reduce, pitched

MAX_HT_VARS = 16

# device tables, in _compat's argument order
TABLES = ("links_packed", "nd_pos", "nd_prefix", "del_pos", "del_right",
          "del_links", "var_pos_d", "var_right_d")


def _as_i32(a: np.ndarray) -> np.ndarray:
    """int32 bit patterns of an integer array (uint32 reinterpreted), as
    a fresh writable copy."""
    a = np.array(a, order="C")
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


class DeviceCounter:
    """Precomputed device tables for one gene."""

    def __init__(self, gene: GeneRef, device=None, arrays=None):
        self.gene = gene
        self.device = resolve_device(device)
        A = gene.n_alleles
        self.A = A
        self.W = (A + 31) // 32
        if arrays is None:
            arrays = self.build_arrays(gene)
        for name in TABLES:
            t = torch.from_numpy(_as_i32(arrays[name])).to(self.device)
            if name == "links_packed":       # rows 16-byte aligned for K2
                t = pitched(t)
            setattr(self, name, t)

    @staticmethod
    def build_arrays(gene: GeneRef) -> dict:
        """The tables as numpy arrays, built from the gene (hgtpu's
        DeviceCounter.__init__, with links_packed in uint32)."""
        A = gene.n_alleles
        W = (A + 31) // 32
        # bitpacked link rows [V+1, W]; row V is all-ones (padding var)
        packed = np.zeros((gene.n_vars + 1, W), dtype=np.uint32)
        for v in range(gene.n_vars):
            bits = np.flatnonzero(gene.links[v])
            np.bitwise_or.at(packed[v], bits // 32,
                             np.uint32(1) << (bits % 32).astype(np.uint32))
        packed[gene.n_vars] = 0xFFFFFFFF
        nondel = gene.var_type != VT_DELETION
        ndp = np.zeros((int(nondel.sum()) + 1, A), dtype=np.int32)
        np.cumsum(gene.links[nondel].astype(np.int32), axis=0, out=ndp[1:])
        deli = np.flatnonzero(gene.var_type == VT_DELETION)
        return {
            "links_packed": packed,
            "nd_pos": gene.var_pos[nondel].astype(np.int32),
            "nd_prefix": ndp,
            "del_pos": gene.var_pos[deli].astype(np.int32),
            "del_right": gene.var_right[deli].astype(np.int32),
            "del_links": gene.links[deli].astype(np.int32),
            # per-variant (pos, right) for the kv computation
            "var_pos_d": np.concatenate([gene.var_pos.astype(np.int32), [0]]),
            "var_right_d": np.concatenate(
                [gene.var_right.astype(np.int32), [0]]),
        }

    @classmethod
    def from_arrays(cls, gene: GeneRef, arrays: dict, device=None):
        """The port's counter from another implementation's tables as
        numpy arrays keyed by TABLES — e.g. hgtpu's DeviceCounter
        attributes fetched to the host (uint32 link rows are kept as
        their int32 bit patterns)."""
        missing = [n for n in TABLES if n not in arrays]
        if missing:
            raise KeyError("missing device tables: %s" % missing)
        return cls(gene, device=device, arrays=arrays)

    def tables(self):
        return tuple(getattr(self, name) for name in TABLES)

    # ------------------------------------------------------------------ #
    def pack_hts(self, hts, k: int = MAX_HT_VARS):
        """hts: [(left, right, [var idx (>=0 known only)])] ->
        (lefts, rights, vars [H, k]) padded with the all-ones
        sentinel variant.  k must cover the widest ht (callers bucket k
        to a power of two)."""
        H = len(hts)
        lefts = np.zeros(H, np.int32)
        rights = np.zeros(H, np.int32)
        vars_ = np.full((H, k), self.gene.n_vars, np.int32)
        for i, (l, r, vs) in enumerate(hts):
            lefts[i] = l
            rights[i] = r
            ks = [v for v in vs if v >= 0][:k]
            vars_[i, :len(ks)] = ks
        return lefts, rights, vars_

    def compat_masks(self, lefts, rights, vars_):
        """[H, A] bool compatibility — device computation."""
        dev = self.device
        bits = _compat(*self.tables(), torch.from_numpy(lefts).to(dev),
                       torch.from_numpy(rights).to(dev),
                       torch.from_numpy(vars_).to(dev))
        return to_host(bits)[:, : self.A]


def _compat(links_packed, nd_pos, nd_prefix, del_pos, del_right, del_links,
            var_pos, var_right, lefts, rights, vars_):
    """[H, A] bool: incl & ~excl for every ht row."""
    W = links_packed.shape[1]
    n_sentinel = links_packed.shape[0] - 1

    # ---- incl: AND-reduce of link bitsets (kernel K2) ---- #
    incl = and_reduce(links_packed, vars_.contiguous())        # [H, W]

    # ---- excl: range counts per allele ---- #
    i0 = torch.searchsorted(nd_pos, lefts, side="left")
    i1 = torch.searchsorted(nd_pos, rights, side="right")
    cnt = nd_prefix[i1] - nd_prefix[i0]                        # [H, A]
    dmask = (((del_pos[None, :] >= lefts[:, None])
              & (del_pos[None, :] <= rights[:, None]))
             | ((del_right[None, :] >= lefts[:, None])
                & (del_right[None, :] <= rights[:, None])))
    cnt = cnt + (dmask.to(torch.float32)
                 @ del_links.to(torch.float32)).to(torch.int32)

    # ---- kv: the ht's own known vars inside the range ---- #
    vi = vars_.long()
    vp = var_pos[vi]                                           # [H, K]
    vr = var_right[vi]
    known = vars_ < n_sentinel
    in_range = (((vp >= lefts[:, None]) & (vp <= rights[:, None]))
                | ((vr >= lefts[:, None]) & (vr <= rights[:, None])))
    kv = (known & in_range).sum(dim=1, dtype=torch.int32)      # [H]

    excl = (cnt - kv[:, None]) > 0                             # [H, A]
    # unpack incl bits to [H, A_padded]; & 1 after the (arithmetic)
    # shift reads bit 31 of a negative word correctly
    bit_idx = torch.arange(W * 32, device=incl.device)
    incl_bits = (incl[:, bit_idx // 32] >> (bit_idx % 32)) & 1
    A = excl.shape[1]
    return (incl_bits[:, :A] == 1) & ~excl
