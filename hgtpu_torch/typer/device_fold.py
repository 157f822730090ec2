"""Whole-gene compatibility counting + class fold on the device (port of
hgtpu/typer/device_fold.py).

The reference's per-read hot spot is add_count / add_stat
(typing_core.py:626-677, 1171-1236): per read, intersect allele sets
over the read's variants, take the alleles at max compatibility, and
accumulate the resulting equivalence class.  This module runs the chain
on the device:

    sub-ht compat masks  [S, A]   (_compat — bitset AND (K2) + range counts)
    per-ht level masks   [3U, A]  (segment-sum over sub-ht projections)
    per-group counts     [G, A]   (gather + segment-sum over read groups)
    class rows           [G, A]   (counts == max over include mask)
    packed class keys    [G, W]   (bit-pack along A: 32 alleles / word)
    per-allele totals    [A]      (weighted column sum)

followed by an exact class dedup, and fetches one int32 buffer.  The host
side of ``run`` is a copy of hgtpu's, including the fetch-cap formula, so
the unpack reads the same layout.  Results are bit-identical to the host
path.
"""
from __future__ import annotations

import numpy as np
import torch

from .device_count import MAX_HT_VARS, _compat

# widest variant slot the fold takes (beyond this a single pathological
# haplotype sends the whole gene to the host path)
MAX_FOLD_VARS = 256

_M32 = 0xFFFFFFFF


def _pow2(n, lo=64):
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceFold:
    """Per-gene device state for the fused counting/fold program."""

    def __init__(self, typer):
        self.typer = typer
        self.gene = typer.gene
        self.device = typer.device
        from .engine import shared_device_counter
        self.dc = shared_device_counter(self.gene, self.device)

    def run(self, hts_sorted, novel, grouped):
        """hts_sorted: sorted unique ht strings; grouped: the engine's
        {frozenset(ht): [weight, positive_hts]} fold.

        Returns per-level [(packed_rows [G, W] uint32, weights, totals [A])]
        in level order (full, exon, primary), or None when a ht exceeds
        the device variant budget (host fallback).
        """
        from .exons import get_exon_haplotypes
        from ..utils.trace import TRACE, to_host

        with TRACE.stage("type.count_fold.prep"):
            typer = self.typer
            gene = self.gene
            U = len(hts_sorted)
            A = gene.n_alleles

            # ---- sub-ht prep: full + exon + primary projections ---- #
            # catalog-only hts project identically across runs of one gene;
            # novel-var hts ('nv' tokens) depend on the run's registry and
            # are never cached.  The cache lives on the gene's shared typing
            # state so repeat runs (and fresh GeneTyper instances) reuse it.
            from .engine import _gene_shared_state
            proj_cache = _gene_shared_state(self.gene).setdefault(
                "fold_proj_cache", {})
            sub_hts = []
            ht_seg_l = []
            kmax = 1
            for u, ht_str in enumerate(hts_sorted):
                packs = None if "nv" in ht_str else proj_cache.get(ht_str)
                if packs is None:
                    left, right, ops = typer.count_ht(ht_str, novel)
                    packs = [(0, left, right,
                              [op.var_idx for op in ops])]
                    packs += [(1, l, r, [op.var_idx for op in o])
                              for l, r, o in get_exon_haplotypes(
                                  (left, right, ops), gene.exons)]
                    packs += [(2, l, r, [op.var_idx for op in o])
                              for l, r, o in get_exon_haplotypes(
                                  (left, right, ops), gene.primary_exons)]
                    if "nv" not in ht_str and len(proj_cache) < 200_000:
                        proj_cache[ht_str] = packs
                for level, l, r, vs in packs:
                    kmax = max(kmax, sum(1 for v in vs if v >= 0))
                    sub_hts.append((l, r, vs))
                    ht_seg_l.append(level * U + u)
            if kmax > MAX_FOLD_VARS:
                return None        # pathological ht; host fallback
            K = _pow2(kmax, lo=MAX_HT_VARS)
            S = len(sub_hts)
            Sp = _pow2(S)
            lefts, rights, vars_ = self.dc.pack_hts(sub_hts, k=K)
            lefts = np.pad(lefts, (0, Sp - S))
            rights = np.pad(rights, (0, Sp - S))
            vars_ = np.pad(vars_, ((0, Sp - S), (0, 0)),
                           constant_values=gene.n_vars)
            ht_seg = np.full(Sp, 3 * U, np.int32)    # padding segment
            ht_seg[:S] = ht_seg_l

            # ---- read-group flat rows: one flat per level stacked, sharing
            # group ids ---- #
            ht_idx = {h: i for i, h in enumerate(hts_sorted)}
            flat = []
            gseg = []
            weights = np.fromiter((g[0] for g in grouped.values()),
                                  np.int64, len(grouped))
            G = len(grouped)
            for gi, (_w, positive_hts) in enumerate(grouped.values()):
                for h in positive_hts:
                    flat.append(ht_idx[h])
                    gseg.append(gi)
            F = len(flat)
            Fp = _pow2(F)
            flat = np.pad(np.asarray(flat, np.int32), (0, Fp - F))
            gseg_np = np.full(Fp, G, np.int32)       # padding group
            gseg_np[:F] = gseg

            levels = [0, 1, 2] if typer.opts.family == "hla" else [0]
            include = np.zeros((len(levels), A), dtype=bool)
            include[0] = True
            if len(levels) > 1:
                include[1] = typer.allele_rep_mask
                include[2] = typer.primary_rep_mask

            # all levels share one gather + segment-sum: concatenate each
            # level's flat rows (offset into the stacked level-mask matrix)
            # and give each level its own group-id range
            nlev = len(levels)
            flat_all = np.concatenate(
                [flat[:F] + li * U for li in levels]
                + [np.full(Fp * nlev - F * nlev, 3 * U, np.int32)])
            gseg_all = np.concatenate(
                [gseg_np[:F] + li * G for li in levels]
                + [np.full(Fp * nlev - F * nlev, G * nlev, np.int32)])

        # dispatched FLOPs for the bench's MFU, hgtpu's five terms: the
        # deletion range-count product, the AND-reduce (u32 ops), the
        # level and group segment sums, the class extraction
        D = int(self.dc.del_links.shape[0])
        W = int(self.dc.links_packed.shape[1])
        TRACE.count("flops.device_fold",
                    2.0 * Sp * D * A
                    + Sp * K * W
                    + Sp * A
                    + float(Fp) * nlev * A
                    + 3.0 * G * A * nlev)

        dc = self.dc
        LG = nlev * G
        W32 = (A + 31) // 32
        # fetch cap, identical to hgtpu's so the unpack below reads the
        # same layout: wide rows (large A) bound it at ~64k fetched words
        # while small-A panels keep full depth; the two-step path below
        # covers the rare overflow exactly
        cap = min(LG, max(512, 65536 // max(W32, 1)))
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with TRACE.stage("type.count_fold.exec"):
            buf, fs, is_first, uw, min_idx = _fold_levels(
                dc.tables(), t(lefts), t(rights), t(vars_), t(ht_seg),
                t(flat_all), t(gseg_all), t(weights.astype(np.int32)),
                t(include), n_ht_segments=3 * U + 1,
                n_group_segments=G * nlev + 1, n_groups=G, n_levels=nlev,
                n_cap=cap)
            # single fetch: unique class rows, per-class weights, order
            # keys, totals and the unique count packed into ONE buffer
            buf_h = to_host(buf).view(np.uint32)
            at = cap * W32
            rows_h = buf_h[:at].reshape(cap, W32)
            uw_h = buf_h[at:at + cap].astype(np.int64)
            min_idx_h = buf_h[at + cap:at + 2 * cap].astype(np.int64)
            at += 2 * cap
            tt_h = buf_h[at:at + nlev * A].astype(np.int64).reshape(nlev, A)
            Un = int(buf_h[-1])
            if Un > cap:
                # overflow: re-fetch through the exact two-step path
                first_rows = torch.nonzero(is_first).squeeze(1)
                Un = int(first_rows.shape[0])
                rows_h = to_host(fs[first_rows]).view(np.uint32)
                uw_h = to_host(uw[:Un]).astype(np.int64)
                min_idx_h = to_host(min_idx[:Un]).astype(np.int64)
            else:
                rows_h = rows_h[:Un]
                uw_h = uw_h[:Un]
                min_idx_h = min_idx_h[:Un]
        out = []
        for li in range(nlev):
            # reassemble per level, restoring first-seen (group) order via
            # the minimum original row index so cmpt_order stays identical
            # to the host path
            sel = np.flatnonzero((min_idx_h[:Un] // G) == li)
            order = sel[np.argsort(min_idx_h[sel], kind="stable")]
            out.append((rows_h[order],
                        uw_h[order],
                        tt_h[li]))
        return out


def _mul32(a, b):
    """(a * b) mod 2**32 for int64 tensors holding uint32 values, without
    overflowing int64: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _to_i32(x):
    """int64 tensor of uint32 values -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _fold_levels(tables, lefts, rights, vars_, ht_seg, flat_rows, group_seg,
                 weights, include_levels, n_ht_segments, n_group_segments,
                 n_groups, n_levels, n_cap):
    """All levels at once (full/exon/primary counts share the gather +
    segment-sum; class extraction per level), ending with an EXACT class
    dedup (hash sort + adjacent full-row compare) so the host fetches only
    unique class rows + per-class aggregated weights.

    Returns (buf, fs, is_first, uw, min_idx); buf is the int32 layout of
    hgtpu's uint32 single-fetch buffer."""
    dev = lefts.device
    compat = _compat(*tables, lefts, rights, vars_).to(torch.int32)  # [S, A]
    A = compat.shape[1]
    level_masks = torch.zeros((n_ht_segments, A), dtype=torch.int32,
                              device=dev).index_add_(0, ht_seg.long(), compat)
    per_read = level_masks[flat_rows.long()]                  # [F*, A]
    counts_all = torch.zeros((n_group_segments, A), dtype=torch.int32,
                             device=dev).index_add_(0, group_seg.long(),
                                                    per_read)

    W = (A + 31) // 32
    pad_A = W * 32 - A
    bitw = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, device=dev)

    packed_all, totals_all = [], []
    for li in range(n_levels):
        counts = counts_all[li * n_groups:(li + 1) * n_groups]   # [G, A]
        inc = include_levels[li]
        mx = torch.where(inc[None, :], counts,
                         torch.full_like(counts, -1)).max(dim=1).values
        cur = (counts == mx[:, None]) & inc[None, :]
        cur_pad = torch.nn.functional.pad(cur, (0, pad_A))
        packed = (cur_pad.reshape(n_groups, W, 32).to(torch.int64)
                  * bitw).sum(dim=2)                            # uint32 vals
        totals = (cur.to(torch.int32) * weights[:, None]).sum(
            dim=0, dtype=torch.int32)
        packed_all.append(packed)
        totals_all.append(totals)

    flat = torch.cat(packed_all, dim=0)                       # [LG, W]
    # 30-bit row hash with the level in the top 2 bits so levels never
    # interleave in the sort — hgtpu's uint32 hash, in int64 with every
    # product taken mod 2**32.  Collisions are harmless: equal rows always
    # share a key, and a falsely-split class is re-merged by the host's
    # np.unique in add_packed_batch.
    mixer = (torch.arange(W, dtype=torch.int64, device=dev) * 0x9E3779B9
             + 0x85EBCA77) & _M32
    h = _mul32(flat, mixer[None, :]).sum(dim=1) & _M32
    h = _mul32(h ^ (h >> 15), torch.tensor(0x2C1B3C6D, device=dev))
    lev = torch.arange(n_levels, dtype=torch.int64,
                       device=dev).repeat_interleave(n_groups)
    key = (lev << 30) | (h >> 2)
    order = torch.argsort(key, stable=True)
    fs = flat[order]                                          # [LG, W]
    key_s = key[order]
    neq = (key_s[1:] != key_s[:-1]) | (fs[1:] != fs[:-1]).any(dim=1)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    uniq_rank = torch.cumsum(is_first.to(torch.int64), dim=0) - 1
    LG = n_levels * n_groups
    w_rows = weights.repeat(n_levels)[order]
    uw = torch.zeros(LG, dtype=torch.int32, device=dev).index_add_(
        0, uniq_rank, w_rows)
    # first-seen order restoration: min original row id per unique class
    # (empty segments keep int32 max, as jax.ops.segment_min leaves them)
    min_idx = torch.full((LG,), 2**31 - 1, dtype=torch.int32,
                         device=dev).scatter_reduce(
        0, uniq_rank, order.to(torch.int32), "amin", include_self=False)
    totals = torch.stack(totals_all)

    # single-fetch packing: the first n_cap unique rows (in unique-rank
    # order) + per-class weights + order keys + totals + unique count
    up = torch.nonzero(is_first).squeeze(1)[:n_cap]
    up = torch.cat([up, torch.full((n_cap - up.shape[0],), LG,
                                   dtype=up.dtype, device=dev)])
    rows_c = fs[up.clamp(0, LG - 1)]                          # [cap, W]
    n_uniq = is_first.sum(dtype=torch.int32)
    buf = torch.cat([
        _to_i32(rows_c.reshape(-1)),
        uw[:n_cap],
        min_idx[:n_cap],
        totals.reshape(-1),
        n_uniq[None],
    ])
    return buf, _to_i32(fs), is_first, uw, min_idx
