# Port of hgtpu/parallel/e2e.py: the tables and the host side of
# count_classes are copies; the passes run on torch, shard by shard.
"""The production typing program of one gene over a mesh of shards.

hgtpu runs it as jitted shard_map programs over a device mesh; here each
program is plain torch run once per shard of a ``sharded.Mesh``, on that
shard's device and its contiguous block of the padded reads, and each of
hgtpu's psums is ``Mesh.psum`` (the shard bodies are generators that
yield where hgtpu sums; ``Mesh.run`` drives them in lockstep).  A mesh of
one shard runs each body once, as it is.  The per-shard buffer layouts
are hgtpu's, so the host side of ``count_classes`` is a near-verbatim
copy.  The passes, each a callable with hgtpu's inputs and outputs
(tables first, then the reads and the state tuple; a sharded output is a
tensor on a one-shard mesh, else a ``sharded.Sharded``):

1. place  — both orientations of every mate scored on kernel K1
            (``ops.placement.correlate_scores``); the argmax diagonal,
            its uniqueness bit and the wide-window candidate count that
            picks the read's spelling tier (``_place_single_p``,
            ``_place_pairs_p``);
2. spell  — hypothesis spelling against the catalog (straight diagonal,
            single and paired catalog indels), the ungated punt flags,
            the device mpileup and the tier-1 winner words
            (``_spell_single_t[t]``, ``_spell_pairs_t[t]``, or
            ``_spell_fused[m]`` with the place pass inside);
3. count  — the pileup gate against the host-merged pileup,
            compatibility as two bf16 products with a float32 output
            (``compat_mxu``), and the on-device class dedup
            (``_count_multi[(m, T)]``).

On a mesh of one local CUDA shard ``count_classes`` replays the three
passes as CUDA graphs, one per pass and padded shape
(``graphs.PassGraphs``): the same kernels on the same inputs, without
the host issuing each launch.

Beside them, hgtpu's legacy ungated programs (``_count_single``,
``_count_pairs``, ``_debug``: place, spell and count in one pass, no
pileup gate) feed the staged device EM (``_em_steps``), the front door
of ``__call__``, ``call_pairs`` and ``call_allele``.

Port notes.  hgtpu's sliding row tables are kept (the tables equal
hgtpu's array for array), but a row's entries are taken with one gather
along the row in place of the static-shift select sweep.  uint32 words
are held as int32 bit patterns and computed in int64 mod 2**32.  Top-k
orders are taken on unique integer keys, since ``torch.topk`` documents
no tie order.  Indices that XLA would clamp are clamped explicitly.
"""
from __future__ import annotations

import functools
import os
import threading

import numpy as np
import torch

from ..db.catalog import GeneRef, VT_DELETION, VT_INSERTION, VT_SINGLE
from ..utils.trace import TRACE, to_host
from .. import resolve_device
from ..ops.placement import backbone_pwm, correlate_scores, encode_reads
from ..typer.device_count import DeviceCounter
from ..typer.device_fold import _M32, _mul32, _pow2, _to_i32
from .graphs import PassGraphs, outside_graph
from .sharded import REP, SHARD, Mesh, Replicated

MAX_SNP_ALTS = 3    # catalog alts per backbone position (A/C/G/T minus ref)
MAX_INDEL_CAND = 4  # catalog indels probed per read (2 anchors each)
MAX_INS_LEN = 16    # longest insertion spellable on-device
MAX_FRAG = 1000     # hisat2 -X 1000 concordance bound

# compat_mxu's products have a float32 output: integer counts are exact
# below this bound
COUNT_EXACT = 1 << 24

_HYP_BITS = 8       # hypothesis index bits of the top-2 key (H < 256)


def _snp_tables(gene: GeneRef, length: int):
    """Per-position catalog SNP lookup: snp_alt [L, MAX_SNP_ALTS] int8
    (7 = no entry) and snp_var [L, MAX_SNP_ALTS] int32 (sentinel =
    n_vars).  One gather per read base answers "is this mismatch a known
    variant, and which" — the device form of the Zs tag."""
    alt = np.full((length, MAX_SNP_ALTS), 7, np.int8)
    var = np.full((length, MAX_SNP_ALTS), gene.n_vars, np.int32)
    fill = np.zeros(length, np.int8)
    for vi in np.flatnonzero(gene.var_type == VT_SINGLE):
        p = int(gene.var_pos[vi])
        k = int(fill[p])
        if k < MAX_SNP_ALTS:
            alt[p, k] = "ACGT".index(gene.var_data[vi])
            var[p, k] = vi
            fill[p] = k + 1
    return alt, var


def _indel_tables(gene: GeneRef):
    """Sorted catalog indel table + a sentinel row (index D): position
    (2^30 — never in any read window), length 0, var id = n_vars (the
    all-ones padding row of the link bitsets)."""
    idx = np.flatnonzero((gene.var_type == VT_DELETION)
                         | (gene.var_type == VT_INSERTION))
    D = len(idx)
    pos = np.full(D + 1, 1 << 30, np.int32)
    ln = np.zeros(D + 1, np.int32)
    is_ins = np.zeros(D + 1, np.int8)
    ivar = np.full(D + 1, gene.n_vars, np.int32)
    ins_enc = np.full((D + 1, MAX_INS_LEN), 7, np.int8)
    for k, vi in enumerate(idx):
        pos[k] = gene.var_pos[vi]
        ivar[k] = vi
        if gene.var_type[vi] == VT_INSERTION:
            is_ins[k] = 1
            seq = gene.var_data[vi]
            if len(seq) <= MAX_INS_LEN:
                ln[k] = len(seq)
                for j, b in enumerate(seq):
                    ins_enc[k, j] = "ACGT".index(b)
            # longer insertions stay length 0: the hypothesis degenerates
            # to the straight diagonal and the read punts to the host
        else:
            ln[k] = gene.var_len[vi]
    order = np.argsort(pos[:D], kind="stable")
    for arr in (pos, ln, is_ins, ivar):
        arr[:D] = arr[order]
    ins_enc[:D] = ins_enc[order]
    return pos, ln, is_ins, ivar, ins_enc


def max_overlap(gene: GeneRef, span: int) -> int:
    """The most catalog variants whose [pos, right] meets one window of
    `span` backbone positions — a bound on every count compat_mxu takes
    over a haplotype whose span is at most that long."""
    if not gene.n_vars:
        return 0
    pos = np.sort(gene.var_pos.astype(np.int64))
    right = np.sort(gene.var_right.astype(np.int64))
    lo = np.arange(int(pos[0]) - span, int(right[-1]) + 1, dtype=np.int64)
    # variants with pos <= hi, less those ending before lo (pos <= right)
    n = (np.searchsorted(pos, lo + span - 1, side="right")
         - np.searchsorted(right, lo, side="left"))
    return int(n.max())


def count_product(x: torch.Tensor, links_f: torch.Tensor) -> torch.Tensor:
    """x @ links_f for bf16 operands with a float32 output, as hgtpu's
    ``preferred_element_type=jnp.float32``: the counts stay exact above
    bf16's 256.  On CUDA the product is one cuBLAS bf16 GEMM with f32
    accumulate and output; on the CPU (no bf16 -> f32 mm there) the same
    operands, exact in float32, are multiplied in float32."""
    if x.is_cuda:
        return torch.mm(x, links_f, out_dtype=torch.float32)
    return x.float() @ links_f.float()


def tables_from_arrays(arrays, device=None):
    """The port's device tables from numpy arrays in ShardedTyper's table
    order — its own, or hgtpu's ``ShardedTyper._tables`` fetched to the
    host.  Integer tables become int32 as jax stores them (uint32 words
    as their int32 bit patterns); uint8, int8 and bool stay; float tables
    are float32, and the link matrix (a bfloat16 array, or a bfloat16
    tensor) is bfloat16."""
    dev = resolve_device(device)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a.to(dev))
            continue
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        elif a.dtype == np.uint32:
            t = torch.from_numpy(a.view(np.int32).copy())
        elif a.dtype in (np.int64, np.uint16, np.int16):
            t = torch.from_numpy(a.astype(np.int32))
        elif a.dtype == np.float64:
            t = torch.from_numpy(a.astype(np.float32))
        else:
            t = torch.from_numpy(a.copy())
        out.append(t.to(dev))
    return tuple(out)


def _floor_log2(x, n_levels):
    """floor(log2(x)) for int tensors 1 <= x < 2**n_levels, exact at every
    power of two (a float log2 may round below one)."""
    k = torch.zeros_like(x)
    for b in range(1, n_levels):
        k += (x >= (1 << b)).to(x.dtype)
    return k


def _ss(seq, v, right=False):
    """jnp.searchsorted as int32 (side 'left' unless `right`)."""
    return torch.searchsorted(seq, v.contiguous(), right=right,
                              out_int32=True)


def _take(a, w):
    """a[i, w[i]] per row (jnp.take_along_axis with a [n] index)."""
    return torch.gather(a, 1, w[:, None].long())[:, 0]


def _rc(reads):
    """Reverse complement of int8 codes (N and pads stay 4)."""
    f = torch.flip(reads, [1])
    return torch.where(f < 4, 3 - f, torch.full_like(f, 4))


def _bitpack(m, n_loc):
    """[n_loc] bool -> [(n_loc + 31) // 32] int32 words, bit i of word w =
    m[32 w + i]."""
    npw = (n_loc + 31) // 32
    bw = torch.ones(32, dtype=torch.int64, device=m.device) \
        << torch.arange(32, device=m.device)
    pad = torch.nn.functional.pad(m.to(torch.int64), (0, npw * 32 - n_loc))
    return _to_i32((pad.reshape(npw, 32) * bw).sum(1))


def _top2(score):
    """(top_v [n, 2] float32, top_i [n, 2] int32) of integer-valued
    scores >= -1 over H < 2**_HYP_BITS columns, descending, the lower
    column first among equal scores — lax.top_k(score, 2)'s order —
    taken on the unique key (score + 1) * 2^8 + (255 - h); the -1
    sentinel stays below every real score's keys."""
    H = score.shape[1]
    if H >= 1 << _HYP_BITS:
        raise ValueError("too many hypothesis columns: %d" % H)
    low = (1 << _HYP_BITS) - 1
    h = torch.arange(H, dtype=torch.int64, device=score.device)
    key = ((score.to(torch.int64) + 1) << _HYP_BITS) | (low - h)
    top = torch.topk(key, 2, dim=1).values
    return (((top >> _HYP_BITS) - 1).to(torch.float32),
            (low - (top & low)).to(torch.int32))


def _k_smallest(x, k):
    """The k smallest values of each row, ascending (hgtpu's
    -lax.top_k(-x, k)[0]; only the values matter)."""
    return torch.sort(x, dim=1).values[:, :k]


def _winner_word(causes, l, use_r, tier1):
    """(causes << 28) | (max(l, 0) << 2) | (use_r << 1) | tier1 mod 2**32
    as int32 bit patterns — hgtpu's uint32 winner word."""
    w = ((causes.to(torch.int64) << 28)
         | (l.clamp(min=0).to(torch.int64) << 2)
         | (use_r.to(torch.int64) << 1)
         | tier1.to(torch.int64)) & _M32
    return _to_i32(w)


def _first_rows(is_first, cap):
    """Indices of the first `cap` True entries, padded with len(is_first):
    jnp.nonzero(is_first, size=cap, fill_value=LG), without waiting for
    the device as torch.nonzero does."""
    LG = is_first.shape[0]
    iota = torch.arange(LG, dtype=torch.int64, device=is_first.device)
    return torch.sort(torch.where(is_first, iota,
                                  torch.full_like(iota, LG))).values[:cap]


def _row_take(rows, off, j, off_lo, off_hi, init):
    """rows[..., off_lo + off + j]: the entry hgtpu's static-shift select
    sweep over off in [-off_lo, off_hi] picks from a fetched row, as one
    gather; an offset outside the sweep keeps `init`, as the sweep's
    initial plane did."""
    idx = (off_lo + off + j).clamp(0, rows.shape[-1] - 1).long()
    idx = idx.expand(*rows.shape[:-1], idx.shape[-1])
    v = torch.gather(rows, -1, idx)
    inr = (off >= -off_lo) & (off <= off_hi)
    return torch.where(inr, v, torch.full_like(v, init))


class ShardedTyper:
    """One gene's typing programs over a mesh of shards (``mesh``; by
    default one shard on ``device``).

    The production front door is ``count_classes(r1[, r2])``: the
    place/spell pass, the host pileup merge, and the pileup-gated count
    pass that returns packed per-level equivalence classes, totals, the
    pileup and the punt mask, for the host to merge with rescued reads and
    run the staged EM (``parallel.production``).

    The pure-device programs (hgtpu's legacy ungated path): call the
    object with an [N, read_len] int8 code batch (pad code 4), or
    ``call_pairs(r1, r2)`` with two [Npair, read_len] mate batches;
    returns (prob [A], totals [A], n_used, punt [N]): one place+spell
    pass with K1, the ungated count, and the staged SQUAREM EM on the
    device (``em_iters`` caps each level).  ``call_allele`` names the top
    allele.  On a mesh whose group spans ranks these programs take each
    rank's rows and return the replicated result (``count_em_global``);
    ``count_classes`` runs on a mesh local to the process only.
    """

    def __init__(self, gene: GeneRef, device=None, read_len: int = 100,
                 max_novel: int = 2, em_iters: int = 1000,
                 min_score_frac: float = 0.9,
                 max_ht_vars: int = 16, family: str = "hla",
                 max_indel_cand: int = MAX_INDEL_CAND,
                 with_primary: bool = False, class_cap: int = 2048,
                 mesh: Mesh = None):
        # class_cap bounds the fetch buffer of unique class rows; the
        # effective cap (count_classes) is budget-adaptive, as hgtpu's
        if mesh is None:
            mesh = Mesh([resolve_device(device)])
        elif device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.gene = gene
        self.mesh = mesh
        self.device = dev = mesh.devices[0]
        self.read_len = read_len
        self.family = family
        self.max_novel = max_novel
        self.n_devices = mesh.size
        ipos_np, ilen_np, iins_np, _, _ = _indel_tables(gene)
        max_shift = int(ilen_np.max()) if len(ilen_np) else 0
        # gene-level hypothesis ceiling: the densest WIDE window any read
        # can see bounds every read's candidate count, so a gene whose
        # ceiling is small spells its whole batch in ONE fused place+spell
        # pass at that ceiling
        D_real = len(ipos_np) - 1
        if D_real > 0:
            _p = ipos_np[:D_real].astype(np.int64)
            _hi = np.searchsorted(_p, _p + read_len + 3 * max_shift,
                                  side="right")
            max_cw = int((_hi - np.arange(D_real)).max())
        else:
            max_cw = 0
        self._fused_ns = min(max_cw, max_indel_cand)
        ins_lens = ilen_np[iins_np == 1]
        ins_cap = int(ins_lens.max()) if len(ins_lens) else 0
        del_lens = ilen_np[(iins_np == 0)]
        del_cap = int(del_lens.max()) if len(del_lens) else 0
        pad = read_len + max_shift
        pwm = backbone_pwm(gene)
        pwm_ext = np.concatenate(
            [pwm, np.zeros((read_len, 5), np.float32)])
        bb_ext = np.concatenate(
            [gene.backbone_enc, np.full(pad, 4, np.int8)]).astype(np.int8)
        snp_alt, snp_var = _snp_tables(gene, len(bb_ext))
        ind_pos, ind_len, ind_ins, ind_var, ins_enc = _indel_tables(gene)
        # packed per-position match mask: bit b (0-3) = base b matches
        # the backbone or a catalog SNP alt there; bit 4 = in-backbone
        mask_np = np.zeros(len(bb_ext), np.uint8)
        inb = bb_ext < 4
        mask_np[inb] = (np.uint8(16)
                        | (np.uint8(1) << bb_ext[inb].astype(np.uint8)))
        for k in range(MAX_SNP_ALTS):
            hasalt = snp_alt[:, k] < 4
            mask_np[hasalt] |= (np.uint8(1)
                                << snp_alt[hasalt, k].astype(np.uint8))
        # sliding-window ROW tables: rows[b, t] = table[b - OFF_LO + t];
        # a lookup at base + j + off(j) (off the piecewise indel shift,
        # bounded by the stacked indel lengths) is one row fetch per
        # (read, hypothesis) plus one gather along the row
        OFF_LO = 2 * ins_cap
        OFF_HI = 2 * max_shift
        Wrow = read_len + OFF_LO + OFF_HI + 1
        self._offs = (OFF_LO, OFF_HI, Wrow)

        def _rows_of(tbl_1d, dtype, fill=0):
            padded = np.concatenate([
                np.full(OFF_LO, fill, dtype), tbl_1d.astype(dtype),
                np.full(Wrow, fill, dtype)])
            return np.lib.stride_tricks.sliding_window_view(
                padded, Wrow)[:len(bb_ext)].copy()

        mask_rows = _rows_of(mask_np, np.uint8)
        bb_rows = _rows_of(bb_ext, np.int8, fill=4)
        dc = DeviceCounter.build_arrays(gene)
        # counting tables: the add_count set algebra as two matmuls (see
        # compat_mxu) — links as a dense bf16 [V, A] matrix (0/1 entries)
        links_f = torch.from_numpy(gene.links.astype(np.float32)).to(
            torch.bfloat16)
        # per-(position, base) catalog SNP id (sentinel = none)
        av_np = np.full((len(bb_ext), 4), gene.n_vars, np.int32)
        for k in range(MAX_SNP_ALTS):
            hasalt = snp_alt[:, k] < 4
            av_np[hasalt, snp_alt[hasalt, k]] = snp_var[hasalt, k]
        # u16-packed per-(pos, base) SNP ids for the ROW lookup (two
        # bases per u32 word; sentinel = n_vars)
        if gene.n_vars >= (1 << 16) - 1:
            raise ValueError("catalog too large for packed av rows")
        avu = av_np.astype(np.uint32)
        av01_np = avu[:, 0] | (avu[:, 1] << 16)
        av23_np = avu[:, 2] | (avu[:, 3] << 16)
        sent_pack = np.uint32(gene.n_vars | (gene.n_vars << 16))
        self._tables = tables_from_arrays((
            pwm_ext, bb_ext, snp_alt, snp_var,
            ind_pos, ind_len, ind_ins, ind_var, ins_enc,
            dc["links_packed"], dc["nd_pos"], dc["nd_prefix"],
            dc["del_pos"], dc["del_right"], dc["del_links"],
            dc["var_pos_d"], dc["var_right_d"],
            mask_np, links_f, av_np, mask_rows, bb_rows,
            _rows_of(av01_np, np.uint32, fill=int(sent_pack)),
            _rows_of(av23_np, np.uint32, fill=int(sent_pack))), dev)
        n_tables = len(self._tables)
        sent_pack_i32 = int(np.array(sent_pack).view(np.int32))

        sentinel = gene.n_vars
        # the packed gate word carries the correction variant id in
        # bits 12-31 (rep_of)
        if gene.n_vars >= (1 << 19):
            raise ValueError("catalog too large for gate word")
        A = gene.n_alleles
        self.A = A
        P_bb = len(gene.backbone)
        self.P_bb = P_bb
        D = len(ind_pos) - 1
        # ht variant-slot width: sized from the catalog's densest
        # read-window so device haplotypes never silently truncate; an
        # overflowing read (>= K real vars) punts to the host rescue
        K = max_ht_vars
        if gene.n_vars:
            vp_sorted = np.sort(gene.var_pos.astype(np.int64))
            hi = np.searchsorted(vp_sorted, vp_sorted + read_len
                                 + max_shift + 1, side="left")
            k_need = int((hi - np.arange(len(vp_sorted))).max()) + 3
            K = max(max_ht_vars, ((k_need + 7) // 8) * 8)
        self._K = K
        # every count of compat_mxu's products is at most the variants
        # meeting one haplotype span (spans are at most Wrow - 1 wide: W
        # read positions moved by the stacked indel offsets) or the K
        # variant slots of the haplotype itself; raise rather than let a
        # count round
        self._max_count = max(max_overlap(gene, Wrow - 1), K)
        if self._max_count >= COUNT_EXACT:
            raise ValueError(
                "compat_mxu: a count could reach %d, which float32 does not "
                "hold exactly (bound %d)" % (self._max_count, COUNT_EXACT))
        corr_cap = max(1, max_novel)   # error_correct rejection budget
        is_hla = family == "hla"

        # hierarchical exon staging state: representative alleles
        # grouped by identical exonic variant sets, exon intervals for
        # on-device ht clipping
        staged = is_hla and bool(gene.exons) and A > 1
        self._staged = staged
        self._rep_mask_np = np.zeros(A, bool)
        self._primary_mask_np = np.zeros(A, bool)
        if staged:
            from ..typer.engine import get_rep_alleles
            exon_vars = gene.exonic_var_mask(gene.exons)
            rep_mask, rep_groups = get_rep_alleles(gene, exon_vars)
            staged = bool(rep_mask.any())
            self._staged = staged
            self._rep_mask_np = rep_mask
            self._rep_groups = rep_groups
            if with_primary and gene.primary_exons:
                primary_vars = gene.exonic_var_mask(gene.primary_exons)
                pmask, pgroups = get_rep_alleles(gene, primary_vars,
                                                 rep_mask)
                self._primary_mask_np = pmask
                self._primary_groups = pgroups
        self._with_primary = (with_primary and self._staged
                              and self._primary_mask_np.any())
        n_shards = mesh.size

        def programs(dev):
            """The per-shard bodies of every program, their constants on
            `dev`; a body that psums is a generator (Mesh.run)."""
            progs = {}

            def i32(a):
                return torch.tensor(a, dtype=torch.int32, device=dev)

            n_exons = len(gene.exons)
            ex_l = i32([e[0] for e in gene.exons] or [0])
            ex_r = i32([e[1] for e in gene.exons] or [-1])
            n_pexons = len(gene.primary_exons)
            px_l = i32([e[0] for e in gene.primary_exons] or [0])
            px_r = i32([e[1] for e in gene.primary_exons] or [-1])
            var_isdel_d = torch.from_numpy(np.concatenate(
                [gene.var_type == VT_DELETION, [False]])).to(dev)

            # alternative-haplotype end-trim gate: the host's may_trim reach
            # test as device RMQ tables — a read that MAY be end-trimmed by
            # identify_ambiguous_diffs punts to the host rescue
            from ..typer.engine import ensure_alt_gate
            La, Lt, Ra, Rt = ensure_alt_gate(gene)

            def _pack_rmq(tabs, fill):
                Kt = len(tabs)
                N = max(len(tabs[0]), 1)
                out = np.full((Kt, N), fill, np.int64)
                for kk, t in enumerate(tabs):
                    out[kk, :len(t)] = t
                return torch.from_numpy(out.astype(np.int32)).to(dev)

            self._gate_n = (len(La), len(Ra))
            La_d = torch.from_numpy(La.astype(np.int32)).to(dev)
            Ra_d = torch.from_numpy(Ra.astype(np.int32)).to(dev)
            Lt_d = _pack_rmq(Lt, (1 << 30)) if len(La) else None
            Rt_d = _pack_rmq(Rt, -(1 << 30)) if len(Ra) else None

            def may_trim_dev(l, r):
                """Device twin of GeneTyper.may_trim over winner spans."""
                out = torch.zeros(l.shape, dtype=torch.bool, device=dev)

                def rmq(tab, a_pos, side_val, op, cmp):
                    i0 = _ss(a_pos, l)
                    i1 = _ss(a_pos, r, right=True)
                    ln = i1 - i0
                    kq = _floor_log2(ln.clamp(min=1), tab.shape[0])
                    w = torch.ones_like(kq) << kq
                    N = tab.shape[1]
                    kl = kq.long()
                    q = op(tab[kl, i0.clamp(max=N - 1).long()],
                           tab[kl, (i1 - w).clamp(0, N - 1).long()])
                    return (ln > 0) & cmp(q, side_val)

                if self._gate_n[0]:
                    out = out | rmq(Lt_d, La_d, l, torch.minimum,
                                    lambda q, v: q <= v)
                if self._gate_n[1]:
                    out = out | rmq(Rt_d, Ra_d, r, torch.maximum,
                                    lambda q, v: q >= v)
                return out

            # production class levels: full always; exon / primary-exon when
            # the staged hierarchy applies
            self._levels = [("full", np.ones(A, bool))]
            if self._staged:
                self._levels.append(("exon", self._rep_mask_np))
            if self._with_primary:
                self._levels.append(("primary", self._primary_mask_np))
            NLEV = len(self._levels)
            include_d = torch.from_numpy(
                np.stack([m for _, m in self._levels])).to(dev)

            # static pair-hypothesis combos over the sorted candidate slots:
            # each pair (u, v), u < v, is probed with 3 anchor modes
            PAIR_COMBOS = tuple((u, v)
                                for u in range(max_indel_cand)
                                for v in range(u + 1, max_indel_cand))
            def arange(n, dtype=torch.int32):
                return torch.arange(n, dtype=dtype, device=dev)

            def place_mates(tabs, reads):
                """Stage 1: K1 placement scores, both orientations.
                Returns (s0, use_r, uniq_diag, cand_wide) — the argmax
                diagonal per read, the placement-uniqueness bit the tier-1
                rescue needs, and the candidate count in the WIDE window
                [s0 - 2*max_shift, s0 + W + max_shift] that assigns the
                read's spelling tier."""
                pwm_ext = tabs[0]
                ind_pos_t = tabs[4]
                W = reads.shape[1]
                # K1 out of the pass graphs: each launch a Python call
                s_f = outside_graph(correlate_scores, pwm_ext, reads)
                s_r = outside_graph(correlate_scores, pwm_ext, _rc(reads))

                # top-2 via max/argmax + masked second max; torch.argmax
                # returns the first maximum, as jnp.argmax does
                def top2(s):
                    bst = s.max(1).values
                    arg = torch.argmax(s, 1).to(torch.int32)
                    iota = arange(s.shape[1])[None, :]
                    sec = torch.where(iota == arg[:, None],
                                      torch.full_like(s, -float("inf")),
                                      s).max(1).values
                    return bst, arg, sec

                best_f, arg_f, sec_f = top2(s_f)
                best_r, arg_r, sec_r = top2(s_r)
                use_r = best_r > best_f
                s0 = torch.where(use_r, arg_r, arg_f)
                # unique best placement across diagonals AND orientations
                best = torch.maximum(best_f, best_r)
                second = torch.maximum(torch.where(use_r, sec_r, sec_f),
                                       torch.where(use_r, best_f, best_r))
                lo = _ss(ind_pos_t[:D], s0 - 2 * max_shift)
                hi = _ss(ind_pos_t[:D], s0 + W + max_shift, right=True)
                return s0, use_r, second < best, hi - lo

            def hyp_columns(n_single, pair_combos):
                """The hypothesis columns of one spelling: straight, then
                (prefix, suffix) per single candidate, then 3 anchor
                modes per pair combo, each as (candidate slot of ca, of
                cb (None: the sentinel row D), anchor code, is a pair).
                Anchor codes: 0 = s0, 1 = s0 - sh_a, 2 = s0 - sh_a - sh_b."""
                cols = [(None, None, 0, False)]
                cols += [(c, None, 0, False) for c in range(n_single)]
                cols += [(c, None, 2, False) for c in range(n_single)]
                cols += [(u, v, anc, True) for (u, v) in pair_combos
                         for anc in (0, 1, 2)]
                if len(cols) == 1:
                    # keep H >= 2 so the top-2 is well-formed: one dud
                    # column (invalid, score -1, never ties)
                    cols.append((None, None, 0, True))
                return cols

            # (anchor codes, is-pair flags) [1, H] of every spelling the
            # programs run, keyed by (n_single, pair_combos); filled below
            hyp_cols = {}

            def mate_spell(tabs, reads, placed=None, pair_combos=(),
                           n_single=max_indel_cand):
                """Stage 2 for one mate batch, PRE-gating: hypothesis
                scoring, winner/tie per-base planes.

                Every hypothesis claims up to TWO catalog indels (ca, cb)
                with pos_a < pos_b; singles carry the sentinel row D for cb.
                Read offset j maps to

                    bbpos(j) = s_a + j + (j>=b_a)*dl_a - (j>=b_a+il_a)*il_a
                                       + (j>=b_b)*dl_b - (j>=b_b+il_b)*il_b

                anchored at s_a = s0 (prefix), s0 - sh_a (middle), or
                s0 - sh_a - sh_b (suffix); b_a = pos_a - s_a and
                b_b = pos_b - s_a - sh_a."""
                (ind_pos, ind_len, ind_ins, ind_var, ins_enc) = tabs[4:9]
                bb_ext_t = tabs[1]
                n, W = reads.shape
                Lbb = bb_ext_t.shape[0]
                if placed is None:
                    s0, use_r, uniq_diag, _cw = place_mates(tabs, reads)
                else:
                    s0, use_r, uniq_diag = placed
                oriented = torch.where(use_r[:, None], _rc(reads), reads)

                # straight-diagonal pre-scan for the perfect-read rule
                mask_rows_t = tabs[20]
                mk0 = mask_rows_t[s0.clamp(0, Lbb - 1).long(),
                                  OFF_LO:OFF_LO + W]
                cu0 = oriented.clamp(max=4).to(torch.uint8)
                ok0 = ((mk0 >> cu0) & 1) == 1
                valid0 = (oriented < 4) & (((mk0 >> 4) & 1) == 1)
                score0 = (ok0 & valid0).sum(1)
                rl_all = (oriented < 4).sum(1)
                straight_perfect = ((score0 == rl_all) & (rl_all == W)
                                    & (s0 >= 0) & (s0 + W <= P_bb))

                # candidates: the max_indel_cand catalog indels at/after
                # s0 - max_shift
                c0 = _ss(ind_pos[:D], s0 - max_shift)
                cand = (c0[:, None] + arange(max_indel_cand)[None, :]
                        ).clamp(max=D)
                cand = torch.where(
                    ind_pos[cand.long()] <= s0[:, None] + W + max_shift,
                    cand, torch.full_like(cand, D))                  # [n, C]
                sent_col = torch.full((n, 1), D, dtype=torch.int32,
                                      device=dev)

                def col(slot):
                    return sent_col if slot is None \
                        else cand[:, slot:slot + 1]

                cols = hyp_columns(n_single, pair_combos)
                ca = torch.cat([col(c[0]) for c in cols], 1)         # [n, H]
                cb = torch.cat([col(c[1]) for c in cols], 1)
                # per-column constants, on the device since the build
                anc, pair_col = hyp_cols[n_single, pair_combos]
                H = ca.shape[1]
                cal, cbl = ca.long(), cb.long()

                zero = torch.zeros((), dtype=torch.int32, device=dev)
                dl_a = torch.where(ind_ins[cal] == 0, ind_len[cal], zero)
                il_a = torch.where(ind_ins[cal] == 1, ind_len[cal], zero)
                dl_b = torch.where(ind_ins[cbl] == 0, ind_len[cbl], zero)
                il_b = torch.where(ind_ins[cbl] == 1, ind_len[cbl], zero)
                sh_a = dl_a - il_a
                sh_b = dl_b - il_b
                s_a = (s0[:, None]
                       - torch.where(anc >= 1, sh_a, zero)
                       - torch.where(anc == 2, sh_b, zero))          # [n, H]
                p_a = ind_pos[cal]
                p_b = ind_pos[cbl]
                b_a = p_a - s_a
                b_b = p_b - s_a - sh_a

                jj = arange(W)[None, None, :]
                ba3, bb3 = b_a[..., None], b_b[..., None]
                ila3, ilb3 = il_a[..., None], il_b[..., None]
                dla3, dlb3 = dl_a[..., None], dl_b[..., None]
                after_a = jj >= ba3
                after_ai = jj >= ba3 + ila3
                after_b = jj >= bb3
                after_bi = jj >= bb3 + ilb3
                in_ins_a = (ila3 > 0) & after_a & ~after_ai
                in_ins_b = (ilb3 > 0) & after_b & ~after_bi
                in_ins = in_ins_a | in_ins_b
                # mask value at s_a + j + off(j): one row fetch per
                # hypothesis + one gather along it.  bit c = base matches
                # backbone-or-catalog-SNP, bit 4 = in-backbone
                off = (torch.where(after_a, dla3, zero)
                       - torch.where(after_ai, ila3, zero)
                       + torch.where(after_b, dlb3, zero)
                       - torch.where(after_bi, ilb3, zero))         # [n, H, W]
                # [n, H, Wrow]
                mrow = mask_rows_t[s_a.clamp(0, Lbb - 1).long()]
                mk = _row_take(mrow, off, jj, OFF_LO, OFF_HI, 0)
                c = oriented[:, None, :]
                cu = c.clamp(max=4).to(torch.uint8)
                ok_bb = ((mk >> cu) & 1) == 1
                exp_valid = ((mk >> 4) & 1) == 1
                # inserted bases against each candidate's spelled insertion:
                # read offset j inside the insertion is its base j - b
                t_a = (jj - ba3).clamp(0, MAX_INS_LEN - 1).long()
                t_b = (jj - bb3).clamp(0, MAX_INS_LEN - 1).long()
                ok_ins = ((in_ins_a
                           & (c == torch.gather(ins_enc[cal], 2, t_a)))
                          | (in_ins_b
                             & (c == torch.gather(ins_enc[cbl], 2, t_b))))
                valid = (c < 4) & (exp_valid | in_ins)
                okall = torch.where(in_ins, ok_ins, ok_bb) & valid
                score = okall.sum(2).to(torch.float32)              # [n, H]
                n_novel = (valid & ~okall).sum(2, dtype=torch.int32)
                n_valid = valid.sum(2, dtype=torch.int32)

                # hypothesis validity: real candidate(s), in-backbone start,
                # every break strictly inside the read; a pair column whose
                # cb degenerated to the sentinel is INVALID
                rl = (oriented < 4).sum(1, dtype=torch.int32)[:, None]
                real_a = ca < D
                real_b = cb < D
                ok_a = ((s_a >= 0) & (b_a >= 1) & (b_a + il_a <= rl - 1)
                        & (b_a <= rl - 1) & ((dl_a > 0) | (il_a > 0)))
                ok_b = ((b_b >= b_a + il_a) & (b_b + il_b <= rl - 1)
                        & (b_b <= rl - 1) & ((dl_b > 0) | (il_b > 0)))
                ok_h = (real_a & ok_a
                        & torch.where(pair_col, real_b & ok_b, ~real_b))
                straight = torch.zeros((n, H), dtype=torch.bool, device=dev)
                straight[:, 0] = True
                score = torch.where(straight | ok_h, score,
                                    torch.full_like(score, -1.0))

                # top-2 hypotheses: the winner spells the read; an EQUAL-cost
                # runner-up is an alternative spelling whose class unions
                # in.  Ties break toward the straight diagonal (column 0),
                # then single-indel spellings before pairs
                top_v, top_i = _top2(score)
                tie2 = (top_v[:, 1] == top_v[:, 0]) & (top_v[:, 1] >= 0.0)

                def planes_of(w):
                    """Per-base [n, W] planes of hypothesis column w [n],
                    recomputed from the hypothesis scalars, with row lookups
                    for the backbone base and the packed SNP ids."""
                    s_w = _take(s_a, w)
                    ba_w = _take(b_a, w)
                    bb_w = _take(b_b, w)
                    dla_w = _take(dl_a, w)
                    ila_w = _take(il_a, w)
                    dlb_w = _take(dl_b, w)
                    ilb_w = _take(il_b, w)
                    pa_w = _take(p_a, w)
                    pb_w = _take(p_b, w)
                    ca_w = _take(ca, w)
                    cb_w = _take(cb, w)
                    j = arange(W)[None, :]
                    aft_a = j >= ba_w[:, None]
                    aft_ai = j >= (ba_w + ila_w)[:, None]
                    aft_b = j >= bb_w[:, None]
                    aft_bi = j >= (bb_w + ilb_w)[:, None]
                    ins_a_w = (ila_w[:, None] > 0) & aft_a & ~aft_ai
                    ins_b_w = (ilb_w[:, None] > 0) & aft_b & ~aft_bi
                    in_ins_w = ins_a_w | ins_b_w
                    off_w = (torch.where(aft_a, dla_w[:, None], zero)
                             - torch.where(aft_ai, ila_w[:, None], zero)
                             + torch.where(aft_b, dlb_w[:, None], zero)
                             - torch.where(aft_bi, ilb_w[:, None], zero))
                    bbpos_w = s_w[:, None] + j + off_w
                    gp_w = bbpos_w.clamp(0, Lbb - 1)
                    base = s_w.clamp(0, Lbb - 1).long()
                    bb_w_base = _row_take(tabs[21][base], off_w, j, OFF_LO,
                                          OFF_HI, 4)
                    a01 = _row_take(tabs[22][base], off_w, j, OFF_LO, OFF_HI,
                                    sent_pack_i32)
                    a23 = _row_take(tabs[23][base], off_w, j, OFF_LO, OFF_HI,
                                    sent_pack_i32)
                    cc = oriented
                    valid_w = (cc < 4) & ((bb_w_base < 4) | in_ins_w)
                    match_w = valid_w & ~in_ins_w & (cc == bb_w_base)
                    mism_w = valid_w & ~match_w & ~in_ins_w
                    avv = torch.where(cc < 2, a01, a23)
                    # the low or high u16 of the word (mask after the
                    # arithmetic shift)
                    var16 = (avv >> (16 * (cc & 1)).to(torch.int32)) & 0xFFFF
                    var_w = torch.where(mism_w, var16,
                                        torch.full_like(var16, sentinel))
                    span = torch.where(
                        ins_a_w, pa_w[:, None],
                        torch.where(ins_b_w, pb_w[:, None], bbpos_w))
                    l = torch.where(valid_w, span,
                                    torch.full_like(span, 1 << 30)
                                    ).min(1).values
                    r = torch.where(valid_w, span,
                                    torch.full_like(span, -1)).max(1).values
                    return dict(
                        gp=gp_w, in_ins=in_ins_w, valid=valid_w,
                        var=var_w, match=match_w,
                        l=l, r=r, sa=s_w,
                        iva=ind_var[ca_w.long()], ivb=ind_var[cb_w.long()],
                        pa=pa_w, pb=pb_w, dla=dla_w, dlb=dlb_w)

                win = top_i[:, 0]
                return dict(
                    oriented=oriented, use_r=use_r, cand=cand, tie2=tie2,
                    uniq_diag=uniq_diag, straight_perfect=straight_perfect,
                    score_w=_take(score, win), n_novel_w=_take(n_novel, win),
                    n_valid_w=_take(n_valid, win),
                    W=planes_of(win), T=planes_of(top_i[:, 1]))

            def pile_contrib(sp, include):
                """Device mpileup contribution of one mate batch's winner
                spellings: aligned bases into the A/C/G/T columns, the
                claimed catalog deletions' spans into the D column.
                `include` [n] bool: the pair-concordance + placement-sanity
                gate.  Returns a flat [P_bb * 6] int32 count vector
                (integer scatter-adds: exact in any order)."""
                h = sp["W"]
                gp, c = h["gp"], sp["oriented"]
                pos_ok = (h["valid"] & ~h["in_ins"]
                          & (gp < P_bb) & include[:, None])
                idx = gp.clamp(0, P_bb - 1) * 6 + c.clamp(0, 3)
                pile = torch.zeros(P_bb * 6, dtype=torch.int32, device=dev)
                pile.index_add_(0, idx.reshape(-1).long(),
                                pos_ok.reshape(-1).to(torch.int32))
                if del_cap > 0:
                    k = arange(del_cap)
                    for pv, dl in ((h["pa"], h["dla"]), (h["pb"], h["dlb"])):
                        claims = (dl > 0) & include
                        didx = pv.clamp(0, P_bb - 1)[:, None] + k[None, :]
                        dmask = (claims[:, None] & (k[None, :] < dl[:, None])
                                 & (didx < P_bb))
                        pile.index_add_(
                            0, (didx.clamp(0, P_bb - 1).reshape(-1) * 6
                                + 5).long(),
                            dmask.reshape(-1).to(torch.int32))
                return pile

            def rep_of(tabs, pile_flat):
                """Per-position gate words from the final pileup
                (Mpileup.finalize; ref thresholds typing_common.py:1124-1134):
                  bits 0-7  rep_pack (bit b = base b is representative)
                  bit 8     single (exactly one representative base)
                  bit 9     the single rep base equals the backbone base
                  bits 12+  catalog SNP id of the single rep base
                            (sentinel = n_vars)
                plus their sliding-window rows [P_bb, Wrow]."""
                bb_ext_t = tabs[1]
                av_tbl = tabs[19]
                pile = pile_flat.reshape(P_bb, 6)
                total = pile.sum(1)
                acgt = pile[:, :4]
                keep = ((total >= 20)[:, None]
                        & ((acgt * 5 >= total[:, None]) | (acgt >= 7)))
                rep_pack = (keep.to(torch.int32) << arange(4)[None, :]).sum(
                    1, dtype=torch.int32)
                single = keep.sum(1) == 1
                b = torch.argmax(keep.to(torch.int32), 1)       # first True
                bbv = bb_ext_t[:P_bb].to(torch.int64)
                corr = torch.where(
                    single, av_tbl[arange(P_bb, torch.int64), b.clamp(0, 3)],
                    torch.full((P_bb,), sentinel, dtype=torch.int32,
                               device=dev))
                gate_tbl = (rep_pack
                            | (single.to(torch.int32) << 8)
                            | ((single & (b == bbv)).to(torch.int32) << 9)
                            | (corr << 12))
                # zero pad rows -> rp == 0 -> never flagged out of range
                gpad = torch.cat([
                    torch.zeros(OFF_LO, dtype=torch.int32, device=dev),
                    gate_tbl,
                    torch.zeros(Wrow, dtype=torch.int32, device=dev)])
                gate_rows = gpad.unfold(0, Wrow, 1)[:P_bb]
                return rep_pack, pile, gate_rows

            def gate_hyp(tabs, sp, h, rep):
                """Pileup re-gating of one hypothesis's per-base
                classification — the device twin of error_correct
                (typing_core.py:119-243).  Returns (gated var plane [n, W],
                corrections counted [n], supported-novel count [n])."""
                _rp, _pile, gate_rows = rep
                gp, c = h["gp"], sp["oriented"]
                W_g = gp.shape[1]
                pos_ok = h["valid"] & ~h["in_ins"]
                in_bb = gp < P_bb
                # off(j) recovered from the stored absolute positions;
                # offsets outside the sweep (clipped positions past the
                # backbone) resolve to tv == 0 -> never flagged
                jg = arange(W_g)[None, :]
                off_w = gp - h["sa"][:, None] - jg
                grow = gate_rows[h["sa"].clamp(0, P_bb - 1).long()]
                tv = _row_take(grow, off_w, jg, OFF_LO, OFF_HI, 0)
                rp = tv & 0xFF
                cu = c.clamp(0, 3).to(torch.int32)
                sup = ((rp >> cu) & 1) == 1
                ra = (rp != 0) & in_bb
                flagged = pos_ok & ra & ~sup
                single = ((tv >> 8) & 1) == 1
                single_is_bb = ((tv >> 9) & 1) == 1
                # correction target: the single representative base — to the
                # backbone (neutral: av sentinel), a catalog alt (that
                # variant), or N / multi-rep (neutral unknown)
                sent = torch.full_like(tv, sentinel)
                corr_var = torch.where(flagged & single, tv >> 12, sent)
                var_new = torch.where(flagged, corr_var, h["var"])
                # reference num_correction bookkeeping: every flagged base in
                # a match run counts; a flagged mismatch counts only when
                # corrected back to the backbone base
                corr_counted = flagged & (
                    h["match"] | (single & single_is_bb))
                known_new = var_new < sentinel
                novel_new = pos_ok & ~h["match"] & ~known_new & ~flagged
                return (var_new,
                        corr_counted.sum(1, dtype=torch.int32),
                        novel_new.sum(1, dtype=torch.int32))

            def clip_ht_w(var_pos_d, var_right_d, l, r, vars_, k,
                          win_l, win_r, n_win):
                """Intersect an ht with its k-th overlapping window from
                (win_l, win_r) (get_exon_haplotypes, typer/exons.py).
                Non-overlapping windows degenerate to the all-compatible
                uniform row, which leaves the argmax class unchanged."""
                first = _ss(win_r, l)
                wi = (first + k).clamp(max=max(n_win - 1, 0)).long()
                el, er = win_l[wi], win_r[wi]
                ok = (first + k < n_win) & (el <= r) & (er >= l)
                big = torch.full_like(l, 1 << 30)
                neg = torch.full_like(l, -1)
                lc = torch.where(ok, torch.maximum(l, el), big)
                rc = torch.where(ok, torch.minimum(r, er), neg)
                vl = vars_.long()
                vp = var_pos_d[vl]
                vr = var_right_d[vl]
                isd = var_isdel_d[vl]
                # host deletion-edge rule: a deletion straddling the clipped
                # left edge advances the edge to one past the deletion;
                # straddling the right edge pulls it to one before
                stl = isd & (vp - 1 < lc[:, None]) & (vr >= lc[:, None])
                lc = torch.maximum(lc, torch.where(
                    stl, vr + 1,
                    torch.full_like(vr, -(1 << 30))).max(1).values)
                stri = isd & (vr + 1 > rc[:, None]) & (vp - 1 <= rc[:, None])
                rc = torch.minimum(rc, torch.where(
                    stri, vp - 1, torch.full_like(vp, 1 << 30)).min(1).values)
                ok = ok & (lc <= rc)
                lc = torch.where(ok, lc, big)
                rc = torch.where(ok, rc, neg)
                keep = torch.where(
                    isd,
                    (vp - 1 >= lc[:, None]) & (vr + 1 <= rc[:, None]),
                    (vp >= lc[:, None]) & (vp <= rc[:, None]))
                vc = torch.where(ok[:, None] & keep, vars_,
                                 torch.full_like(vars_, sentinel))
                return lc, rc, vc

            def k_smallest(h, var_pl):
                """The ht's K smallest variant ids, ascending."""
                return _k_smallest(torch.cat(
                    [var_pl, h["iva"][:, None], h["ivb"][:, None]], 1), K)

            def claimed_in_span(tabs, sp, l, r):
                """(claimed, in_span) [n, C]: candidates the winner (or its
                equal-cost tie) claims, and candidates inside [l - max_shift,
                r]."""
                Wh, Th = sp["W"], sp["T"]
                tie2 = sp["tie2"]
                cand = sp["cand"]
                cl = cand.long()
                cv = tabs[7][cl]
                claimed = ((cv == Wh["iva"][:, None])
                           | (cv == Wh["ivb"][:, None])
                           | (tie2[:, None]
                              & ((cv == Th["iva"][:, None])
                                 | (cv == Th["ivb"][:, None]))))
                cpos = tabs[4][cl]
                in_span = ((cand < D)
                           & (cpos >= l[:, None] - max_shift)
                           & (cpos <= r[:, None]))
                return claimed, in_span

            def mate_flags(tabs, sp):
                """Ungated punt predictor, computable BEFORE the pileup.

                Pre-punted reads are EXCLUDED from the device pileup (their
                winner spelling may be mis-framed), because the host rescue
                adds their HOST alignments to the pileup instead.  Returns
                (passed_u, amb_all, tier1, causes)."""
                Wh, Th = sp["W"], sp["T"]
                tie2 = sp["tie2"]
                n_valid_w = sp["n_valid_w"]
                nv = n_valid_w.to(torch.float32)
                passed_u = ((sp["n_novel_w"] <= max_novel) & (n_valid_w > 0)
                            & (sp["score_w"] >= min_score_frac * nv))
                claimed, in_span = claimed_in_span(tabs, sp, Wh["l"], Wh["r"])
                # ambiguous when (A) residual novels remain next to an
                # unclaimed in-span candidate, or (B) the winner claims
                # indels and an unclaimed candidate could combine into an
                # equal-cost multi-indel spelling the hypothesis set CANNOT
                # represent (see hgtpu's mate_flags for the cases)
                cl = sp["cand"].long()
                (ind_len_t, ind_ins_t) = (tabs[5], tabs[6])
                claims2 = ((Wh["ivb"] < sentinel)
                           | (tie2 & (Th["ivb"] < sentinel)))
                claims1 = (((Wh["iva"] < sentinel)
                            | (tie2 & (Th["iva"] < sentinel)))
                           & ~claims2)
                cpos = tabs[4][cl]
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                dl_c = torch.where(ind_ins_t[cl] == 0, ind_len_t[cl], zero)
                il_c = torch.where(ind_ins_t[cl] == 1, ind_len_t[cl], zero)
                # exact representability of the combined spelling (claimed
                # chain + unclaimed candidate Y): the break of Y in the
                # winner frame is b_Y = pos_Y - l - sum of the claimed
                # shifts before Y; +-2 edge slack absorbs the l ~ s_a
                # approximation at clipped spans
                sh_c = (dl_c - il_c) * claimed
                before = cpos[:, :, None] < cpos[:, None, :]
                shift_before = (sh_c[:, :, None] * before).sum(1)
                rl_f = (sp["oriented"] < 4).sum(1)[:, None]
                b_est = cpos - Wh["l"][:, None] - shift_before
                unrep = (b_est <= 2) | (b_est >= rl_f - 2 - il_c)
                # only geometrically OVERLAPPING combos are unrepresentable
                for h in (Wh, Th):
                    gate = (tie2 if h is Th else
                            torch.ones_like(tie2))[:, None]
                    for pk, dk in (("pa", "dla"), ("pb", "dlb")):
                        gap_a = cpos - h[pk][:, None]
                        unrep = unrep | (gate & (gap_a >= 1)
                                         & (gap_a <= h[dk][:, None] - 1))
                        gap_b = h[pk][:, None] - cpos
                        unrep = unrep | (gate & (gap_b >= 1)
                                         & (gap_b <= dl_c - 1))
                # 3-chains are outside the hypothesis space: a winner that
                # already claims TWO indels keeps the wide window
                EDGE_L = max_shift + 32
                near_edge_l = ((cpos <= Wh["l"][:, None] + EDGE_L)
                               | (cpos >= Wh["r"][:, None] - EDGE_L))
                free = in_span & ~claimed
                amb_u = ((free.any(1) & (sp["n_novel_w"] > 0))
                         | (claims1 & (free & unrep).any(1))
                         | (claims2 & (free & near_edge_l).any(1)))

                v1u = k_smallest(Wh, Wh["var"])
                v2u = k_smallest(Th, Th["var"])
                # alt-haplotype end-trim ambiguity (host: may_trim ->
                # identify_ambiguous_diffs) — handed to the host rescue
                trimmy = may_trim_dev(Wh["l"], Wh["r"])
                if self._gate_n[0] or self._gate_n[1]:
                    trimmy = trimmy | (tie2 & may_trim_dev(Th["l"], Th["r"]))
                # equal-cost DIVERGENT spellings: the host reports the
                # aligner's single tie-broken alignment, so defer to it
                tie_div = (tie2 & ~sp["straight_perfect"]
                           & ((v1u != v2u).any(1)
                              | (Wh["l"] != Th["l"])
                              | (Wh["r"] != Th["r"])))
                # variant-slot overflow: >= K catalog variants in the span
                trunc = v1u[:, K - 1] < sentinel
                # tier-1 rescue eligibility: the device winner IS the host
                # aligner's unique best alignment
                tier1 = (passed_u & ~amb_u & ~tie_div & sp["uniq_diag"])
                causes = (amb_u.to(torch.int64)
                          | (trimmy.to(torch.int64) << 1)
                          | (tie_div.to(torch.int64) << 2)
                          | (trunc.to(torch.int64) << 3))
                return (passed_u, amb_u | trimmy | tie_div | trunc, tier1,
                        causes)

            def compat_mxu(tabs, lefts, rights, vars_):
                """[Hn, A] bool compatibility — the add_count set algebra
                (typing_core.py:626-677) as TWO products:

                    cnt(h,a) = Σ_v in_range(h,v) * links[v,a]
                    own(h,a) = Σ_{v ∈ ht_h}      * links[v,a]
                    incl = (own == n_own);  excl = (cnt - kv) > 0

                in_range is the reference's overlap rule per variant
                ((pos ∈ [l,r]) | (right ∈ [l,r])).  bf16 operands (0/1 and
                small counts) for the tensor cores, a float32 output
                (``count_product``): exact because every count stays below
                COUNT_EXACT, which the constructor checked
                (self._max_count)."""
                (var_pos_d, var_right_d) = tabs[15:17]
                links_f = tabs[18]
                V = links_f.shape[0]
                Hn = lefts.shape[0]
                l = lefts[:, None]
                r = rights[:, None]
                vp = var_pos_d[:V][None, :]
                vr = var_right_d[:V][None, :]
                in_r = (((vp >= l) & (vp <= r))
                        | ((vr >= l) & (vr <= r)))                 # [Hn, V]
                # one-hot accumulate of the ht's variant slots; sentinel
                # slots (== V) land in the dropped last column
                M2 = torch.zeros((Hn, V + 1), dtype=torch.bfloat16, device=dev)
                M2.scatter_add_(1, vars_.long(), torch.ones(
                    vars_.shape, dtype=torch.bfloat16, device=dev))
                prod = count_product(
                    torch.cat([in_r.to(torch.bfloat16), M2[:, :V]], 0),
                    links_f)
                cnt, own = prod[:Hn], prod[Hn:]
                real = vars_ < V
                n_own = real.sum(1).to(torch.float32)
                vl = vars_.long()
                kvp = var_pos_d[vl]
                kvr = var_right_d[vl]
                k_in = ((((kvp >= l) & (kvp <= r))
                         | ((kvr >= l) & (kvr <= r))) & real)
                kv = k_in.sum(1).to(torch.float32)
                incl = own >= (n_own - 0.5)[:, None]
                excl = (cnt - kv[:, None]) > 0.5
                return incl & ~excl

            def mate_counts(tabs, sp, rep, want_px, pre_amb=None):
                """Stages 2b-3 + counting masks for one spelled mate batch,
                gated against the final pileup `rep`; rep None disables the
                pileup gate (the legacy programs).  pre_amb (production) is
                mate_flags' ungated ambiguity, OR'd in so the final punt is
                a superset of the pileup exclusion.
                Returns (cnt, cnt_ex, cnt_px, passed, needs_host)."""
                var_pos_d, var_right_d = tabs[15], tabs[16]
                n = sp["oriented"].shape[0]
                Wh, Th = sp["W"], sp["T"]
                tie2 = sp["tie2"]
                n_valid_w = sp["n_valid_w"]
                if rep is None:
                    varW, varT = Wh["var"], Th["var"]
                    n_corr = torch.zeros(n, dtype=torch.int32, device=dev)
                    novel_resid = sp["n_novel_w"]
                else:
                    varW, n_corr, novel_resid = gate_hyp(tabs, sp, Wh, rep)
                    varT, _, _ = gate_hyp(tabs, sp, Th, rep)
                l1, r1, v1 = Wh["l"], Wh["r"], k_smallest(Wh, varW)
                l2, r2, v2 = Th["l"], Th["r"], k_smallest(Th, varT)

                # -- 3. verify gate -------------------------------------- #
                nv = n_valid_w.to(torch.float32)
                passed = ((sp["n_novel_w"] <= max_novel) & (n_valid_w > 0)
                          & (sp["score_w"] >= min_score_frac * nv)
                          & (n_corr <= corr_cap))
                if rep is not None and is_hla:
                    # deletion-plausibility misalignment heuristic
                    # (typing_core.py:1064-1077), for BOTH claimed indels
                    _rp, pile, _gt = rep
                    for pv, dl in ((Wh["pa"], Wh["dla"]),
                                   (Wh["pb"], Wh["dlb"])):
                        pvc = pv.clamp(0, P_bb - 1).long()
                        delp_ok = pile[pvc, 5] * 6 >= pile[pvc, :5].sum(1)
                        passed = passed & ((dl == 0) | delp_ok)
                # residual novel edits (or pileup corrections) next to a
                # catalog indel the spelling does not claim: punt
                claimed, in_span = claimed_in_span(tabs, sp, l1, r1)
                ambiguous = ((in_span & ~claimed).any(1)
                             & ((novel_resid + n_corr) > 0))
                if pre_amb is not None:
                    ambiguous = ambiguous | pre_amb
                needs_host = (~passed | ambiguous) & (n_valid_w > 0)
                passed = passed & ~ambiguous

                # -- 5. compatibility masks (winner + tied alt, at the full
                # level plus up to 2 exon-clipped windows, + 2 primary-exon
                # windows for the primary level) -- #
                groups = [(l1, r1, v1), (l2, r2, v2)]
                wins = []
                if staged:
                    wins.append((ex_l, ex_r, n_exons))
                if want_px:
                    wins.append((px_l, px_r, n_pexons))
                for wl, wr, nw in wins:
                    for k in (0, 1):
                        groups.append(clip_ht_w(var_pos_d, var_right_d,
                                                l1, r1, v1, k, wl, wr, nw))
                        groups.append(clip_ht_w(var_pos_d, var_right_d,
                                                l2, r2, v2, k, wl, wr, nw))
                masks = compat_mxu(tabs,
                                   torch.cat([g[0] for g in groups]),
                                   torch.cat([g[1] for g in groups]),
                                   torch.cat([g[2] for g in groups]))
                m = [masks[i * n:(i + 1) * n].to(torch.int32)
                     for i in range(len(groups))]
                # equal-cost tie union — but a perfect-straight read is
                # resolved as the straight spelling alone by the host, so the
                # production path must not union its tie (the legacy
                # device-EM path keeps the union)
                tie_cnt = (tie2 if rep is None
                           else tie2 & ~sp["straight_perfect"])[:, None]
                cnt = m[0] + m[1] * tie_cnt
                at = 2
                if staged:
                    cnt_ex = (m[at] + m[at + 2]
                              + (m[at + 1] + m[at + 3]) * tie_cnt)
                    at += 4
                else:
                    cnt_ex = cnt
                if want_px:
                    cnt_px = (m[at] + m[at + 2]
                              + (m[at + 1] + m[at + 3]) * tie_cnt)
                else:
                    cnt_px = cnt
                return cnt, cnt_ex, cnt_px, passed, needs_host

            def mate_pipeline(tabs, reads):
                """Legacy single-pass path (ungated), kept bit-identical for
                the pure-device EM programs and their tests."""
                sp = mate_spell(tabs, reads)
                cnt, cnt_ex, _, passed, needs_host = mate_counts(
                    tabs, sp, None, False)
                return (cnt, cnt_ex, passed, sp["use_r"], sp["W"]["l"],
                        sp["W"]["r"], needs_host)

            # every `yield x` below is hgtpu's psum(x, axis) (Mesh.run)
            def finish(cnt, cnt_ex, w, punt):
                """Stage-5 epilogue: weighted full-level class totals.
                cnt/cnt_ex [n, A] int compatibility counts, w [n] f32."""
                w = w * (1.0 - punt.to(torch.float32))
                mx = cnt.max(1).values
                cls = ((cnt == mx[:, None])
                       & (w > 0)[:, None]).to(torch.float32)
                totals = yield cls.T @ w
                n_used = yield w.sum()
                return cnt, cnt_ex, w, totals, n_used, punt

            def shard_single(*args):
                tabs, reads = args[:n_tables], args[n_tables]
                cnt, cnt_ex, passed, _, _, _, needs_host = \
                    mate_pipeline(tabs, reads)
                p = passed[:, None].to(torch.int32)
                return (yield from finish(cnt * p, cnt_ex * p,
                                          passed.to(torch.float32),
                                          needs_host))

            def shard_pairs(*args):
                tabs, r1, r2 = args[:n_tables], args[n_tables], \
                    args[n_tables + 1]
                c1, ce1, ok1, o1, l1, rr1, nh1 = mate_pipeline(tabs, r1)
                c2, ce2, ok2, o2, l2, rr2, nh2 = mate_pipeline(tabs, r2)
                # -- 4. concordance (typing_core.py:826-852) ------------- #
                span = torch.maximum(rr1, rr2) - torch.minimum(l1, l2)
                conc = (o1 != o2) & (span <= MAX_FRAG)
                used = conc & (ok1 | ok2)
                k1 = ok1[:, None].to(torch.int32)
                k2 = ok2[:, None].to(torch.int32)
                cnt = c1 * k1 + c2 * k2
                cnt_ex = ce1 * k1 + ce2 * k2
                punt = conc & (nh1 | nh2)
                return (yield from finish(cnt, cnt_ex,
                                          used.to(torch.float32), punt))

            def shard_debug(*args):
                tabs, reads = args[:n_tables], args[n_tables]
                cnt, _, passed, use_r, lefts, rights, needs_host = \
                    mate_pipeline(tabs, reads)
                return (cnt, passed, use_r, lefts, rights, needs_host)

            progs["count_single"] = shard_single
            progs["count_pairs"] = shard_pairs
            progs["debug"] = shard_debug

            # -- 6. staged SQUAREM EM over the device-resident classes -- #
            lens_a = gene.allele_lengths()
            inv_len_d = torch.from_numpy(np.array(
                [1.0 / lens_a[a] for a in gene.allele_names],
                np.float32)).to(dev)

            def em_shard(remove_low, use_len, cnt, w, include, restrict):
                """One EM level (the reference's single_abundance,
                typing_common.py:1282-1410): per-read class = argmax of the
                compatibility counts over `include`d alleles (add_stat,
                typing_core.py:1171-1236), intersected with the `restrict`
                set from the previous stage (the hierarchical staging of
                typing_core.py:1679-1789); SQUAREM with L1 diff < 1e-4,
                `em_iters` cap, optional low-abundance pruning and length
                normalization.  The loop's condition is read on the host
                each iteration, as lax.while_loop evaluates it; on a mesh
                of several shards every shard takes it from the psum of
                their flags, so no shard or rank stops alone."""
                mxv = torch.where(include[None, :], cnt,
                                  torch.full_like(cnt, -1)).max(1).values
                cls = ((cnt == mxv[:, None]) & include[None, :]
                       & restrict[None, :] & (w > 0)[:, None])
                M = cls.to(torch.float32)
                wl = w * cls.any(1)

                def norm(p):
                    if use_len:
                        p = p * inv_len_d
                    return p / p.sum().clamp(min=1e-30)

                def nxt(p):
                    denom = M @ p
                    qv = torch.where(denom > 0, wl / denom.clamp(min=1e-30),
                                     torch.zeros_like(denom))
                    return norm((yield M.T @ qv) * p)

                def go_on(diff, it):
                    if it >= em_iters:
                        return False
                    flag = diff > 1e-4
                    if n_shards > 1:
                        flag = (yield flag.to(torch.int32)) > 0
                    return bool(flag)

                sizes = M.sum(1).clamp(min=1.0)
                p = norm((yield M.T @ (wl / sizes)))
                diff = torch.ones((), dtype=torch.float32, device=dev)
                it = 0
                while (yield from go_on(diff, it)):
                    p1 = yield from nxt(p)
                    p2 = yield from nxt(p1)
                    r = p1 - p
                    v = p2 - p1 - r
                    ssv = (v * v).sum()
                    gamma = -torch.sqrt((r * r).sum() / ssv.clamp(min=1e-30))
                    accel = (p - 2 * gamma * r + gamma * gamma * v).clamp(
                        min=0.0)
                    p_new = torch.where(ssv > 0.0, (yield from nxt(accel)), p1)
                    diff = (p_new - p).abs().sum()
                    if remove_low and it >= 10:
                        p_new = torch.where(p_new >= p_new.max() / 10.0, p_new,
                                            torch.zeros_like(p_new))
                    p = p_new
                    it += 1
                if remove_low:
                    p = torch.where(p >= p.max() / 10.0, p,
                                    torch.zeros_like(p))
                return norm(p)

            for key in ((False, False), (True, False), (True, True)):
                progs[("em",) + key] = functools.partial(em_shard, *key)

            # ------------------------------------------------------------- #
            # production class packing (pileup-gated)
            # ------------------------------------------------------------- #
            W32 = (A + 31) // 32
            self._W32 = W32
            self._class_cap = class_cap
            self._NLEV = NLEV
            bitw32 = torch.ones(32, dtype=torch.int64, device=dev) \
                << torch.arange(32, device=dev)

            def pack_classes(cnts, w_used, punt, excl, n_reads_m, n_loc):
                """On-device class dedup + single-buffer packing (the
                device_fold._fold_levels scheme): per level, the argmax-count
                class row of every used pair is bit-packed along A; rows of
                all levels hash-sort together (level in the top 2 key bits)
                and adjacent-compare dedup yields unique rows + aggregated
                weights.  uint32 values are carried in int64 here.  No step
                waits for the device (no nonzero, no boolean indexing)."""
                wi = w_used.to(torch.int32)
                pad_A = W32 * 32 - A
                packed_all, totals_all = [], []
                for li in range(NLEV):
                    inc = include_d[li]
                    mx = torch.where(inc[None, :], cnts[li],
                                     torch.full_like(cnts[li], -1)
                                     ).max(1).values
                    cur = ((cnts[li] == mx[:, None]) & inc[None, :]
                           & (wi > 0)[:, None])
                    cur_pad = torch.nn.functional.pad(cur, (0, pad_A))
                    packed = (cur_pad.reshape(n_loc, W32, 32).to(torch.int64)
                              * bitw32).sum(2)
                    totals = yield (cur.to(torch.int32) * wi[:, None]).sum(
                        0, dtype=torch.int32)
                    packed_all.append(packed)
                    totals_all.append(totals)
                LG = NLEV * n_loc
                flat = torch.cat(packed_all, 0)                    # [LG, W32]
                mixer = (arange(W32, torch.int64) * 0x9E3779B9
                         + 0x85EBCA77) & _M32
                h = _mul32(flat, mixer[None, :]).sum(1) & _M32
                h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
                lev = arange(NLEV, torch.int64).repeat_interleave(n_loc)
                key = (lev << 30) | (h >> 2)
                order = torch.argsort(key, stable=True)
                fs = flat[order]
                key_s = key[order]
                neq = (key_s[1:] != key_s[:-1]) \
                    | (fs[1:] != fs[:-1]).any(1)
                is_first = torch.cat(
                    [torch.ones(1, dtype=torch.bool, device=dev), neq])
                uniq_rank = torch.cumsum(is_first.to(torch.int64), 0) - 1
                w_rows = wi.repeat(NLEV)[order]
                uw = torch.zeros(LG, dtype=torch.int32, device=dev).index_add_(
                    0, uniq_rank, w_rows)
                # empty segments keep int32 max, as segment_min leaves them
                min_idx = torch.full((LG,), 2**31 - 1, dtype=torch.int32,
                                     device=dev).scatter_reduce(
                    0, uniq_rank, order.to(torch.int32), "amin",
                    include_self=False)
                # budget-adaptive fetch cap — must mirror count_classes'
                # unpack formula exactly (buffer layout contract)
                cap = min(class_cap, LG, max(512, 65536 // max(W32, 1)))
                up = _first_rows(is_first, cap)
                rows_c = fs[up.clamp(0, LG - 1)]
                n_uniq = is_first.sum()
                counters = torch.stack([
                    n_uniq, n_reads_m.to(torch.int64), wi.sum(),
                    punt.sum()]).to(torch.int64)
                return (rows_c, uw[:cap], min_idx[:cap],
                        torch.stack(totals_all), _bitpack(punt, n_loc),
                        _bitpack(excl, n_loc), counters, fs, is_first, uw,
                        min_idx)

            def winner_info(sp, tier1, causes):
                """Per-read tier-1 rescue words: punt causes in the top
                nibble (bit28 amb, 29 trim, 30 tie, 31 trunc), then
                (span_l << 2) | (rc << 1) | tier1, mod 2**32; plus the two
                claimed catalog indel ids (sentinel = none)."""
                return [_winner_word(causes, sp["W"]["l"], sp["use_r"], tier1),
                        sp["W"]["iva"], sp["W"]["ivb"]]

            def assemble_buf_b(packed):
                """Count-pass output: one buffer (int32 bit patterns of
                hgtpu's uint32 words: class rows + weights + first-seen +
                totals + punt/excl words + counters) plus the
                full-resolution overflow leaves."""
                (rows_c, uw_c, min_c, totals, punt_words, excl_words,
                 counters, fs, is_first, uw, min_idx) = packed
                buf = torch.cat([
                    _to_i32(rows_c.reshape(-1)),
                    uw_c,
                    min_c,
                    totals.reshape(-1),
                    punt_words,
                    excl_words,
                    _to_i32(counters),
                ])
                return buf, _to_i32(fs), is_first, uw, min_idx

            # ---- production two-pass protocol -------------------------- #
            # Pass A (spell): placement + hypothesis spelling + the
            # rep-INdependent flags + the device pileup (pre-punts
            # excluded).  Fetches only the pileup, the exclusion mask and
            # the tier-1 winner words; the spelling state stays on the
            # device.  The host then aligns the excluded pairs and merges
            # their alignments into the pileup; Pass B (count) gates and
            # counts against that final pileup.
            SP_SCALARS = ("oriented", "use_r", "cand", "tie2", "uniq_diag",
                          "straight_perfect", "score_w", "n_novel_w",
                          "n_valid_w")
            PLANE_KEYS = ("gp", "in_ins", "valid", "var", "match", "l", "r",
                          "sa", "iva", "ivb", "pa", "pb", "dla", "dlb")

            def sp_flatten(sp):
                return ([sp[k] for k in SP_SCALARS]
                        + [sp["W"][k] for k in PLANE_KEYS]
                        + [sp["T"][k] for k in PLANE_KEYS])

            def sp_unflatten(flat):
                ns = len(SP_SCALARS)
                npk = len(PLANE_KEYS)
                sp = dict(zip(SP_SCALARS, flat[:ns]))
                sp["W"] = dict(zip(PLANE_KEYS, flat[ns:ns + npk]))
                sp["T"] = dict(zip(PLANE_KEYS, flat[ns + npk:ns + 2 * npk]))
                return sp

            NSP = len(SP_SCALARS) + 2 * len(PLANE_KEYS)
            self._NSTATE = {1: NSP + 2, 2: 2 * NSP + 5}

            def place_single(*args):
                tabs, reads = args[:n_tables], args[n_tables]
                s0, use_r, uniq, cw = place_mates(tabs, reads)
                return torch.stack([s0, use_r.to(torch.int32),
                                    uniq.to(torch.int32), cw], 1)

            def place_pairs(*args):
                tabs, r1, r2 = args[:n_tables], args[n_tables], \
                    args[n_tables + 1]
                rows = []
                for r in (r1, r2):
                    s0, use_r, uniq, cw = place_mates(tabs, r)
                    rows += [s0, use_r.to(torch.int32),
                             uniq.to(torch.int32), cw]
                return torch.stack(rows, 1)

            def spell_single_tail(tabs, sp, n_loc):
                passed_u, amb_all, tier1, causes = mate_flags(tabs, sp)
                pre_punt = (~passed_u | amb_all) & (sp["n_valid_w"] > 0)
                pile = yield pile_contrib(sp, passed_u & ~pre_punt)
                abuf = torch.cat(
                    [pile, _bitpack(pre_punt, n_loc)]
                    + winner_info(sp, tier1, causes))
                return ((abuf,) + tuple(sp_flatten(sp))
                        + (amb_all, pre_punt))

            def make_spell_single(ns, prs):
                def f(*args):
                    tabs = args[:n_tables]
                    reads, s0, use_r, uniq = args[n_tables:n_tables + 4]
                    sp = mate_spell(
                        tabs, reads,
                        placed=(s0, use_r.to(torch.bool),
                                uniq.to(torch.bool)),
                        pair_combos=prs, n_single=ns)
                    return (yield from spell_single_tail(tabs, sp,
                                                         reads.shape[0]))
                return f

            def count_single_body(tabs, pile_in, rest):
                sp = sp_unflatten(rest[:NSP])
                amb_all, pre_punt = rest[NSP], rest[NSP + 1]
                n_loc = sp["oriented"].shape[0]
                rep = rep_of(tabs, pile_in)
                cnt, cnt_ex, cnt_px, passed, needs_host = mate_counts(
                    tabs, sp, rep, self._with_primary, amb_all)
                w_used = passed & ~needs_host
                # punted reads are re-counted by the host rescue; count here
                # only what the device keeps
                n_reads_m = ((sp["n_novel_w"] <= max_novel)
                             & (sp["n_valid_w"] > 0) & ~needs_host).sum()
                wcol = w_used[:, None].to(torch.int32)
                cnts = [cnt * wcol, cnt_ex * wcol, cnt_px * wcol][:NLEV]
                return assemble_buf_b((yield from pack_classes(
                    cnts, w_used, needs_host, pre_punt, n_reads_m, n_loc)))

            def spell_pairs_tail(tabs, sp1, sp2, n_loc):
                # -- 4. concordance before the pileup: the host pileup sees
                # concordant pairs only -- #
                l1, rr1 = sp1["W"]["l"], sp1["W"]["r"]
                l2, rr2 = sp2["W"]["l"], sp2["W"]["r"]
                span = torch.maximum(rr1, rr2) - torch.minimum(l1, l2)
                conc = (sp1["use_r"] != sp2["use_r"]) & (span <= MAX_FRAG)

                pu1, amb1, t1_1, cz1 = mate_flags(tabs, sp1)
                pu2, amb2, t1_2, cz2 = mate_flags(tabs, sp2)
                # the PAIR pre-punts when either mate does
                v1 = sp1["n_valid_w"] > 0
                v2 = sp2["n_valid_w"] > 0
                pre_punt = conc & (((~pu1 | amb1) & v1)
                                   | ((~pu2 | amb2) & v2))
                # a pair framed DISCORDANT while either mate carries an
                # ambiguity signal may be concordant under the host
                # aligner's tie-break: punt it to the rescue
                disc_susp = (~conc & v1 & v2
                             & (~sp1["uniq_diag"] | ~sp2["uniq_diag"]
                                | amb1 | amb2 | ~pu1 | ~pu2))
                excl = pre_punt | disc_susp
                inc1 = conc & pu1 & ~pre_punt
                inc2 = conc & pu2 & ~pre_punt
                pile = yield pile_contrib(sp1, inc1) + pile_contrib(sp2, inc2)
                abuf = torch.cat(
                    [pile, _bitpack(excl, n_loc)]
                    + winner_info(sp1, t1_1, cz1)
                    + winner_info(sp2, t1_2, cz2))
                return ((abuf,) + tuple(sp_flatten(sp1))
                        + tuple(sp_flatten(sp2))
                        + (amb1, amb2, conc, pre_punt, disc_susp))

            def make_spell_pairs(ns, prs):
                def f(*args):
                    tabs = args[:n_tables]
                    r1, r2 = args[n_tables], args[n_tables + 1]
                    pl = args[n_tables + 2:n_tables + 8]
                    sp1 = mate_spell(
                        tabs, r1,
                        placed=(pl[0], pl[1].to(torch.bool),
                                pl[2].to(torch.bool)),
                        pair_combos=prs, n_single=ns)
                    sp2 = mate_spell(
                        tabs, r2,
                        placed=(pl[3], pl[4].to(torch.bool),
                                pl[5].to(torch.bool)),
                        pair_combos=prs, n_single=ns)
                    return (yield from spell_pairs_tail(tabs, sp1, sp2,
                                                        r1.shape[0]))
                return f

            def count_pairs_body(tabs, pile_in, rest):
                sp1 = sp_unflatten(rest[:NSP])
                sp2 = sp_unflatten(rest[NSP:2 * NSP])
                amb1, amb2, conc, pre_punt, disc_susp = rest[2 * NSP:]
                n_loc = sp1["oriented"].shape[0]
                rep = rep_of(tabs, pile_in)
                c1, ce1, cp1, ok1, nh1 = mate_counts(tabs, sp1, rep,
                                                     self._with_primary, amb1)
                c2, ce2, cp2, ok2, nh2 = mate_counts(tabs, sp2, rep,
                                                     self._with_primary, amb2)
                punt = (conc & (nh1 | nh2)) | disc_susp
                excl = pre_punt | disc_susp
                used = conc & (ok1 | ok2) & ~punt
                o1 = (ok1 & used)[:, None].to(torch.int32)
                o2 = (ok2 & used)[:, None].to(torch.int32)
                cnts = [c1 * o1 + c2 * o2, ce1 * o1 + ce2 * o2,
                        cp1 * o1 + cp2 * o2][:NLEV]
                # punted pairs are re-counted by the host rescue
                n_reads_m = ((conc & ~punt)[:, None] & torch.stack([
                    (sp1["n_novel_w"] <= max_novel) & (sp1["n_valid_w"] > 0),
                    (sp2["n_novel_w"] <= max_novel) & (sp2["n_valid_w"] > 0),
                ], 1)).sum()
                return assemble_buf_b((yield from pack_classes(
                    cnts, used, punt, excl, n_reads_m, n_loc)))

            def make_count_multi(m, T):
                """Count pass over T spelling tiers in ONE call: the
                per-tier rows are concatenated (row-independent gate and
                count), so the whole batch is gated and deduplicated
                together."""
                NS = self._NSTATE[m]
                body = count_single_body if m == 1 else count_pairs_body

                def f(*args):
                    tabs = args[:n_tables]
                    pile_in = args[n_tables]
                    rest = args[n_tables + 1:]
                    parts = [rest[t * NS:(t + 1) * NS] for t in range(T)]
                    cat = parts[0] if T == 1 else tuple(
                        torch.cat([p[k] for p in parts], 0)
                        for k in range(NS))
                    return (yield from body(tabs, pile_in, cat))
                return f

            # spelling tiers: reads are partitioned by their pair's WIDE
            # candidate count (place pass) so the hypothesis budget matches
            # the local indel density; tiered == full, read for read
            self._tier_cfg = ((0, ()), (1, ()),
                              (max_indel_cand, PAIR_COMBOS))
            progs["place_single"] = place_single
            progs["place_pairs"] = place_pairs
            for t, (ns, prs) in enumerate(self._tier_cfg):
                progs[("spell_single", t)] = make_spell_single(ns, prs)
                progs[("spell_pairs", t)] = make_spell_pairs(ns, prs)
            # fused place+spell at the gene's hypothesis ceiling: one pass
            # for the whole batch (no place fetch, no tier partition)
            fused_ns = self._fused_ns
            fused_prs = tuple((u, v) for u in range(fused_ns)
                              for v in range(u + 1, fused_ns))
            self._fused_H = 1 + 2 * fused_ns + 3 * len(fused_prs)
            # the legacy programs' spelling, the tiers', the fused one's
            for ns, prs in ((max_indel_cand, ()),) + self._tier_cfg + (
                    (fused_ns, fused_prs),):
                cols = hyp_columns(ns, prs)
                hyp_cols[ns, prs] = (
                    i32([c[2] for c in cols])[None, :],
                    torch.tensor([c[3] for c in cols], device=dev)[None, :])

            def spell_fused_single(*args):
                tabs = args[:n_tables]
                reads = args[n_tables]
                sp = mate_spell(tabs, reads, pair_combos=fused_prs,
                                n_single=fused_ns)
                return (yield from spell_single_tail(tabs, sp,
                                                     reads.shape[0]))

            def spell_fused_pairs(*args):
                tabs = args[:n_tables]
                r1, r2 = args[n_tables], args[n_tables + 1]
                sp1 = mate_spell(tabs, r1, pair_combos=fused_prs,
                                 n_single=fused_ns)
                sp2 = mate_spell(tabs, r2, pair_combos=fused_prs,
                                 n_single=fused_ns)
                return (yield from spell_pairs_tail(tabs, sp1, sp2,
                                                    r1.shape[0]))

            progs[("fused", 1)] = spell_fused_single
            progs[("fused", 2)] = spell_fused_pairs
            for m in (1, 2):
                for T in (1, 2, 3):
                    progs[("count_multi", m, T)] = make_count_multi(m, T)

            def _combine(*bufs):
                return torch.cat([b.reshape(1, -1) for b in bufs], 1)

            progs["combine"] = _combine
            return progs

        # the programs' bodies and tables for each distinct shard device
        self._progs, self._tables_on = {}, {}
        for d in mesh.devices:
            if str(d) not in self._progs:
                self._progs[str(d)] = programs(d)
                self._tables_on[str(d)] = tuple(t.to(d) for t in self._tables)
        self._ones = torch.ones(A, dtype=torch.bool, device=dev)
        self._rep_mask = torch.from_numpy(self._rep_mask_np).to(dev)

        # this typer's tables as already placed on every shard
        own = tuple(Replicated([self._tables_on[str(d)][i]
                                for d in mesh.devices])
                    for i in range(n_tables))

        def program(key, specs, outs):
            """hgtpu's jit(shard_map(body, mesh, in_specs=(P(),) * n_tables
            + specs, out_specs=outs)): the tables first, then the
            program's inputs.  This typer's own tables are not copied
            again: each shard takes its device's copy."""
            run = mesh.shard_map(lambda d: self._progs[str(d)][key],
                                 (REP,) * n_tables + specs, outs)

            def call(*args):
                if mesh.n_local > 1 and all(
                        a is b for a, b in zip(args[:n_tables],
                                               self._tables)):
                    args = own + args[n_tables:]
                return run(*args)
            return call

        NS1, NS2 = self._NSTATE[1], self._NSTATE[2]
        S = SHARD
        cnt_outs = (S, S, S, REP, REP, S)
        self._count_single = program("count_single", (S,), cnt_outs)
        self._count_pairs = program("count_pairs", (S, S), cnt_outs)
        self._debug = program("debug", (S,), (S,) * 6)
        self._place_single_p = program("place_single", (S,), S)
        self._place_pairs_p = program("place_pairs", (S, S), S)
        self._spell_single_t = [program(("spell_single", t), (S,) * 4,
                                        (S,) * (1 + NS1)) for t in range(3)]
        self._spell_pairs_t = [program(("spell_pairs", t), (S,) * 8,
                                       (S,) * (1 + NS2)) for t in range(3)]
        self._spell_fused = {1: program(("fused", 1), (S,), (S,) * (1 + NS1)),
                             2: program(("fused", 2), (S, S),
                                        (S,) * (1 + NS2))}
        self._count_multi = {
            (m, T): program(("count_multi", m, T),
                            (REP,) + (S,) * (T * self._NSTATE[m]), (S,) * 5)
            for m in (1, 2) for T in (1, 2, 3)}
        self._em_steps = {
            key: mesh.shard_map(
                lambda d, key=key: self._progs[str(d)][("em",) + key],
                (S, S, REP, REP), REP)
            for key in ((False, False), (True, False), (True, True))}
        # the per-tier spell buffers concatenated on each shard, so the
        # spell pass fetches ONE array: [n_shards, sum of widths]
        self._combine_bufs = mesh.shard_map(
            lambda d: self._progs[str(d)]["combine"], None, S)
        # count_classes' passes as CUDA graphs where they are valid (one
        # local CUDA shard, one rank), else eager; the lock keeps one call
        # at a time on the graphs' static tensors
        self._graphs = PassGraphs.for_mesh(mesh)
        self._graph_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # host side: a copy of hgtpu's, with torch transfers
    # ------------------------------------------------------------------ #
    def encode(self, seqs):
        return encode_reads(seqs, self.read_len)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _pad(self, codes, bucket=False):
        n, d = codes.shape[0], self.mesh.n_local
        target = n
        if bucket:
            # eighth-of-octave bucketing bounds the pass shapes to ~8 per
            # size octave at <= 12.5% padding overhead (pad rows are code
            # 4 = all-N: n_valid 0, weight 0, no punt)
            step = max(_pow2(max(n, 1), lo=256) // 8, 32)
            target = ((max(n, 1) + step - 1) // step) * step
        target = ((target + d - 1) // d) * d
        if n < target:
            pad = np.full((target - n, codes.shape[1]), 4, np.int8)
            codes = np.concatenate([codes, pad])
        return codes

    def _count_work(self, n_pad, n_mates):
        """Dispatched-work accounting (utils.trace counters): FLOPs of
        the placement correlation plus the counting chain, and the
        dominant byte streams, as hgtpu counts them."""
        W = self.read_len
        P1 = int(self._tables[0].shape[0]) - W + 1
        A = self.A
        W32 = self._W32
        n_groups = 2 + (4 if self._staged else 0) \
            + (4 if self._with_primary else 0)
        rows = n_mates * n_groups * n_pad
        V = int(self._tables[18].shape[0])
        TRACE.count("flops.device_classes",
                    n_mates * 2.0 * n_pad * (2.0 * W * 5 * P1)
                    + 2.0 * (2.0 * rows) * V * A
                    + 3.0 * self._NLEV * n_pad * A)
        H = 1 + 2 * MAX_INDEL_CAND + 3 * len(
            [(u, v) for u in range(MAX_INDEL_CAND)
             for v in range(u + 1, MAX_INDEL_CAND)])
        TRACE.count("bytes.device_classes",
                    n_mates * 2.0 * n_pad * P1 * 4
                    + n_mates * 10.0 * n_pad * H * W * 4
                    + 2.0 * rows * V * 2          # M1/M2 bf16 operands
                    + rows * A * 4 * 3.0
                    + self._NLEV * n_pad * (W32 * 4 + 8))

    @staticmethod
    def _unpack_bits(words, n_loc):
        return ((words[:, None] >> np.arange(32, dtype=np.uint32))
                & 1).astype(bool).reshape(-1)[:n_loc]

    @staticmethod
    def _fetch_u32(t):
        """An int32 device buffer as hgtpu's uint32 host array."""
        return to_host(t).view(np.uint32)

    def _pass(self, key, pool, prog, *inputs):
        """The pass program `prog` (program key `key`) over this typer's
        tables and `inputs`: host arrays, or device tensors an earlier
        pass of the same call returned.  Replayed from the graph cache
        where graphs engage, else run eagerly.  `pool` names the graphs'
        memory pool: place, each spell tier and count take their own, as
        no two passes of one call may share one."""
        if self._graphs is not None:
            return self._graphs.run(key, pool, prog, self._tables, inputs)
        return prog(*self._tables, *(
            self._dev(a) if isinstance(a, np.ndarray) else a
            for a in inputs))

    def count_classes(self, r1_codes: np.ndarray, r2_codes=None,
                      bucket: bool = True, merge_pileup=None,
                      overlap=None):
        """Run the two-pass production program.  Returns a dict:
          levels: {"full"|"exon"|"primary":
                      (rows uint32 [U, W32], weights int64 [U],
                       totals int64 [A])}
          order:  {level: first-seen original read index per row}
          pileup: int32 [P, 6]      (the FINAL pileup every gate
                                     decision was taken against)
          punt:   bool [n]          (reads/pairs for the host rescue)
          excl:   bool [n]          (reads whose device spelling was
                                     excluded from the device pileup)
          n_reads, n_pairs: int     (report accounting)
          winner: per mate, the tier-1 winner words unpacked

        `merge_pileup(pile_dev, excl, winner) -> [P, 6]` is called
        between the passes: the caller aligns the excluded pairs
        host-side and returns the merged (host-full) pileup; the count
        pass then gates and counts against it.  When None, the count
        pass gates against the device pileup unchanged.  `overlap()`
        runs on the host while the count pass is in flight.

        On one local CUDA shard the passes replay as CUDA graphs
        (``graphs.PassGraphs``), with the same kernels and results."""
        if self._graphs is None:
            return self._count_classes(r1_codes, r2_codes, bucket,
                                       merge_pileup, overlap)
        with self._graph_lock:
            self._graphs.begin()
            try:
                return self._count_classes(r1_codes, r2_codes, bucket,
                                           merge_pileup, overlap)
            finally:
                self._graphs.end()

    def _count_classes(self, r1_codes, r2_codes, bucket, merge_pileup,
                       overlap):
        if self.mesh.world > 1:
            # the tier choice and the overflow refetch depend on each
            # rank's data, so the ranks' collectives would not line up;
            # hgtpu never runs count_classes across processes either
            raise ValueError(
                "count_classes runs on a mesh local to this process; %r spans "
                "ranks: type each rank's reads on a local mesh and merge on "
                "the host (multihost.type_reads_device_distributed)"
                % self.mesh)
        n = r1_codes.shape[0]
        ndev = self.mesh.n_local
        n_mates = 1 if r2_codes is None else 2
        NLEV, W32, A = self._NLEV, self._W32, self.A
        P6 = self.P_bb * 6

        # fused place+spell when the gene's hypothesis ceiling is small
        # (H <= 8: every read's wide window holds <= 2 catalog indels)
        fuse = (self._fused_H <= 8
                and os.environ.get("HGTPU_FUSED_SPELL", "auto") != "off")
        if not fuse:
            # -- place pass over the full batch: tier assignment ------ #
            with TRACE.stage("device.place"):
                p1f = self._pad(r1_codes, bucket)
                self._count_work(p1f.shape[0], n_mates)
                p2f = self._pad(r2_codes, bucket) if n_mates == 2 else None
                with TRACE.stage("pass.dispatch"):
                    if n_mates == 1:
                        pl = self._pass("place_single", "place",
                                        self._place_single_p, p1f)
                    else:
                        pl = self._pass("place_pairs", "place",
                                        self._place_pairs_p, p1f, p2f)
                pl = to_host(pl)[:n].T
        with TRACE.stage("device.spell"):
            if fuse:
                c1t = self._pad(r1_codes, bucket)
                n_pad_t = c1t.shape[0]
                self._count_work(n_pad_t, n_mates)
                c2t = self._pad(r2_codes, bucket) if n_mates == 2 else None
                with TRACE.stage("pass.dispatch"):
                    aout = self._pass(("fused", n_mates), ("spell", 0),
                                      self._spell_fused[n_mates],
                                      *[c1t, c2t][:n_mates])
                tinfo = [(0, np.arange(n), n_pad_t, aout)]
            else:
                tier = np.clip(pl[3], 0, 2)
                if n_mates == 2:
                    tier = np.maximum(tier, np.clip(pl[7], 0, 2))
                idx_t = [np.flatnonzero(tier == t) for t in range(3)]

                # -- per-tier pass A: all launched, then fetched ------ #
                tinfo = []
                for t, idx in enumerate(idx_t):
                    if len(idx) == 0:
                        continue
                    c1t = self._pad(r1_codes[idx], bucket)
                    n_pad_t = c1t.shape[0]

                    def padi(row, n_pad_t=n_pad_t, idx=idx):
                        out = np.zeros(n_pad_t, np.int32)
                        out[:len(idx)] = row[idx]
                        return out

                    c2t = self._pad(r2_codes[idx], bucket) \
                        if n_mates == 2 else None
                    with TRACE.stage("pass.dispatch"):
                        if n_mates == 1:
                            aout = self._pass(
                                ("spell_single", t), ("spell", t),
                                self._spell_single_t[t],
                                c1t, padi(pl[0]), padi(pl[1]), padi(pl[2]))
                        else:
                            aout = self._pass(
                                ("spell_pairs", t), ("spell", t),
                                self._spell_pairs_t[t], c1t, c2t,
                                padi(pl[0]), padi(pl[1]), padi(pl[2]),
                                padi(pl[4]), padi(pl[5]), padi(pl[6]))
                    tinfo.append((t, idx, n_pad_t, aout))

            pile_dev = np.zeros((self.P_bb, 6), np.int64)
            excl = np.zeros(n, bool)
            winner = [dict(l=np.zeros(n, np.int64),
                           rc=np.zeros(n, bool),
                           tier1=np.zeros(n, bool),
                           causes=np.zeros(n, np.int64),
                           iva=np.zeros(n, np.int64),
                           ivb=np.zeros(n, np.int64))
                      for _ in range(n_mates)]
            # ONE fetch for every tier's spell buffer (device-side concat)
            if len(tinfo) > 1:
                widths = [int(a[0].shape[0]) // ndev
                          for (_t, _i, _np_, a) in tinfo]
                comb = self._fetch_u32(self._combine_bufs(
                    *[a[0] for (_t, _i, _np_, a) in tinfo]))
                offs = np.concatenate([[0], np.cumsum(widths)])
                abufs = [comb[:, offs[k]:offs[k + 1]]
                         for k in range(len(tinfo))]
            else:
                abufs = [self._fetch_u32(tinfo[0][3][0]).reshape(ndev, -1)]
            for ti, (t, idx, n_pad_t, aout) in enumerate(tinfo):
                abuf = abufs[ti]
                n_loc_t = n_pad_t // ndev
                npw_t = (n_loc_t + 31) // 32
                pile_dev += abuf[0, :P6].astype(np.int64).reshape(
                    self.P_bb, 6)
                excl_t = np.zeros(n_pad_t, bool)
                wt = [dict() for _ in range(n_mates)]
                for mi in range(n_mates):
                    for k in ("info", "iva", "ivb"):
                        wt[mi][k] = np.zeros(n_pad_t, np.uint32)
                for s in range(ndev):
                    b = abuf[s]
                    at = P6
                    sl = slice(s * n_loc_t, (s + 1) * n_loc_t)
                    excl_t[sl] = self._unpack_bits(b[at:at + npw_t], n_loc_t)
                    at += npw_t
                    for mi in range(n_mates):
                        for k in ("info", "iva", "ivb"):
                            wt[mi][k][sl] = b[at:at + n_loc_t]
                            at += n_loc_t
                m = len(idx)
                excl[idx] = excl_t[:m]
                for mi in range(n_mates):
                    info = wt[mi]["info"][:m]
                    winner[mi]["l"][idx] = ((info >> 2)
                                            & ((1 << 26) - 1)).astype(np.int64)
                    winner[mi]["causes"][idx] = (info >> 28).astype(np.int64)
                    winner[mi]["rc"][idx] = ((info >> 1) & 1).astype(bool)
                    winner[mi]["tier1"][idx] = (info & 1).astype(bool)
                    winner[mi]["iva"][idx] = wt[mi]["iva"][:m].astype(np.int64)
                    winner[mi]["ivb"][idx] = wt[mi]["ivb"][:m].astype(np.int64)
            pile_dev = pile_dev.astype(np.int32)

        # -- host merge: the final (host-full) pileup ----------------- #
        final_pile = pile_dev
        if merge_pileup is not None:
            final_pile = merge_pileup(pile_dev, excl, winner)

        # -- pass B: ONE call gates + counts + packs every tier's rows
        # against the final pileup -- #
        with TRACE.stage("device.countB"):
            pin = np.ascontiguousarray(final_pile, dtype=np.int32).reshape(-1)
            T = len(tinfo)
            flat_state = [a for (_t, _i, _np_, aout) in tinfo
                          for a in aout[1:]]
            with TRACE.stage("pass.dispatch"):
                out = self._pass(("count_multi", n_mates, T), "count",
                                 self._count_multi[(n_mates, T)], pin,
                                 *flat_state)
            n_loc_list = [n_pad_t // ndev for (_t, _i, n_pad_t, _a) in tinfo]
            n_loc = sum(n_loc_list)
            cap = min(self._class_cap, NLEV * n_loc,
                      max(512, 65536 // max(W32, 1)))
            npw = (n_loc + 31) // 32
            BUF = cap * W32 + 2 * cap + NLEV * A + 2 * npw + 4
            # local row -> original read index (concat layout: tier-0 rows,
            # then tier-1, then tier-2) — built BEFORE the blocking fetch so
            # host prep overlaps the device count pass
            orig_shard = np.full((ndev, n_loc), n, np.int64)
            off_t = np.concatenate([[0], np.cumsum(n_loc_list)])
            for ti, (_t, idx, n_pad_t, _a) in enumerate(tinfo):
                nl = n_loc_list[ti]
                om = np.full(n_pad_t, n, np.int64)
                om[:len(idx)] = idx
                orig_shard[:, off_t[ti]:off_t[ti] + nl] = \
                    om.reshape(ndev, nl)
            if overlap is not None:
                # host work independent of the count-pass output (the punt
                # rescue's fast-path memo prefill) runs while the launched
                # count pass executes on the device
                overlap()
            buf = self._fetch_u32(out[0]).reshape(ndev, BUF)

            rows_parts, uw_parts, ord_parts = [], [], []
            punt = np.zeros(n + 1, bool)
            n_reads = 0
            n_pairs = 0
            totals = None
            overflow_fetch = None
            for s in range(ndev):
                b = buf[s]
                at = cap * W32
                rows_s = b[:at].reshape(cap, W32)
                uw_s = b[at:at + cap].astype(np.int64)
                min_s = b[at + cap:at + 2 * cap].astype(np.int64)
                at += 2 * cap
                tt = b[at:at + NLEV * A].astype(np.int64).reshape(NLEV, A)
                at += NLEV * A
                pw = b[at:at + npw]
                at += 2 * npw     # punt words + excl words
                n_uniq, nr, npair, _np_ = (int(x) for x in b[at:at + 4])
                if s == 0:
                    totals = tt
                n_reads += nr
                n_pairs += npair
                bits = self._unpack_bits(pw, n_loc)
                punt[orig_shard[s][bits]] = True
                if n_uniq > cap:
                    # rare overflow: fetch the full sorted rows through the
                    # exact secondary leaves
                    if overflow_fetch is None:
                        overflow_fetch = [self._fetch_u32(out[1])] + [
                            to_host(x) for x in out[2:5]]
                    fs_all, first_all, uw_all, min_all = overflow_fetch
                    blk = NLEV * n_loc
                    fs_s = fs_all[s * blk:(s + 1) * blk]
                    first_s = first_all[s * blk:(s + 1) * blk]
                    uwf = uw_all[s * blk:(s + 1) * blk]
                    minf = min_all[s * blk:(s + 1) * blk]
                    fr = np.flatnonzero(first_s)
                    rows_s = fs_s[fr]
                    uw_s = uwf[:len(fr)].astype(np.int64)
                    min_s = minf[:len(fr)].astype(np.int64)
                    n_uniq = len(fr)
                rows_s = rows_s[:n_uniq]
                uw_s = uw_s[:n_uniq]
                min_s = min_s[:n_uniq]
                keep = uw_s > 0
                rows_parts.append(rows_s[keep])
                uw_parts.append(uw_s[keep])
                # global first-seen order: (level, original read index)
                m = min_s[keep]
                ord_parts.append((m // n_loc) * np.int64(n + 1)
                                 + orig_shard[s][m % n_loc])
            punt = punt[:n]
            rows = np.concatenate(rows_parts) if rows_parts else \
                np.zeros((0, W32), np.uint32)
            uws = np.concatenate(uw_parts) if uw_parts else \
                np.zeros(0, np.int64)
            order_key = np.concatenate(ord_parts) if ord_parts else \
                np.zeros(0, np.int64)

            levels = {}
            order = {}
            for li, (name, _inc) in enumerate(self._levels):
                sel = np.flatnonzero((order_key // (n + 1)) == li)
                sub = sel[np.argsort(order_key[sel], kind="stable")]
                levels[name] = (rows[sub], uws[sub], totals[li])
                order[name] = order_key[sub] % (n + 1)
        return dict(levels=levels, order=order, pileup=final_pile,
                    punt=punt, excl=excl, n_reads=n_reads,
                    n_pairs=n_pairs, winner=winner)

    # ------------------------------------------------------------------ #
    # the pure-device programs: ungated count + staged device EM
    # ------------------------------------------------------------------ #
    def _solve(self, counted):
        """Staged EM over the device-resident class counts (the host
        hierarchy of typer/engine.py): exon-level EM over rep alleles,
        expansion of winning groups, full-level EM restricted to the
        expanded set with length normalization."""
        cnt, cnt_ex, w, totals, n_used, punt = counted
        if not self._staged:
            prob = self._em_steps[(False, False)](
                cnt, w, self._ones, self._ones).cpu().numpy()
            return prob, totals, n_used, punt
        exon_prob = self._em_steps[(True, False)](
            cnt_ex, w, self._rep_mask, self._ones).cpu().numpy()
        sel, prob_sum = self._exon_winners(exon_prob)
        if sel.any():
            full = self._em_steps[(True, True)](
                cnt, w, self._ones, self._dev(sel)).cpu().numpy()
            prob = np.where(sel, full * prob_sum, exon_prob)
        else:
            prob = exon_prob
        return prob, totals, n_used, punt

    def _exon_winners(self, exon_prob: np.ndarray):
        """Expandable exon-stage winners: the shared staging policy
        (typer/staging.expansion_winners — same constants and selection
        rule as the host engine) over the device EM's abundance vector.
        Zero-probability alleles never appear in the host's ranked list
        (single_abundance emits positives only), so they are filtered
        before ranking here too."""
        from ..typer.staging import expansion_winners

        order = np.argsort(-exon_prob, kind="stable")
        ranked = [(int(i), float(exon_prob[i])) for i in order
                  if exon_prob[i] > 0.0]
        idx_set, prob_sum = expansion_winners(ranked, self._rep_groups)
        sel = np.zeros(self.A, bool)
        sel[sorted(idx_set)] = True
        return sel, prob_sum

    def _result(self, counted, n):
        prob, totals, n_used, punt = self._solve(counted)
        return (np.asarray(prob), totals.cpu().numpy(), float(n_used),
                punt.cpu().numpy()[:n])

    def count_em_global(self, local_codes):
        """hgtpu's single-call EM entry over the global read set, each
        rank passing only its own rows (``multihost.distributed_call``),
        a multiple of the local shards: returns the replicated (prob,
        totals, n_used) and this rank's punt mask, which the caller MUST
        rescue or account for (never drop it silently)."""
        return self._result(self._count_single(
            *self._tables, self._dev(local_codes)), local_codes.shape[0])

    def __call__(self, read_codes: np.ndarray):
        n = read_codes.shape[0]
        return self._result(self._count_single(
            *self._tables, self._dev(self._pad(read_codes))), n)

    def call_pairs(self, r1_codes: np.ndarray, r2_codes: np.ndarray):
        n = r1_codes.shape[0]
        return self._result(self._count_pairs(
            *self._tables, self._dev(self._pad(r1_codes)),
            self._dev(self._pad(r2_codes))), n)

    def call_allele(self, read_codes: np.ndarray):
        prob, totals, n_used, _ = self(read_codes)
        top = int(np.argmax(prob))
        return self.gene.allele_names[top], float(prob[top]), totals, n_used
