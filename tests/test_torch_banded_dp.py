"""The port's banded device DP equals hgtpu's, and device verify in the
port's aligner returns hgtpu's alignments.

  tables    BandedDPTables' five row tables and length tuples equal
            hgtpu's, array for array, and the packed table holds them
  costs     banded_costs_plain (what the CUDA kernel is held against on
            the card) equals hgtpu's _banded_costs exactly, cost and over,
            on the deletion gene, the insertion gene (min_var_freq=8.0)
            and the wide-deletion overflow gene, with junk reads, ragged
            lengths and proposals on both sides of both band edges;
            padding E and W changes no entry's answer
  planes    the bit kernel's bit planes (bit_planes) unpack to hgtpu's
            free, over, del_has and insertion-row arrays
  masks     a torch int64 model of the bit kernel's threshold-mask
            recurrence (one 33-bit mask per cost level, every transition
            word logic, the kernel's closure exit and insertion walk)
            equals banded_costs_plain and hgtpu's _banded_costs exactly
            on the three genes at budgets 0, 2 and 7
  plan      dp_plan picks the kernel from the budget; on the CPU both
            kernels' wrappers answer with the plain version, uncounted
  aligner   GeneAligner(device_verify="on", device="cpu") returns, read
            for read, hgtpu's device_verify="on" and the port's "off",
            with the DP run (its plain version, counted)

Tolerance: none; every comparison is exact (integer DP, integer
alignment records).
"""
import dataclasses

import numpy as np
import pytest
import torch

from hgtpu.align import GeneAligner as JaxAligner
from hgtpu.db import build_gene_ref
from hgtpu.db.catalog import (GeneRef as JaxGeneRef, VT_DELETION,
                               VT_INSERTION)
from hgtpu.ops.banded_dp import BandedDPTables as JaxTables
from hgtpu.sim import simulate_reads
from hgtpu.utils.dna import encode_seq
from hgtpu_torch.align import GeneAligner
from hgtpu_torch.ops import banded_dp
from hgtpu_torch.ops.banded_dp import (
    D, DNEG, DPOS, IL, INF, NI, NITER, OFF, PL_DEL, PL_DEL_ANY, PL_INS,
    PL_OVER, PLANE_PAD, BandedDPTables, banded_costs, banded_costs_bits,
    banded_costs_plain, banded_costs_warp, dp_plan, length_mask, pack_rows,
    plane_words)
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


def _wide_deletion_gene():
    """tests/test_banded_dp.py's gene: one catalog deletion wider than
    the band."""
    bb = "ACGT" * 60
    return JaxGeneRef(
        gene="X", backbone_name="X*BB", backbone=bb,
        allele_names=["X*A", "X*B"], var_ids=["hv0"],
        var_type=np.array([VT_DELETION], np.int8),
        var_pos=np.array([60], np.int32),
        var_len=np.array([40], np.int32),
        var_data=["40"], var_freq=np.array([50.0], np.float32),
        links=np.array([[False, True]]),
        exons=[(0, len(bb) - 1)], primary_exons=[(0, len(bb) - 1)],
        haplotypes=[])


_GENES = {}


def gene_of(kind):
    if kind not in _GENES:
        if kind == "deletion":
            spec = make_gene_msa(seed=11, n_alleles=24, length=1600,
                                 n_del=10, n_ins=8)
            g, _ = build_gene_ref("A", spec["names"], spec["rows"],
                                  spec["ref_allele"], min_var_freq=0.0)
        elif kind == "insertion":
            spec = make_gene_msa(seed=15, n_alleles=24, length=1600,
                                 n_ins=14)
            g, _ = build_gene_ref("A", spec["names"], spec["rows"],
                                  spec["ref_allele"],
                                  exons_ref_coords=spec["exons"],
                                  min_var_freq=8.0)
        else:
            g = _wide_deletion_gene()
        _GENES[kind] = g
    return _GENES[kind]


def _mutate(rng, seq):
    s = list(seq)
    for _ in range(int(rng.integers(0, 4))):
        k = int(rng.integers(0, 3))
        p = int(rng.integers(1, len(s) - 2))
        if k == 0:
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        elif k == 1:
            del s[p]
        else:
            s.insert(p, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s)


# proposal offsets from the true start: the plain diagonal, small drifts,
# and both sides of both band edges (d = -DNEG and d = +DPOS)
OFFSETS = (0, 0, 1, -1, 2, -2, DNEG - 1, DNEG, DNEG + 1, -DPOS + 1, -DPOS,
           -DPOS - 1)


def entries_of(gene, seed, n=90):
    """(reads [E, W] int8 pad 4, lens, starts): allele windows, mutated,
    proposed at OFFSETS, ragged lengths; junk reads; starts at and past
    both backbone ends."""
    rng = np.random.default_rng(seed)
    P = len(gene.backbone)
    out = []
    for _ in range(n):
        a = gene.allele_names[int(rng.integers(0, gene.n_alleles))]
        seq = gene.allele_seq(a)
        ln = int(rng.integers(40, 101))
        start = int(rng.integers(0, max(1, len(seq) - ln - 5)))
        read = _mutate(rng, seq[start:start + ln])
        out.append((encode_seq(read), start + OFFSETS[len(out)
                                                      % len(OFFSETS)]))
    for _ in range(20):
        ln = int(rng.integers(30, 100))
        read = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
        out.append((encode_seq(read), int(rng.integers(-5, P))))
    for s in (-3, 0, P - 60, P - 30):
        out.append((encode_seq(gene.backbone[max(0, s):max(0, s) + 60]), s))
    W = max(len(r) for r, _ in out)
    reads = np.full((len(out), W), 4, np.int8)
    for i, (r, _s) in enumerate(out):
        reads[i, :len(r)] = r
    lens = np.array([len(r) for r, _ in out], np.int32)
    starts = np.array([s for _, s in out], np.int32)
    return reads, lens, starts


KINDS = ("deletion", "insertion", "wide")


@pytest.mark.parametrize("kind", KINDS)
def test_tables_equal_hgtpu(kind):
    gene = gene_of(kind)
    want = JaxTables(gene)
    got = BandedDPTables(carried(gene), "cpu")
    assert got.del_lens == want.del_lens
    assert got.ins_lens == want.ins_lens
    assert got.P == want.P
    for g, w in zip(got.arrays, want.arrays):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(got.table.numpy(), pack_rows(*got.arrays))
    # the packing is lossless: every field reads back
    t = got.table.numpy().view(np.uint32)
    free, del_has, ins_len, ins_seq, over = got.arrays
    assert np.array_equal((t[:, 0:1] >> np.arange(8)) & 1, free)
    assert np.array_equal((t[:, 0] >> 8) & 1, over)
    assert np.array_equal(np.stack([(t[:, 0] >> 9) & 7,
                                    (t[:, 0] >> 12) & 7], 1), ins_len)
    assert np.array_equal((t[:, 1:2] >> np.arange(del_has.shape[1])) & 1,
                          del_has)
    for s in range(2):
        seq = (t[:, 2 + s:3 + s] >> (8 * np.arange(4))) & 0xFF
        assert np.array_equal(seq, ins_seq[:, s, :].astype(np.uint8))
    if kind == "deletion":
        assert len(got.del_lens) >= 3
    if kind == "insertion":
        assert got.ins_lens
    if kind == "wide":
        assert over.any() and not got.del_lens


@pytest.mark.parametrize("kind,max_novel", [
    ("deletion", 2), ("insertion", 2), ("wide", 2),
    # a budget of 30 edits lets novel indels drift the state to both band
    # edges, so the edge overflows (and the saturation above 2) are on
    # the line too
    ("deletion", 30), ("insertion", 30)])
def test_plain_costs_equal_hgtpu(kind, max_novel):
    gene = gene_of(kind)
    if kind == "wide":
        bb = gene.backbone
        # reads that use the wide deletion, and plain ones beside it
        reads_l = [encode_seq(bb[40:60] + bb[100:140]), encode_seq(bb[0:60]),
                   encode_seq(bb[150:230])]
        W = max(len(r) for r in reads_l)
        reads = np.full((len(reads_l), W), 4, np.int8)
        for i, r in enumerate(reads_l):
            reads[i, :len(r)] = r
        lens = np.array([len(r) for r in reads_l], np.int32)
        starts = np.array([40, 0, 150], np.int32)
    else:
        reads, lens, starts = entries_of(gene, {"deletion": 31,
                                                "insertion": 41}[kind])
    jc, jo = JaxTables(gene).costs(reads, lens, starts, max_novel)
    jc, jo = np.asarray(jc), np.asarray(jo)
    tab = BandedDPTables(carried(gene), "cpu")
    calls = _count_plain()
    try:
        tc, to = tab.costs(reads, lens, starts, max_novel)
    finally:
        banded_dp.banded_costs_plain = calls.real
    assert calls.n == 1
    assert tc.dtype == torch.int32 and to.dtype == torch.bool
    assert np.array_equal(tc.numpy(), jc)
    assert np.array_equal(to.numpy(), jo)
    # the comparison is not vacuous: real costs, INF and overflow occur
    assert (jc <= 2).sum() > 0
    if kind == "wide":
        assert jo[0] and not jo[1:].any()
    elif max_novel == 2:
        assert (jc >= INF).any() and (~jo).sum() > len(jo) // 2
    else:
        assert jo.any() and (~jo).any() and (jc > 2).any()


@pytest.mark.parametrize("kind", ("deletion", "insertion"))
def test_plain_costs_padding_invariant(kind):
    """E padded to a power of two (junk rows) and W to a multiple of 32
    (pad code 4), as hgtpu pads them: the real entries' answers stay."""
    gene = gene_of(kind)
    reads, lens, starts = entries_of(gene, 5, n=41)
    tab = BandedDPTables(carried(gene), "cpu")
    cost, over = tab.costs(reads, lens, starts)
    E, W = reads.shape
    Ep, Wp = 1 << (E - 1).bit_length(), ((W + 31) // 32) * 32
    rp = np.full((Ep, Wp), 4, np.int8)
    rp[:E, :W] = reads
    rp[E:] = np.random.default_rng(1).integers(0, 4, (Ep - E, Wp))
    lp = np.zeros(Ep, np.int32)
    lp[:E] = lens
    lp[E:] = 50
    sp = np.zeros(Ep, np.int32)
    sp[:E] = starts
    cp, op = tab.costs(rp, lp, sp)
    assert Ep > E and Wp > W
    assert torch.equal(cp[:E], cost) and torch.equal(op[:E], over)


def test_banded_costs_checks_its_inputs():
    tab = BandedDPTables(carried(gene_of("wide")), "cpu")
    reads = torch.zeros((2, 8), dtype=torch.int8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        banded_costs(tab.table, reads.long(), lens, lens, tab.P, 2)
    with pytest.raises(ValueError):
        banded_costs(tab.table, reads, lens[:1], lens, tab.P, 2)
    with pytest.raises(ValueError):
        banded_costs(tab.table[:, :3].contiguous(), reads, lens, lens,
                     tab.P, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_bit_planes_unpack_to_hgtpu(kind):
    gene = gene_of(kind)
    want = JaxTables(gene)
    free, del_has, ins_len, _seq, over = (np.asarray(a) for a in want.arrays)
    nd = len(want.del_lens)
    tab = BandedDPTables(carried(gene), "cpu")
    planes = tab.planes.numpy()
    assert planes.shape == (PL_DEL + nd, plane_words(tab.P))
    bits = np.unpackbits(planes.view(np.uint8), axis=1,
                         bitorder="little").astype(bool)
    m = min(bits.shape[1] - PLANE_PAD, free.shape[0])
    assert m >= OFF + tab.P
    # nothing before row 0, nothing past the rows the planes hold
    assert not bits[:, :PLANE_PAD].any()
    assert not bits[:, PLANE_PAD + m:].any()
    for a in (free, del_has, ins_len, over):
        assert not a[m:].any()
    rows = bits[:, PLANE_PAD:PLANE_PAD + m]
    assert np.array_equal(rows[:8].T, free[:m])
    assert np.array_equal(rows[PL_OVER], over[:m])
    assert np.array_equal(rows[PL_INS], (ins_len[:m] > 0).any(1))
    assert np.array_equal(rows[PL_DEL:].T, del_has[:m, :nd])
    assert np.array_equal(rows[PL_DEL_ANY], del_has[:m, :nd].any(1))
    if kind == "deletion":
        assert nd >= 3 and rows[PL_DEL_ANY].any()
    if kind == "insertion":
        assert rows[PL_INS].any()
    if kind == "wide":
        assert rows[PL_OVER].any()


BAND = (1 << D) - 1


def _window(planes, k, idx):
    """Bits idx .. idx + 32 of plane k per entry, read as the kernel reads
    them: two 64-bit words and a funnel shift (int64 shifts are
    arithmetic, so the low word's is masked)."""
    w = (idx >> 6).clamp(0, planes.shape[1] - 2)
    s = idx & 63
    lo, hi = planes[k][w], planes[k][w + 1]
    sh = (64 - s).clamp(max=63)
    lo_s = torch.where(s == 0, lo, (lo >> s) & ((torch.ones_like(s) << sh)
                                                - 1))
    hi_s = torch.where(s == 0, torch.zeros_like(hi), hi << sh)
    return (lo_s | hi_s) & BAND


def _mask_model(tab, reads, lens, starts, max_novel):
    """The bit kernel's recurrence over [E] in torch int64: every plane as
    max_novel + 1 threshold masks (bit d of level k set when the cost at
    diagonal d is <= k), the row flags read from tab.planes, catalog
    insertions from tab.table at the set bits of the insertion window, the
    closure stopping per entry once a relaxation changes nothing."""
    NL = max_novel + 1
    E, W = reads.shape
    planes, table, P = tab.planes, tab.table.long(), tab.P
    ins_mask = length_mask(tab.ins_lens)
    rd = torch.from_numpy(reads).long()
    codes = torch.cat([rd & 0xFF, torch.full((E, IL), 6)], 1)
    lens = torch.from_numpy(lens).long()
    starts = torch.from_numpy(starts).long()
    zero = torch.zeros(E, dtype=torch.int64)
    cur = [torch.full((E,), 1 << DNEG) for _ in range(NL)]
    pend = [[zero] * NL for _ in range(IL)]
    fin = torch.full((E,), INF)
    ov = torch.zeros(E, dtype=torch.bool)
    for i in range(W + 1):
        cur = [c | p for c, p in zip(cur, pend[0])]
        pend = pend[1:] + [[zero] * NL]
        f = torch.full((E,), INF)
        for j in reversed(range(NL)):
            f = torch.where(cur[j] != 0, j, f)
        fin = torch.where(lens == i, f, fin)
        live = i < lens
        ind = live & (i > 0)
        ch = rd[:, min(i, W - 1)].clamp(0, 7)
        base = starts + i - DNEG
        dlo = (-base).clamp(0, D)
        dhi = (P - base).clamp(0, D)
        n_ok = (dhi - dlo).clamp(min=0)
        pok = ((torch.ones_like(n_ok) << n_ok) - 1) << dlo
        idx = base + OFF + PLANE_PAD
        fr = torch.stack([_window(planes, b, idx) for b in range(8)])[
            ch, torch.arange(E)] & pok
        on = ind & (pok != 0)
        ov |= on & ((cur[-1] & pok & _window(planes, PL_OVER, idx)) != 0)

        # closure: relax until nothing changes, at most NITER + 1 times
        def relax(c):
            gate = torch.where(on, c[-1] & pok, zero)
            nw = list(c)
            o = torch.zeros(E, dtype=torch.bool)
            for k, L in enumerate(tab.del_lens):
                has = gate & _window(planes, PL_DEL + k, idx)
                o |= (has >> (D - L)) != 0
                nw = [n | (((cj & has) << L) & BAND) for n, cj in zip(nw, c)]
            ng = gate & ~fr
            for L in (1, 2):
                o |= (ng >> (D - L)) != 0
                for j in range(L, NL):
                    nw[j] = nw[j] | (((c[j - L] & ng) << L) & BAND)
            return nw, o

        c, done = cur, ~on
        for it in range(NITER + 1):
            nw, o = relax(c)
            ov |= o & ~done
            diff = torch.zeros(E, dtype=torch.bool)
            for a, b in zip(nw, c):
                diff |= a != b
            if it == NITER:
                ov |= diff & ~done
                break
            c = [torch.where(~done & diff, a, b) for a, b in zip(nw, c)]
            done = done | ~diff
        cur = c

        # catalog insertions: the set bits of the gated insertion window
        win4 = sum(codes[:, i + k] << (8 * k) for k in range(IL))
        cand = torch.where(on, cur[-1] & pok & _window(planes, PL_INS, idx),
                           zero)
        for d in range(D):
            sel = ((cand >> d) & 1) == 1
            if not sel.any():
                continue
            row = table[(base + OFF + d).clamp(0, len(table) - 1)]
            for s in range(NI):
                il = (row[:, 0] >> (9 + 3 * s)) & 7
                seq = row[:, 2 + s] & 0xFFFFFFFF
                nbytes = (torch.ones_like(il) << (8 * il.clamp(max=4))) - 1
                ok = (sel & (il > 0) & (((ins_mask >> il) & 1) == 1)
                      & (i + il <= lens) & (((win4 ^ seq) & nbytes) == 0))
                ov |= ok & (d < il)
                for L in range(1, IL + 1):
                    hit = ok & (il == L) & (d >= L)
                    pend[L - 1] = [p | torch.where(hit, (cj & (1 << d)) >> L,
                                                   zero)
                                   for p, cj in zip(pend[L - 1], cur)]

        # consume, novel insertions
        miss = pok & ~fr
        nx = [cur[0] & fr] + [(cur[j] & fr) | (cur[j - 1] & miss)
                              for j in range(1, NL)]
        ng = torch.where(ind, cur[-1] & miss, zero)
        for L in (1, 2):
            fits = i + L <= lens
            ov |= fits & ((ng & ((1 << L) - 1)) != 0)
            for j in range(L, NL):
                pend[L - 1][j] = pend[L - 1][j] | torch.where(
                    fits, (cur[j - L] & ng) >> L, zero)
        cur = [torch.where(live, a, b) for a, b in zip(nx, cur)]
    return fin.to(torch.int32), ov


def _edge_gene():
    """A random 240 bp backbone with a catalog deletion of 24 at 60 and a
    catalog insertion of GATC at 150: reads through either, proposed a
    few diagonals off, put finite states on the band's edges."""
    rng = np.random.default_rng(3)
    bb = "".join("ACGT"[c] for c in rng.integers(0, 4, 240))
    return JaxGeneRef(
        gene="X", backbone_name="X*BB", backbone=bb,
        allele_names=["X*A", "X*B", "X*C"], var_ids=["hv0", "hv1"],
        var_type=np.array([VT_DELETION, VT_INSERTION], np.int8),
        var_pos=np.array([60, 150], np.int32),
        var_len=np.array([24, 4], np.int32),
        var_data=["24", "GATC"], var_freq=np.array([30.0, 30.0], np.float32),
        links=np.array([[False, True, False], [False, False, True]]),
        exons=[(0, len(bb) - 1)], primary_exons=[(0, len(bb) - 1)],
        haplotypes=[])


def _edge_entries(gene):
    """Reads through the deletion and the insertion (and a plain one),
    each proposed at drifts -10..10 from its true start."""
    bb = gene.backbone
    rows = []
    for read, start in ((bb[30:60] + bb[84:130], 30),
                        (bb[120:150] + "GATC" + bb[150:190], 120),
                        (bb[100:150], 100)):
        for off in range(-10, 11):
            rows.append((encode_seq(read), start + off))
    W = max(len(r) for r, _ in rows)
    reads = np.full((len(rows), W), 4, np.int8)
    for i, (r, _s) in enumerate(rows):
        reads[i, :len(r)] = r
    return (reads, np.array([len(r) for r, _ in rows], np.int32),
            np.array([s for _, s in rows], np.int32))


@pytest.mark.parametrize("kind", KINDS + ("edges",))
@pytest.mark.parametrize("max_novel", [0, 2, 7])
def test_mask_model_equals_plain_and_hgtpu(kind, max_novel):
    """The bit kernel's recurrence, held exactly (cost and over) against
    the plain version and hgtpu on the same entries, with lengths 0, -1,
    past W and 1 among them; on the edge gene, entries that overflow by a
    catalog deletion past the top edge or a catalog insertion past the
    bottom one."""
    if kind == "edges":
        gene = _edge_gene()
        reads, lens, starts = _edge_entries(gene)
    else:
        gene = gene_of(kind)
        reads, lens, starts = entries_of(gene, {"deletion": 31,
                                                "insertion": 41,
                                                "wide": 51}[kind])
        lens[:4] = (0, -1, reads.shape[1] + 7, 1)
    jc, jo = JaxTables(gene).costs(reads, lens, starts, max_novel)
    jc, jo = np.asarray(jc), np.asarray(jo)
    tab = BandedDPTables(carried(gene), "cpu")
    pc, po = banded_costs_plain(
        tab.table, *(torch.from_numpy(x) for x in (reads, lens, starts)),
        tab.P, max_novel, tab.del_lens, tab.ins_lens)
    mc, mo = _mask_model(tab, reads, lens, starts, max_novel)
    assert np.array_equal(pc.numpy(), jc) and np.array_equal(po.numpy(), jo)
    assert np.array_equal(mc.numpy(), jc)
    assert np.array_equal(mo.numpy(), jo)
    # not vacuous: costs at the budget and beyond it both occur
    assert (jc <= max_novel).any() and (jc >= INF).any()
    if kind in ("deletion", "insertion") and max_novel == 7:
        assert jo.any() and (jc > 2).any()
    if kind == "edges" and max_novel:
        # the deletion's entries reach the top edge from one diagonal off;
        # the insertion's need five novel insertions to reach the bottom
        assert jo[:21].any() and (jo[21:42].any() or max_novel < 5)


@pytest.mark.parametrize("max_novel,kernel", [(0, "bits"), (2, "bits"),
                                              (7, "bits"), (8, "warp"),
                                              (30, "warp")])
def test_dp_plan(max_novel, kernel):
    """The kernel follows the budget alone; on CPU tensors each kernel's
    wrapper and banded_costs answer with the plain version and count no
    launch."""
    assert dp_plan(max_novel) == kernel
    tab = BandedDPTables(carried(gene_of("insertion")), "cpu")
    reads, lens, starts = (torch.from_numpy(x) for x in
                           entries_of(tab.gene, 7, n=12))
    args = (reads, lens, starts, tab.P, max_novel, tab.del_lens,
            tab.ins_lens)
    want = banded_costs_plain(tab.table, *args)
    before = (banded_costs.launches, banded_costs_bits.launches,
              banded_costs_warp.launches)
    for got in (banded_costs(tab.table, *args, planes=tab.planes),
                banded_costs_bits(tab.table, tab.planes, *args),
                banded_costs_warp(tab.table, *args)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (banded_costs.launches, banded_costs_bits.launches,
            banded_costs_warp.launches) == before


class _count_plain:
    """Counts banded_costs_plain's calls through banded_costs (on the
    CPU the wrapper takes the plain version: no kernel launch)."""

    def __init__(self):
        self.n = 0
        self.real = banded_dp.banded_costs_plain

        def spy(*a, **k):
            self.n += 1
            return self.real(*a, **k)
        banded_dp.banded_costs_plain = spy


def _key(a):
    if a is None:
        return None
    d = dataclasses.asdict(a)
    d.pop("uid")
    d["codes"] = bytes(d["codes"])
    d["alts"] = None if a.alts is None else [_key(x) for x in a.alts]
    return d


def test_aligner_device_verify_equals_hgtpu():
    """tests/test_banded_dp.py's bit-identity test, across the packages:
    the port with device verify on (the DP's plain version on the CPU)
    returns hgtpu's device-verify records and the port's host-only ones,
    read for read."""
    gene = gene_of("insertion")
    g = carried(gene)
    port_on = GeneAligner(g, device_verify="on", device="cpu")
    port_off = GeneAligner(g, device_verify="off", device="cpu")
    if port_on.native is None:
        pytest.fail("the native verifier is not built (make -C native)")
    jax_on = JaxAligner(gene, device_verify="on")
    rng = np.random.default_rng(9)
    r1, r2, _ = simulate_reads(gene, list(gene.allele_names[:3]),
                               simulate_interval=9, perbase_errorrate=2.0,
                               seed=0.25)
    names = [r.name for r in r1] + [r.name for r in r2]
    seqs = [r.seq for r in r1] + [r.seq for r in r2]
    for i in range(15):
        n = int(rng.integers(40, 110))
        seqs.append("".join("ACGT"[c] for c in rng.integers(0, 4, n)))
        names.append("junk%d" % i)
    calls = _count_plain()
    try:
        got = port_on.align_batch(names, seqs, "L")
    finally:
        banded_dp.banded_costs_plain = calls.real
    assert calls.n > 0
    want = jax_on.align_batch(names, seqs, "L")
    off = port_off.align_batch(names, seqs, "L")
    assert sum(a is not None for a in got) > 0.5 * len(seqs)
    assert [_key(a) for a in got] == [_key(a) for a in want]
    assert [_key(a) for a in got] == [_key(a) for a in off]
