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
from hgtpu.db.catalog import GeneRef as JaxGeneRef, VT_DELETION
from hgtpu.ops.banded_dp import BandedDPTables as JaxTables
from hgtpu.sim import simulate_reads
from hgtpu.utils.dna import encode_seq
from hgtpu_torch.align import GeneAligner
from hgtpu_torch.ops import banded_dp
from hgtpu_torch.ops.banded_dp import (DNEG, DPOS, INF, BandedDPTables,
                                       banded_costs, pack_rows)
from tests.synth import make_gene_msa
from tests.test_torch_db import carried


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
