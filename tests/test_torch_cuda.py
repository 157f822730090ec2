"""The port's CUDA kernels on the card (marked ``cuda``; they skip
without one).  This file imports no jax, so it runs on a machine that
has none:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets jax up.)  Each kernel
must equal its plain-torch version exactly and count its launch, a small
host-engine typing run on the card must equal the same run on the CPU,
and the production program's count_classes on the card must equal the
CPU's.
"""
import numpy as np
import pytest
import torch

from hgtpu_torch.devel import edges
from hgtpu_torch.ops.compat_kernel import (and_reduce, and_reduce_plain,
                                           and_reduce_slab, and_reduce_wide,
                                           k2_plan)
from hgtpu_torch.ops.placement_kernel import (placement_scores,
                                              placement_scores_plain)
from torch_threads import _torch_threads  # noqa: F401


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pwm_reads(seed, n, m, P):
    rng = np.random.default_rng(seed)
    pwm = np.zeros((P + 2 * m, 5), np.float32)
    pwm[m + np.arange(P), rng.integers(0, 4, P)] = 1.0
    snp = m + np.flatnonzero(rng.random(P) < 0.1)
    pwm[snp, rng.integers(0, 4, len(snp))] = 1.0
    reads = rng.integers(0, 5, (n, m)).astype(np.int8)
    reads[0, :7] = 9                   # out-of-range codes score 0
    return pwm, reads


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,m,P", [
    # N not a multiple of 128, P1 = P + m + 1 not a multiple of 128
    # (odd P1 takes the scalar stores); m = 1024 and 1152 rebuild the
    # Hankel tiles per 512 positions, 1152 with a short last slab
    (3, 40, 96, 700), (5, 130, 128, 333), (7, 8192, 128, 3557),
    (9, 17, 1024, 500), (11, 300, 64, 1000), (13, 129, 1152, 300)])
def test_k1_kernel_equals_plain(cuda, seed, n, m, P):
    pwm, reads = _pwm_reads(seed, n, m, P)
    reads[1, ::3] = -1                 # negative codes score 0 too
    pwm_d = torch.from_numpy(pwm).to(cuda)
    reads_d = torch.from_numpy(reads).to(cuda)
    before = placement_scores.launches
    got = placement_scores(pwm_d, reads_d)
    torch.cuda.synchronize()
    assert placement_scores.launches == before + 1
    assert torch.equal(got, placement_scores_plain(pwm_d, reads_d))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128])
def test_k1_kernel_general_pwm(cuda, m):
    """A PWM uniform in [0, 1), rounded through bf16: products that are
    not 0/1.  Tolerance atol=1e-2: float32 sums of up to 5m products,
    taken in another order than cuBLAS's, and tensor-core accumulation is
    not IEEE round-to-nearest (entries like 0.25 or 0.5 would still sum
    exactly and test nothing)."""
    rng = np.random.default_rng(m)
    n, P = 200, 900
    pwm = rng.random((P + 2 * m, 5), dtype=np.float32)
    pwm = torch.from_numpy(pwm).to(torch.bfloat16).to(torch.float32)
    reads = rng.integers(0, 6, (n, m)).astype(np.int8)
    pwm_d, reads_d = pwm.to(cuda), torch.from_numpy(reads).to(cuda)
    got = placement_scores(pwm_d, reads_d)
    want = placement_scores_plain(pwm_d, reads_d)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,m,P", [(15, 70, 128, 400), (17, 70, 40, 400),
                                        (19, 9, 8, 50)])
def test_k1_kernel_unaligned_codes_and_ragged_width(cuda, seed, n, m, P):
    """Inputs the kernel does not take as they are, which the wrapper
    hands it as k16_operands: codes whose base is not 16-byte aligned,
    and read widths that are not a multiple of 16."""
    pwm, reads = _pwm_reads(seed, n, m, P)
    pwm_d = torch.from_numpy(pwm).to(cuda)
    buf = torch.empty(n * m + 1, dtype=torch.int8, device=cuda)
    reads_d = buf[1:].view(n, m)
    reads_d.copy_(torch.from_numpy(reads))
    assert reads_d.data_ptr() % 16 == 1
    got = placement_scores(pwm_d, reads_d)
    torch.cuda.synchronize()
    assert torch.equal(got, placement_scores_plain(pwm_d, reads_d))


def _k2_operands(seed, V1, W, H, K, device):
    """Random words (bit 31 set in about half), the all-ones sentinel
    row last, indices out of range on both sides, padding slots."""
    rng = np.random.default_rng(seed)
    links = rng.integers(0, 2**32, (V1, W), dtype=np.uint64).astype(np.uint32)
    links[:, 0] |= 0x80000000
    links[V1 - 1] = 0xFFFFFFFF
    vars_ = rng.integers(-V1 - 4, V1 + 4, (H, K)).astype(np.int32)
    vars_[::3, K // 2:] = V1 - 1
    return (torch.from_numpy(links.view(np.int32)).to(device),
            torch.from_numpy(vars_).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("H,K,A", [(13, 16, 3600), (64, 32, 100),
                                   (16384, 32, 3600)])
def test_k2_kernel_equals_plain(cuda, H, K, A):
    """and_reduce on the card: the slab variant at these tables, one
    launch counted, bitwise equal to the plain version."""
    links_d, vars_d = _k2_operands(H + K, 41, (A + 31) // 32, H, K, cuda)
    before = and_reduce_slab.launches, and_reduce_wide.launches
    got = and_reduce(links_d, vars_d)
    torch.cuda.synchronize()
    assert (and_reduce_slab.launches, and_reduce_wide.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(got, and_reduce_plain(links_d, vars_d))


@pytest.mark.cuda
@pytest.mark.parametrize("V1,W,H,K", [
    (41, 1, 301, 1), (41, 3, 301, 33), (41, 4, 301, 16),
    (1498, 113, 8192, 16), (1498, 200, 301, 33), (3000, 113, 1000, 16),
    (6000, 113, 999, 32), (11000, 113, 777, 17)])
def test_k2_variants_equal_plain(cuda, V1, W, H, K):
    """Both variants on the same operands: the slab kernel at the width
    k2_plan picks (32, 16, 8 and 4 among these) and at every narrower
    width that fits, and the wide kernel."""
    links_d, vars_d = _k2_operands(V1 + W + K, V1, W, H, K, cuda)
    want = and_reduce_plain(links_d, vars_d)
    _, ws = k2_plan(V1, W)
    for w in [x for x in (32, 16, 8, 4) if x <= ws]:
        assert torch.equal(and_reduce_slab(links_d, vars_d, w), want), w
    assert torch.equal(and_reduce_wide(links_d, vars_d), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k2_wide_table_takes_the_wide_kernel(cuda):
    """A table past the slab limit goes to the wide kernel; the slab
    kernel refuses it."""
    V1 = 14000
    assert k2_plan(V1, 113) == ("wide", None)
    links_d, vars_d = _k2_operands(7, V1, 113, 2000, 16, cuda)
    before = and_reduce_slab.launches, and_reduce_wide.launches
    got = and_reduce(links_d, vars_d)
    torch.cuda.synchronize()
    assert (and_reduce_slab.launches, and_reduce_wide.launches) == \
        (before[0], before[1] + 1)
    assert torch.equal(got, and_reduce_plain(links_d, vars_d))
    with pytest.raises(RuntimeError, match="and_reduce_slab"):
        and_reduce_slab(links_d, vars_d, 4)


@pytest.mark.cuda
def test_type_reads_card_equals_cpu(cuda):
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions
    from synth import make_gene_msa    # tests/ is on sys.path under pytest

    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=0.0)
    r1, r2, _ = simulate_reads(gene, [gene.allele_names[3],
                                      gene.allele_names[17]],
                               simulate_interval=4, perbase_errorrate=1.0,
                               seed=5)
    reads = ([(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2])
    launches = placement_scores.launches, and_reduce_slab.launches
    # the host-engine path ("auto" on CUDA is the production path)
    on_card = type_reads(gene, *reads,
                         TypingOptions(simulation=True, device_typing="off"),
                         device=cuda)
    assert placement_scores.launches > launches[0]
    assert and_reduce_slab.launches > launches[1]
    on_cpu = type_reads(gene, *reads,
                        TypingOptions(simulation=True, device_counting="off"),
                        device="cpu")
    for f in ("cmpt", "exon_cmpt", "primary_exon_cmpt", "counts", "prob",
              "num_reads", "num_pairs"):
        a, b = getattr(on_card, f), getattr(on_cpu, f)
        if isinstance(a, dict):
            a, b = list(a.items()), list(b.items())
        assert a == b, f


@pytest.mark.cuda
def test_count_classes_card_equals_cpu(cuda):
    """The production program on the card (K1 in the place pass) returns
    the CPU's count_classes dict, at 5 % per-base error on the indel
    gene, fused and tiered."""
    import os

    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from synth import make_gene_msa

    spec = make_gene_msa(seed=3, n_alleles=40)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=8.0)
    r1, r2, _ = simulate_reads(gene, gene.allele_names[:2],
                               simulate_interval=2, read_len=100,
                               frag_len=250, seed=11, perbase_errorrate=5.0)
    outs = {}
    for spell in ("auto", "off"):
        os.environ["HGTPU_FUSED_SPELL"] = spell
        try:
            for dev in (cuda, torch.device("cpu")):
                st = ShardedTyper(gene, dev, class_cap=64)
                before = placement_scores.launches
                outs[spell, dev.type] = st.count_classes(
                    st.encode([r.seq for r in r1]),
                    st.encode([r.seq for r in r2]))
                if dev.type == "cuda":
                    assert placement_scores.launches > before
        finally:
            del os.environ["HGTPU_FUSED_SPELL"]
    for spell in ("auto", "off"):
        got, want = outs[spell, "cuda"], outs[spell, "cpu"]
        for k in ("pileup", "punt", "excl", "n_reads", "n_pairs"):
            assert np.array_equal(got[k], want[k]), (spell, k)
        for name, parts in want["levels"].items():
            for g, w in zip(got["levels"][name], parts):
                assert np.array_equal(g, w), (spell, name)
            assert np.array_equal(got["order"][name], want["order"][name])
        for gw, ww in zip(got["winner"], want["winner"]):
            for k in ww:
                assert np.array_equal(gw[k], ww[k]), (spell, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 301, 4097])
def test_count_product_card_exact_above_bf16(cuda, n):
    """compat_mxu's product on the card: bf16 operands, float32 output,
    exact past bf16's 256 and equal to the CPU's."""
    from hgtpu_torch.parallel.e2e import count_product

    x = torch.zeros((3, 4999), dtype=torch.bfloat16)
    x[0, :n] = 1
    x[1, 1:n + 1:2] = 1
    links = torch.ones((4999, 3600), dtype=torch.bfloat16)
    links[::3, 1::2] = 0
    got = count_product(x.to(cuda), links.to(cuda))
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), count_product(x, links))
    assert float(got[0, 0]) == n


def _dp_gene(kind):
    from hgtpu_torch.db import build_gene_ref
    from synth import make_gene_msa

    if kind == "deletion":
        spec = make_gene_msa(seed=11, n_alleles=24, length=1600, n_del=10,
                             n_ins=8)
        mvf = 0.0
    else:
        spec = make_gene_msa(seed=15, n_alleles=24, length=1600, n_ins=14)
        mvf = 8.0
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=mvf)
    return gene


def _dp_entries(gene, seed, n, device):
    """Allele windows (some mutated) proposed at drifts up to past both
    band edges, junk reads, ragged and odd lengths (0, negative, past
    W), starts past both backbone ends."""
    from hgtpu_torch.utils.dna import encode_seq

    rng = np.random.default_rng(seed)
    P = len(gene.backbone)
    rows = []
    for k in range(n):
        a = gene.allele_names[int(rng.integers(0, gene.n_alleles))]
        seq = gene.allele_seq(a)
        ln = int(rng.integers(30, 151))
        s = int(rng.integers(0, max(1, len(seq) - ln)))
        read = list(seq[s:s + ln])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(read) - 1))
            read[p] = "ACGT"[int(rng.integers(0, 4))]
        if k % 5 == 4:
            read = ["ACGT"[c] for c in rng.integers(0, 4, ln)]
        rows.append((encode_seq("".join(read)),
                     s + int(rng.integers(-30, 31))))
    W = max(len(r) for r, _ in rows)
    reads = rng.integers(0, 5, (n, W)).astype(np.int8)   # junk past lens
    for i, (r, _s) in enumerate(rows):
        reads[i, :len(r)] = r
    lens = np.array([len(r) for r, _ in rows], np.int32)
    starts = np.array([s for _, s in rows], np.int32)
    lens[:4] = (0, -1, W + 7, 1)
    starts[4:8] = (-40, -1, P - 1, P + 100)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (reads, lens, starts))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kind,max_novel,n", [
    ("bits", "deletion", 2, 1001), ("bits", "insertion", 2, 515),
    ("bits", "insertion", 0, 64), ("bits", "deletion", 7, 301),
    ("bits", "insertion", 7, 129), ("warp", "deletion", 30, 301),
    ("warp", "insertion", 30, 33)])
def test_dp_kernel_equals_plain(cuda, kernel, kind, max_novel, n):
    """The banded DP kernel dp_plan picks for the budget (the bit kernel
    at 0-7, the warp kernel past it) on the card, one launch counted on
    it and none on the other, bitwise equal to its plain version on the
    same tensors (cost and over)."""
    from hgtpu_torch.ops.banded_dp import (BandedDPTables, banded_costs,
                                           banded_costs_bits,
                                           banded_costs_plain,
                                           banded_costs_warp, dp_plan)

    assert dp_plan(max_novel) == kernel
    tab = BandedDPTables(_dp_gene(kind), cuda)
    reads, lens, starts = _dp_entries(tab.gene, n + max_novel, n, cuda)
    args = (tab.table, reads, lens, starts, tab.P, max_novel,
            tab.del_lens, tab.ins_lens)
    before = (banded_costs.launches, banded_costs_bits.launches,
              banded_costs_warp.launches)
    cost, over = banded_costs(*args, planes=tab.planes)
    torch.cuda.synchronize()
    bits = int(kernel == "bits")
    assert (banded_costs.launches, banded_costs_bits.launches,
            banded_costs_warp.launches) == \
        (before[0] + 1, before[1] + bits, before[2] + 1 - bits)
    want_c, want_o = banded_costs_plain(*args)
    assert torch.equal(cost, want_c)
    assert torch.equal(over, want_o)
    assert (want_c <= max_novel).any()
    if max_novel >= 7:
        assert want_o.any()


@pytest.mark.cuda
def test_dp_warp_kernel_at_small_budgets(cuda):
    """The warp kernel holds at the bit kernel's budgets too (chip_smoke
    times the two on the same operands)."""
    from hgtpu_torch.ops.banded_dp import (BandedDPTables, banded_costs_plain,
                                           banded_costs_warp)

    tab = BandedDPTables(_dp_gene("insertion"), cuda)
    reads, lens, starts = _dp_entries(tab.gene, 5, 400, cuda)
    for b in (0, 2, 7):
        args = (tab.table, reads, lens, starts, tab.P, b, tab.del_lens,
                tab.ins_lens)
        got = banded_costs_warp(*args)
        want = banded_costs_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _tall_gene(P, seed):
    """A random backbone of P bases with SNPs every ~37, insertions of 1-4
    every ~500 and catalog deletions of every length 1-24 (the band's
    widest): 35 bit planes, so P = 20,000 stages them in dynamic shared
    memory past 48 KB and P = 60,000 reads them from device memory."""
    from hgtpu_torch.db.catalog import (GeneRef, VT_DELETION, VT_INSERTION,
                                        VT_SINGLE)

    rng = np.random.default_rng(seed)
    bb = "".join("ACGT"[c] for c in rng.integers(0, 4, P))
    var = []
    for p in range(20, P - 40, 37):
        var.append((VT_SINGLE, p, 1, "ACGT"[(int("ACGT".index(bb[p])) + 1)
                                            % 4]))
    for k, p in enumerate(range(50, P - 40, 500)):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 1 + k % 4))
        var.append((VT_INSERTION, p, len(seq), seq))
    for k, p in enumerate(range(31, P - 60, max(1, P // 96))):
        L = 1 + k % 24
        var.append((VT_DELETION, p, L, str(L)))
    var.sort(key=lambda v: v[1])
    V = len(var)
    return GeneRef(
        gene="T", backbone_name="T*BB", backbone=bb,
        allele_names=["T*A", "T*B"], var_ids=["hv%d" % i for i in range(V)],
        var_type=np.array([v[0] for v in var], np.int8),
        var_pos=np.array([v[1] for v in var], np.int32),
        var_len=np.array([v[2] for v in var], np.int32),
        var_data=[v[3] for v in var],
        var_freq=np.full(V, 20.0, np.float32),
        links=rng.random((V, 2)) < 0.3, exons=[(0, P - 1)],
        primary_exons=[(0, P - 1)], haplotypes=[])


@pytest.mark.cuda
@pytest.mark.parametrize("P", [20000, 60000])
def test_dp_bit_kernel_tall_genes(cuda, P):
    """The bit kernel where its planes pass 48 KB (dynamic shared memory)
    and 200 KB (device memory through L1): bitwise equal to the plain
    version, with reads drawn across the whole backbone."""
    from hgtpu_torch.ops.banded_dp import (BandedDPTables, banded_costs_bits,
                                           banded_costs_plain)

    tab = BandedDPTables(_tall_gene(P, P), cuda)
    assert len(tab.del_lens) == 24
    nbytes = tab.planes.numel() * 8
    assert nbytes > (48 if P == 20000 else 200) * 1024
    reads, lens, starts = _dp_entries(tab.gene, 3, 2000, cuda)
    for b in (2, 7):
        args = (tab.table, reads, lens, starts, tab.P, b, tab.del_lens,
                tab.ins_lens)
        got = banded_costs_bits(tab.table, tab.planes, *args[1:])
        want = banded_costs_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (want[0] <= b).any()


@pytest.mark.cuda
def test_aligner_device_verify_card_equals_cpu(cuda):
    """"auto" on the card is device verify (the DP kernel launches), and
    the records equal the CPU's host-only ones."""
    import dataclasses

    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.ops.banded_dp import banded_costs
    from hgtpu_torch.sim import simulate_reads

    gene = _dp_gene("insertion")
    card = GeneAligner(gene, device=cuda)
    if card.native is None:
        pytest.fail("the native verifier is not built (make -C native)")
    assert card._dp_tables is not None
    cpu = GeneAligner(gene, device="cpu")
    assert cpu._dp_tables is None
    r1, r2, _ = simulate_reads(gene, list(gene.allele_names[:3]),
                               simulate_interval=5, perbase_errorrate=2.0,
                               seed=3)
    groups = [([r.name for r in r1], [r.seq for r in r1], "L"),
              ([r.name for r in r2], [r.seq for r in r2], "R")]
    before = banded_costs.launches
    got = card.align_batches(groups)
    assert banded_costs.launches > before

    def key(a):
        if a is None:
            return None
        d = dataclasses.asdict(a)
        d.pop("uid")
        d["codes"] = bytes(d["codes"])
        d["alts"] = None if a.alts is None else [key(x) for x in a.alts]
        return d

    want = cpu.align_batches(groups)
    for g, w in zip(got, want):
        assert [key(a) for a in g] == [key(a) for a in w]


def _panel(n_genes=6, length=3500, n_alleles=8):
    """A PanelRouter on the card and one on the CPU over one family."""
    from hgtpu_torch.align import PanelRouter
    from hgtpu_torch.db import build_catalog_from_msa
    from synth import make_family

    fam = make_family(genes=tuple("ABCDEF"[:n_genes]), n_alleles=n_alleles,
                      length=length, seed=21)
    cat = build_catalog_from_msa("hla", {
        g: dict(names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"])
        for g, s in fam["specs"].items()}, min_var_freq=0.0)
    refs = [(g, cat.genes[g]) for g in cat.genes]
    return fam, PanelRouter(refs, device="cuda"), PanelRouter(refs,
                                                              device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [100, 600])
def test_k1_at_the_panel_shape(cuda, read_len):
    """K1 at the router's shape (the whole panel, no padding rows; m =
    128, and 512 for reads past the spacer), exact; and gene_max on the
    card equals the CPU's."""
    fam, card, cpu = _panel()
    rng = np.random.default_rng(read_len)
    genome = fam["genome"]
    pos = rng.integers(0, len(genome) - read_len, 3000)
    seqs = [genome[p:p + read_len] for p in pos]
    from hgtpu_torch.ops.placement import encode_reads

    m = min(-(-read_len // 128) * 128, 512)
    reads = torch.from_numpy(encode_reads(seqs, m)).to(cuda)
    before = placement_scores.launches
    got = placement_scores(card.pwm_concat, reads)
    torch.cuda.synchronize()
    assert placement_scores.launches == before + 1
    assert got.shape == (len(seqs), card.pwm_concat.shape[0] - m + 1)
    assert torch.equal(got, placement_scores_plain(card.pwm_concat, reads))
    gm, lens = card.gene_max(seqs)
    gm_cpu, lens_cpu = cpu.gene_max(seqs)
    assert np.array_equal(gm, gm_cpu) and np.array_equal(lens, lens_cpu)
    assert gm.max() >= min(read_len, 512) - 10


@pytest.mark.cuda
@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("n", [64 * 200 - 1, 30011])
def test_fm_search_card_equals_cpu(cuda, checkpoint, n):
    """The FM search on the card equals the CPU's, full and checkpointed;
    n + 1 = 12,800 = 200 x 64 rows reads block row nblk on the first
    rank, which the port clamps (a gather there would be a device-side
    assert)."""
    from hgtpu_torch.ops.fm import FMIndex, pack_queries

    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n).astype(np.int8)
    text = "".join("ACGT"[c] for c in codes)
    qs = []
    for k in range(4000):
        ln = int(rng.integers(12, 33))
        p = int(rng.integers(0, n - ln))
        q = text[p:p + ln]
        if k % 3 == 1:
            q = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
        qs.append(q)
    q = pack_queries(qs, 32)
    card = FMIndex(codes, checkpoint=checkpoint, device=cuda)
    cpu = FMIndex(codes, checkpoint=checkpoint, device="cpu")
    lo, hi = card.search_batch(q)
    torch.cuda.synchronize()
    c_lo, c_hi = cpu.search_batch(q)
    assert np.array_equal(lo, c_lo) and np.array_equal(hi, c_hi)
    assert (hi > lo).sum() >= 2000


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,P1", edges.K1_SHAPES)
def test_k1_kernel_at_degenerate_shapes(cuda, n, m, P1):
    """No read, one read, one diagonal and none, less than one 128-wide
    tile, a read width of 1 and of 0: equal to the plain version; an
    empty problem launches (and counts) nothing."""
    pwm, reads = (torch.from_numpy(x).to(cuda) for x in
                  edges.k1_operands(n, m, P1, seed=n + m + P1))
    before = placement_scores.launches
    got = placement_scores(pwm, reads)
    torch.cuda.synchronize()
    assert placement_scores.launches - before == int(bool(n and m and P1))
    assert got.shape == (n, P1)
    assert torch.equal(got, placement_scores_plain(pwm, reads))


@pytest.mark.cuda
@pytest.mark.parametrize("V1,W,H,K", edges.K2_SHAPES)
def test_k2_kernels_at_degenerate_shapes(cuda, V1, W, H, K):
    """H of 0 and 1, W = 1, V+1 = 1, K of 0 and 1: both variants equal
    the plain version; an empty result launches nothing."""
    links, vars_ = (torch.from_numpy(x).to(cuda) for x in
                    edges.k2_operands(V1, W, H, K, seed=V1 + W + H + K))
    want = and_reduce_plain(links, vars_)
    for fn, call in ((and_reduce_slab, lambda: and_reduce_slab(
                          links, vars_, k2_plan(V1, W)[1])),
                     (and_reduce_wide, lambda: and_reduce_wide(links,
                                                               vars_))):
        before = fn.launches
        got = call()
        torch.cuda.synchronize()
        assert fn.launches - before == int(bool(H and W)), fn.__name__
        assert tuple(got.shape) == (H, W)
        assert torch.equal(got, want), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("name,E,W,budget", edges.DP_SHAPES)
def test_dp_bit_kernel_at_degenerate_shapes(cuda, name, E, W, budget):
    """E of 0 and 1, reads one base wide, a 104-bp gene and a gene with
    no variant: cost and over equal the plain version's."""
    from hgtpu_torch.ops.banded_dp import (BandedDPTables, banded_costs_bits,
                                           banded_costs_plain)

    tab = BandedDPTables(edges.build(edges.specs()[name]), cuda)
    reads, lens, starts = (torch.from_numpy(np.ascontiguousarray(x))
                           .to(cuda) for x in
                           edges.dp_operands(tab.gene, E, W, seed=E + W))
    args = (tab.table, reads, lens, starts, tab.P, budget, tab.del_lens,
            tab.ins_lens)
    before = banded_costs_bits.launches
    cost, over = banded_costs_bits(tab.table, tab.planes, *args[1:])
    torch.cuda.synchronize()
    assert banded_costs_bits.launches - before == int(bool(E))
    want_c, want_o = banded_costs_plain(*args)
    assert torch.equal(cost, want_c) and torch.equal(over, want_o)


@pytest.mark.cuda
@pytest.mark.parametrize("budget,E", [(2, 4000), (0, 300), (7, 600), (2, 1),
                                      (2, 0)])
def test_proposal_bound_kernel_equals_lb_core(cuda, budget, E):
    """The verify prep's bound kernel on the card equals the aligner's
    numpy _lb_core (its plain version), one launch counted (none at E
    = 0): windows of 1 to _LB_TAIL columns, front clips, the pad code, an
    exit at every cap (test_torch_proposals.bound_case)."""
    from hgtpu_torch.ops.proposal_bound import proposal_bound
    from test_torch_proposals import bound_case

    ga, args, want = bound_case(_dp_gene("deletion"), budget, E,
                                seed=budget * 10 + E, device=cuda)
    before = proposal_bound.launches
    got = proposal_bound(*args)
    torch.cuda.synchronize()
    assert proposal_bound.launches == before + (E > 0)
    assert got.dtype == torch.int8 and got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), want)
    if E > 100:
        assert set(want.tolist()) == set(range(budget + 2))


@pytest.mark.cuda
def test_family_aligner_card_equals_cpu(cuda):
    """A FamilyAligner on the card (router, per-gene alignment, the bound
    kernel in the verify prep and the DP) gives the CPU's records on a
    six-gene synthetic panel with stacked indels and sequencing errors;
    every bounded entry was bounded on the card."""
    import dataclasses

    from hgtpu_torch.align import FamilyAligner
    from hgtpu_torch.db import build_catalog_from_msa
    from hgtpu_torch.ops.proposal_bound import proposal_bound
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.utils.trace import TRACE
    from synth import make_gene_msa

    msas = {g: make_gene_msa(gene=g, n_alleles=8, length=1500, n_del=24,
                             n_ins=16, seed=41 + 7 * k)
            for k, g in enumerate("ABCDEF")}
    cat = build_catalog_from_msa("hla", {
        g: dict(names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"])
        for g, s in msas.items()}, min_var_freq=0.0)
    ids, seqs = [], []
    for g, gene in cat.genes.items():
        r1, _r2, _ = simulate_reads(gene, list(gene.allele_names[:2]),
                                    simulate_interval=24,
                                    perbase_errorrate=2.0, seed=5)
        ids += [g + r.name for r in r1]
        seqs += [r.seq for r in r1]
    assert 300 <= len(seqs) <= 1000

    def key(a):
        if a is None:
            return None
        d = dataclasses.asdict(a)
        d.pop("uid")
        d["codes"] = bytes(d["codes"])
        d["alts"] = None if a.alts is None else [key(x) for x in a.alts]
        return d

    before = proposal_bound.launches
    c0 = TRACE.counters()
    got = FamilyAligner(cat, device=cuda).align_batch(ids, seqs, "L")
    c1 = TRACE.counters()
    assert proposal_bound.launches > before
    n = c1.get("verify.lb.entries", 0) - c0.get("verify.lb.entries", 0)
    assert n > 0
    assert c1.get("verify.lb.card", 0) - c0.get("verify.lb.card", 0) == n
    want = FamilyAligner(cat, device="cpu").align_batch(ids, seqs, "L")
    assert sorted(got) == sorted(want)
    for g in want:
        assert [key(a) for a in got[g]] == [key(a) for a in want[g]], g
