"""The port's last library functions, and the host-side behaviours that
hgtpu's own tests pin, held against hgtpu.

  write_bam, _encode_record   the file (and each record) byte for byte
                   equal to hgtpu's, for tests/test_bam.py's records, a
                   multi-block file, an empty one and unmapped records;
                   the same error for a tag type neither writes
  write_fasta_reads  a plain file byte-equal, a .gz file decompressing
                   to equal bytes (its header holds an mtime)
  revcomp_encoded  equal arrays on int8 codes 0-5 and on an empty array;
                   exported from hgtpu_torch.utils
  check_allele_validity  passes on a gene's own sequences; on a changed
                   one both raise AssertionError naming the allele
  twins            each of tests/test_bam.py's, test_staging.py's,
                   test_em.py's, test_haplotype_paths.py's and
                   test_error_correction.py:43's checks, and the ones of
                   test_fuzz.py, test_options.py, test_components.py and
                   test_observability.py that no other test_torch_* file
                   holds, run through both packages on the same inputs:
                   equal results, exact.
"""
import dataclasses
import gzip
import io
import os
import random

import numpy as np
import pytest

from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.utils import bam as jax_bam
from hgtpu.utils import io as jax_io
from hgtpu.utils.dna import revcomp
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.utils import bam, io as port_io
from tests.synth import make_family, make_gene_msa
from tests.test_bam import _recs
from tests.test_torch_db import assert_same_gene, carried
from tests.torch_threads import _torch_threads  # noqa: F401


# ---- write_bam and its record encoder ---- #

def _paired_recs(n=300, seed=9):
    """tests/test_torch_textdb.py's pairs: two references, a deletion in
    every CIGAR, four tag types; past one 64 KiB BGZF block."""
    rng = random.Random(seed)
    recs = []
    for k in range(n):
        seq = "".join(rng.choice("ACGTN") for _ in range(60))
        for mate, flag in ((1, 0x1 | 0x40), (2, 0x1 | 0x80 | 0x10)):
            recs.append({
                "name": "p%d" % k, "flag": flag,
                "rname": "chr6" if k % 7 else "chrX",
                "pos": 100 + 13 * k + (150 if mate == 2 else 0),
                "cigar": [("M", 30), ("D", 2), ("M", 30)],
                "seq": seq if mate == 1 else revcomp(seq),
                "qual": "".join(chr(33 + rng.randint(2, 40))
                                for _ in range(60)),
                "tags": {"NH": ("i", 1 if k % 5 else 2), "MD": ("Z", "60"),
                         "AS": ("i", -k % 9), "XS": ("A", "+"),
                         "ZF": ("f", k / 7.0)}})
    return recs


def _unmapped_recs():
    """Records with no reference, no CIGAR, no quality, an odd length,
    lower case and IUPAC bases, and no sequence at all."""
    return [{"name": "u1", "flag": 4, "seq": "acgtRYkmN", "qual": ""},
            {"name": "u2", "flag": 4, "rname": "*", "rnext": "chr6",
             "pnext": 7, "seq": "", "qual": ""},
            {"name": "u3", "flag": 0x4 | 0x1, "seq": "A", "qual": "~",
             "tags": {}}]


BAM_CASES = {
    "test_bam": ([("chr6", 1000), ("chrX", 500)], _recs, "@HD\tVN:1.6\n"),
    "paired": ([("chr6", 10000), ("chrX", 5000)], _paired_recs,
               "@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr6\tLN:10000\n"),
    "empty": ([], list, ""),
    "unmapped": ([("chr6", 100)], _unmapped_recs, ""),
}


@pytest.mark.parametrize("case", sorted(BAM_CASES))
def test_write_bam_bytes_equal_hgtpu(tmp_path, case):
    refs, recs, header = BAM_CASES[case]
    a, b = str(tmp_path / "h.bam"), str(tmp_path / "t.bam")
    jax_bam.write_bam(a, refs, recs(), header_text=header)
    bam.write_bam(b, refs, recs(), header_text=header)
    want = open(a, "rb").read()
    assert open(b, "rb").read() == want
    assert list(bam.read_bam(b)) == list(jax_bam.read_bam(a))
    if case == "paired":
        assert want.count(b"\x1f\x8b\x08\x04") > 2      # several blocks


def test_encode_record_equal_hgtpu():
    ref_ids = {"chr6": 0, "chrX": 1}
    for rec in _recs() + _paired_recs(20) + _unmapped_recs():
        assert bam._encode_record(rec, ref_ids) == \
            jax_bam._encode_record(rec, ref_ids)
    bad = dict(_recs()[0], tags={"XB": ("B", [1, 2])})
    with pytest.raises(ValueError) as want:
        jax_bam._encode_record(bad, ref_ids)
    with pytest.raises(ValueError) as got:
        bam._encode_record(bad, ref_ids)
    assert str(got.value) == str(want.value)


# ---- tests/test_bam.py's unit tests, each package on its own file ---- #

def _bam_pair(tmp_path, refs, recs, **kw):
    a, b = str(tmp_path / "h.bam"), str(tmp_path / "t.bam")
    jax_bam.write_bam(a, refs, recs, **kw)
    bam.write_bam(b, refs, recs, **kw)
    return a, b


def test_bam_round_trip_and_region_filter_equal_hgtpu(tmp_path):
    a, b = _bam_pair(tmp_path, [("chr6", 1000), ("chrX", 500)], _recs(),
                     header_text="@HD\tVN:1.6\n")
    back = list(bam.read_bam(b))
    assert back == list(jax_bam.read_bam(a)) and len(back) == 3
    for orig, got in zip(_recs(), back):
        for key in ("name", "flag", "rname", "pos", "mapq", "cigar",
                    "rnext", "pnext", "tlen", "seq", "qual"):
            assert got[key] == orig[key], key
    for region in (("chr6", 105, 200), ("chr6", 290, 310),
                   ("chrX", 0, 99), ("chrM", 0, 99)):
        got = list(bam.read_bam(b, region))
        assert got == list(jax_bam.read_bam(a, region)), region
    assert [r["name"] for r in bam.read_bam(b, ("chr6", 105, 200))] == ["r1"]


def test_bgzf_block_structure_equal_hgtpu(tmp_path):
    a, b = str(tmp_path / "h.bgzf"), str(tmp_path / "t.bgzf")
    for mod, path in ((jax_bam, a), (bam, b)):
        with mod.BgzfWriter(path) as w:
            w.write(b"x" * 200000)
    raw = open(b, "rb").read()
    assert raw == open(a, "rb").read()
    assert raw[:4] == b"\x1f\x8b\x08\x04" and b"BC" in raw[:18]
    assert raw.endswith(bam._BGZF_EOF)
    with gzip.open(b, "rb") as f:
        assert f.read() == b"x" * 200000


def test_reads_from_bam_semantics_equal_hgtpu(tmp_path):
    recs = [
        {"name": "p", "flag": 0x1 | 0x40, "rname": "chr6", "pos": 100,
         "cigar": [("M", 4)], "seq": "ACGT", "qual": "IIII",
         "tags": {"NH": ("i", 1)}},
        {"name": "p", "flag": 0x1 | 0x80 | 0x10, "rname": "chr6",
         "pos": 150, "cigar": [("M", 4)], "seq": "AAGG", "qual": "HIJK",
         "tags": {"NH": ("i", 1)}},
        {"name": "m", "flag": 0x1 | 0x40, "rname": "chr6", "pos": 120,
         "cigar": [("M", 4)], "seq": "CCCC", "qual": "IIII",
         "tags": {"NH": ("i", 2)}},
    ]
    a, b = _bam_pair(tmp_path, [("chr6", 1000)], recs)
    for paired in (True, False):
        got = bam.reads_from_bam(b, "chr6", 0, 400, paired=paired)
        assert got == jax_bam.reads_from_bam(a, "chr6", 0, 400,
                                             paired=paired)
    r1, r2 = bam.reads_from_bam(b, "chr6", 0, 400)
    assert [n for n, _s, _q in r1] == ["p"] and r1[0][1] == "ACGT"
    assert r2[0][1] == revcomp("AAGG") and r2[0][2] == "KJIH"


# ---- write_fasta_reads, revcomp_encoded, check_allele_validity ---- #

@pytest.mark.parametrize("suffix", ["fa", "fa.gz"])
def test_write_fasta_reads_equal_hgtpu(tmp_path, suffix):
    rng = random.Random(3)
    reads = [("r%d/%d" % (i, 1 + i % 2),
              "".join(rng.choice("ACGTN") for _ in range(rng.randint(0, 150))))
             for i in range(200)]
    a, b = str(tmp_path / ("h." + suffix)), str(tmp_path / ("t." + suffix))
    jax_io.write_fasta_reads(reads, a)
    port_io.write_fasta_reads(reads, b)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        assert fb.read() == fa.read()
    assert port_io.read_fastx(b) == jax_io.read_fastx(a)


@pytest.mark.parametrize("case", ["random", "empty", "gaps_and_n"])
def test_revcomp_encoded_equal_hgtpu(case):
    from hgtpu.utils import revcomp_encoded as want
    from hgtpu_torch.utils import decode_seq, encode_seq, revcomp_encoded
    from hgtpu_torch.utils.dna import revcomp_encoded as got

    assert got is revcomp_encoded
    rng = np.random.default_rng(5)
    codes = {"random": rng.integers(0, 5, 1001).astype(np.int8),
             "empty": np.zeros(0, np.int8),
             "gaps_and_n": encode_seq("NN.ACGT..TTN" * 7)}[case]
    before = codes.copy()
    out = got(codes)
    ref = want(codes)
    assert out.dtype == ref.dtype == np.int8
    assert np.array_equal(out, ref) and out.shape == codes.shape
    assert np.array_equal(codes, before)                # input untouched
    assert decode_seq(out) == revcomp(decode_seq(codes))


@pytest.fixture(scope="module")
def exon_gene():
    """tests/test_components.py's gene: 20 alleles, 1.5 kb, exons."""
    spec = make_gene_msa(seed=11, n_alleles=20, length=1500)
    ref, _ = jax_build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return spec, ref


def test_check_allele_validity_equal_hgtpu(exon_gene):
    from hgtpu.validate import check_allele_validity as want
    from hgtpu_torch.validate import check_allele_validity as got

    spec, ref = exon_gene
    gene = carried(ref)
    seqs = {n: r.replace(".", "").replace("~", "")
            for n, r in zip(spec["names"], spec["rows"])
            if n in ref.allele_names}
    assert got(gene, seqs) is None and want(ref, seqs) is None
    name = ref.allele_names[7]
    bad = dict(seqs)
    bad[name] = "A" + bad[name][1:] if bad[name][0] != "A" \
        else "C" + bad[name][1:]
    with pytest.raises(AssertionError) as w:
        want(ref, bad)
    with pytest.raises(AssertionError) as g:
        got(gene, bad)
    assert str(g.value) == str(w.value) == name
    with pytest.raises(type(_raised(want, ref, {"A*none": "ACGT"}))):
        got(gene, {"A*none": "ACGT"})


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:          # noqa: BLE001 - the type is compared
        return e
    raise AssertionError("%s did not raise" % fn.__name__)


def test_validation_suite_equal_hgtpu(exon_gene):
    """tests/test_components.py:50, and the suite's failure on a gene
    whose allele does not rebuild its MSA row."""
    from hgtpu.validate import validate_gene as want
    from hgtpu_torch.validate import validate_gene as got

    spec, ref = exon_gene
    gene = carried(ref)
    got(gene, spec["rows"], spec["names"])
    want(ref, spec["rows"], spec["names"])
    got(gene)
    rows = list(spec["rows"])
    i = spec["names"].index(ref.allele_names[3])
    rows[i] = rows[i].replace("A", "C", 1)
    g = _raised(got, gene, rows, spec["names"])
    w = _raised(want, ref, rows, spec["names"])
    assert type(g) is type(w) is AssertionError and str(g) == str(w)


# ---- the db builder fuzz and the build flags ---- #

def test_db_builder_fuzz_equals_hgtpu():
    """tests/test_fuzz.py:31: 15 random MSAs (seed 99) built by both
    packages; every allele rebuilds its row."""
    from hgtpu_torch.devel.edges import random_msa
    from tests.test_fuzz import _random_msa

    rng, rng2 = random.Random(99), random.Random(99)
    for trial in range(15):
        n, L = rng.randint(2, 12), rng.randint(150, 600)
        assert (n, L) == (rng2.randint(2, 12), rng2.randint(150, 600))
        names, rows = random_msa(rng, n, L)
        assert (names, rows) == _random_msa(rng2, n, L)
        args = ("F", names, rows, names[0])
        got, got_id = build_gene_ref(*args, min_var_freq=0.0)
        want, want_id = jax_build_gene_ref(*args, min_var_freq=0.0)
        assert_same_gene(got, want)
        assert got_id == want_id
        for name in got.allele_names:
            assert got.allele_seq(name) == \
                rows[names.index(name)].replace(".", ""), (trial, name)


def test_build_flags_change_artifacts_equal_hgtpu():
    """tests/test_options.py:213: min_var_freq, the haplotype gaps,
    whole_haplotype and leftshift give hgtpu's genes."""
    spec = make_gene_msa(seed=21)
    kw = dict(exons_ref_coords=spec["exons"],
              primary_exon_idx=spec["primary_exon_idx"])
    args = ("A", spec["names"], spec["rows"], spec["ref_allele"])
    genes = {}
    for name, extra in (("lo", dict(min_var_freq=0.0)),
                        ("hi", dict(min_var_freq=20.0)),
                        ("wide", dict(min_var_freq=0.0, inter_gap=30,
                                      intra_gap=50)),
                        ("tight", dict(min_var_freq=0.0, inter_gap=2,
                                       intra_gap=4)),
                        ("whole", dict(min_var_freq=0.0,
                                       whole_haplotype=True)),
                        ("unshifted", dict(min_var_freq=0.0,
                                           leftshift=False))):
        got, _ = build_gene_ref(*args, **kw, **extra)
        assert_same_gene(got, jax_build_gene_ref(*args, **kw, **extra)[0])
        genes[name] = got
    assert len(genes["hi"].backbone) < len(genes["lo"].backbone)
    assert (genes["hi"].var_freq < 20.0).sum() > 0
    assert len(genes["tight"].haplotypes) != len(genes["wide"].haplotypes)
    assert len(genes["whole"].haplotypes) <= genes["whole"].n_alleles
    assert len(genes["whole"].haplotypes) < len(genes["wide"].haplotypes)
    assert genes["unshifted"].n_vars != genes["wide"].n_vars or \
        not (genes["unshifted"].var_pos == genes["wide"].var_pos).all()


@pytest.mark.parametrize("kw", [
    dict(simulate_interval=10, read_len=80, frag_len=200, seed=3),
    dict(simulate_interval=20, read_len=100, frag_len=300, seed=3),
    dict(simulate_interval=9, seed=5),
    dict(simulate_interval=9, perbase_snprate=0.0, seed=5),
])
def test_simulation_flags_equal_hgtpu(exon_gene, kw):
    """tests/test_options.py:36 and :251: read length, fragment length,
    interval and a zero SNP rate reach the simulator as in hgtpu."""
    from hgtpu.sim import simulate_reads as want
    from hgtpu_torch.sim import simulate_reads as got

    _, ref = exon_gene
    allele = [ref.allele_names[0]]
    g1, g2, gn = got(carried(ref), allele, **kw)
    w1, w2, wn = want(ref, allele, **kw)
    assert gn == wn
    assert [(r.name, r.seq) for r in g1 + g2] == \
        [(r.name, r.seq) for r in w1 + w2]
    assert all(len(r.seq) == kw.get("read_len", 100) for r in g1)
    if kw.get("perbase_snprate") == 0.0:
        base = got(carried(ref), allele, simulate_interval=9, seed=5)
        assert [r.seq for r in g1] == [r.seq for r in base[0]]


# ---- the EM staging policy (tests/test_staging.py) and the EM ---- #

def test_staging_constants_and_policy_equal_hgtpu():
    import inspect

    import hgtpu.typer.staging as want
    import hgtpu_torch.parallel.e2e as e2e
    import hgtpu_torch.typer.engine as engine
    import hgtpu_torch.typer.staging as got

    assert (got.EXPANSION_TOP_RANK, got.EXPANSION_MIN_PROB) == \
        (want.EXPANSION_TOP_RANK, want.EXPANSION_MIN_PROB) == (10, 0.03)
    # the port's device program and host engine consume the one policy
    assert "expansion_winners" in inspect.getsource(e2e)
    assert "staged_abundance" in inspect.getsource(engine)
    for mod in (e2e, engine):
        src = inspect.getsource(mod)
        assert "0.03" not in src and "prob_i >= 10" not in src, mod.__name__


def _expansion_cases():
    yield ([(0, 0.5), (1, 0.3), (2, 0.1), (3, 0.02)],
           {0: [0, 5, 6], 1: [1], 2: [2, 7], 3: [3, 8], 4: [4, 9]})
    yield ([(i, 0.5 if i < 2 else 0.01) for i in range(20)],
           {i: [i, 100 + i] for i in range(20)})
    rng = np.random.default_rng(7)
    A = 512
    prob_vec = np.zeros(A)
    hot = rng.choice(A, 15, replace=False)
    prob_vec[hot] = rng.dirichlet(np.ones(15))
    groups = {int(i): [int(i), int(i) + A] for i in hot[::2]}
    order = np.argsort(-prob_vec, kind="stable")
    yield ([(int(i), float(prob_vec[i])) for i in order if prob_vec[i] > 0],
           groups)
    yield (sorted(((int(i), float(prob_vec[i])) for i in hot),
                  key=lambda t: -t[1]), groups)
    for _ in range(20):
        n = int(rng.integers(0, 30))
        p = np.sort(rng.dirichlet(np.ones(n)))[::-1] if n else []
        yield ([(i, float(x)) for i, x in enumerate(p)],
               {i: list(range(i, i + int(rng.integers(1, 4))))
                for i in range(n) if rng.random() < 0.5})


def test_expansion_winners_equal_hgtpu():
    """tests/test_staging.py:16, :28 and :57, and random rankings."""
    from hgtpu.typer.staging import expansion_winners as want
    from hgtpu_torch.typer.staging import expansion_winners as got

    cases = list(_expansion_cases())
    for ranked, groups in cases:
        assert got(ranked, groups) == want(ranked, groups)
    sel, psum = got(*cases[0])
    assert sel == {0, 5, 6, 2, 7, 3, 8} and abs(psum - 0.62) < 1e-12
    sel, psum = got(*cases[1])
    assert sel == set(range(10)) | {100 + i for i in range(10)}
    assert got(*cases[2]) == got(*cases[3])


def test_single_abundance_equals_hgtpu():
    """tests/test_em.py:41 and :45: the shipped float64 solver, exact
    against hgtpu's, with and without pruning and lengths."""
    from hgtpu.typer.em import _single_abundance_np as want_np
    from hgtpu.typer.em import single_abundance as want
    from hgtpu_torch.typer.em import _single_abundance_np as got_np
    from hgtpu_torch.typer.em import single_abundance as got
    from tests.test_em import _random_classes

    assert got({"X*01": 10}) == want({"X*01": 10}) == [["X*01", 1.0]]
    assert got({}) == want({}) == []
    rng = np.random.default_rng(11)
    for trial in range(6):
        _M, _c, names, cmpt = _random_classes(rng, A=60, C=40)
        lengths = {n: float(x) for n, x in
                   zip(names, rng.integers(800, 1200, len(names)))}
        for remove_low, ld in ((False, None), (True, None), (True, lengths)):
            assert got_np(cmpt, remove_low, ld or {}) == \
                want_np(cmpt, remove_low, ld or {}), trial
            assert got(cmpt, remove_low, ld) == want(cmpt, remove_low, ld)


# ---- the haplotype-window constraint (tests/test_haplotype_paths.py) ---- #

@pytest.fixture(scope="module")
def two_indels():
    from tests.test_haplotype_paths import _gene_two_indels

    ref = _gene_two_indels()
    return ref, carried(ref)


def _two_indel_reads(bb):
    from hgtpu_torch.devel.edges import recombinant_read

    return [recombinant_read(bb),
            (bb[10:20] + bb[22:60], 10),            # deletion only
            (bb[10:34] + "TT" + bb[34:60], 10),     # insertion only
            (bb[10:60], 10),                        # plain
            (bb[5:20] + bb[22:34] + "TT" + bb[34:45], 5)]


def test_haplotype_constraint_tables_equal_hgtpu(two_indels):
    from hgtpu.align.verify import build_haplotype_constraint as want
    from hgtpu_torch.align.verify import build_haplotype_constraint as got

    ref, gene = two_indels
    disallowed, cover_right = got(gene)
    assert (disallowed, cover_right) == want(ref)
    assert (0, 1) in disallowed and (1, 0) in disallowed
    assert cover_right[0] == 40


@pytest.mark.parametrize("haplotype_paths", [False, True])
def test_verifiers_equal_hgtpu_on_the_two_indel_gene(two_indels,
                                                     haplotype_paths):
    """tests/test_haplotype_paths.py:51, :68 and :82: the port's Python
    and native verifiers against hgtpu's, free and constrained."""
    from hgtpu.align.verify import GeneVerifier as JaxVerifier
    from hgtpu.utils.dna import encode_seq
    from hgtpu_torch.align.native_verify import NativeVerifier
    from hgtpu_torch.align.verify import GeneVerifier

    ref, gene = two_indels
    reads = _two_indel_reads(gene.backbone)
    want = JaxVerifier(ref, max_novel=2, haplotype_paths=haplotype_paths)
    host = GeneVerifier(gene, max_novel=2, haplotype_paths=haplotype_paths)
    nat = NativeVerifier(gene, max_novel=2, haplotype_paths=haplotype_paths)
    codes = [encode_seq(s) for s, _ in reads]
    starts = [p for _, p in reads]
    cost, ops = nat.verify_flat(codes, starts)
    for i, (c, s) in enumerate(zip(codes, starts)):
        w = want.verify(c, s)
        assert host.verify(c, s) == w, i
        if w is None:
            assert cost[i] < 0, i
        else:
            assert (int(cost[i]), ops[i]) == w, i
    free = want.verify(codes[0], starts[0])
    if not haplotype_paths:
        assert free[0] == 0 and {e[3] for e in free[1]} == {0, 1}
    elif free is not None:
        assert free[0] > 0 or {e[3] for e in free[1]} != {0, 1}


def test_native_differential_fuzz_equals_hgtpu():
    """tests/test_fuzz.py:69: the port's native verifier, its Python
    verifier and hgtpu's on 400 random reads of an indel-heavy gene at
    random starts, and on 100 backbone windows at their own starts."""
    from hgtpu.align.verify import GeneVerifier as JaxVerifier
    from hgtpu.utils.dna import encode_seq
    from hgtpu_torch.align.native_verify import NativeVerifier
    from hgtpu_torch.align.verify import GeneVerifier

    rng = random.Random(5)
    spec = make_gene_msa(seed=77, n_alleles=30, length=1500, n_snp=40,
                         n_del=25, n_ins=10)
    ref, _ = jax_build_gene_ref("A", spec["names"], spec["rows"],
                                spec["ref_allele"], min_var_freq=0.0)
    gene = carried(ref)
    reads, starts = [], []
    for _ in range(400):
        aseq = ref.allele_seq(ref.allele_names[rng.randrange(ref.n_alleles)])
        if len(aseq) < 120:
            continue
        p = rng.randrange(0, len(aseq) - 100)
        seq = list(aseq[p:p + 100])
        for _ in range(rng.randrange(0, 3)):
            seq[rng.randrange(100)] = rng.choice("ACGT")
        reads.append(encode_seq("".join(seq)))
        starts.append(rng.randrange(0, len(ref.backbone) - 50))
    for _ in range(100):        # backbone windows at their own starts
        p = rng.randrange(0, len(ref.backbone) - 100)
        seq = list(ref.backbone[p:p + 100])
        for _ in range(rng.randrange(0, 3)):
            seq[rng.randrange(100)] = rng.choice("ACGT")
        reads.append(encode_seq("".join(seq)))
        starts.append(p)
    cost, ops = NativeVerifier(gene).verify_flat(reads, starts)
    pv, want = GeneVerifier(gene), JaxVerifier(ref)
    n_found = 0
    for i in range(len(reads)):
        exp = want.verify(reads[i], starts[i])
        assert pv.verify(reads[i], starts[i]) == exp, i
        if exp is None:
            assert cost[i] == -1, i
        else:
            n_found += 1
            assert (int(cost[i]), ops[i]) == exp, i
    assert n_found > 0


def test_aligner_device_verify_on_the_recombinant_read(two_indels):
    """The two-indel gene's reads through GeneAligner with device verify
    on (the DP's plain version on the CPU) equal hgtpu's aligner."""
    from hgtpu.align import GeneAligner as JaxAligner
    from hgtpu_torch.align import GeneAligner
    from tests.test_torch_aligner import _record

    ref, gene = two_indels
    reads = _two_indel_reads(gene.backbone)
    names = ["r%d" % i for i in range(len(reads))]
    seqs = [s for s, _ in reads]
    got = GeneAligner(gene, device_verify="on", device="cpu")
    want = JaxAligner(ref, device_verify="on")
    assert got._dp_tables is not None
    a = got.align_batch(names, seqs, "L")
    b = want.align_batch(names, seqs, "L")
    assert [x and _record(x) for x in a] == [x and _record(x) for x in b]
    assert any(x is not None for x in a)


# ---- the weighted pileup (tests/test_error_correction.py:43) ---- #

def test_mpileup_weighted_equals_expanded_and_hgtpu():
    from hgtpu.align import GeneAligner as JaxAligner
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.mpileup import Mpileup as JaxMpileup
    from hgtpu_torch.typer.mpileup import Mpileup

    spec = make_gene_msa(seed=11, length=900)
    ref, _ = jax_build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    gene = carried(ref)
    r1, r2, _ = simulate_reads(ref, [ref.allele_names[5]],
                               simulate_interval=7, seed=2,
                               perbase_errorrate=1.0)
    outs = JaxAligner(ref).align_batches(
        [([r.name for r in r1], [r.seq for r in r1], "L"),
         ([r.name for r in r2], [r.seq for r in r2], "R")])
    alns = [a for g in outs for a in g if a is not None]
    w = [1 + (i % 3) for i in range(len(alns))]
    piles = []
    for cls, g in ((Mpileup, gene), (JaxMpileup, ref)):
        weighted = cls(g)
        weighted.add_alignments_bulk(alns, weights=w)
        weighted.finalize()
        expanded = cls(g)
        expanded.add_alignments_bulk(
            [a for a, wi in zip(alns, w) for _ in range(wi)])
        expanded.finalize()
        assert np.array_equal(weighted.counts, expanded.counts)
        assert np.array_equal(weighted.rep, expanded.rep)
        piles.append(weighted)
    assert np.array_equal(piles[0].counts, piles[1].counts)
    assert np.array_equal(piles[0].rep, piles[1].rep)


# ---- shared typing state (tests/test_device_count.py:141) ---- #

def test_gene_shared_state_cache_as_hgtpu(exon_gene):
    from hgtpu_torch.typer.engine import GeneTyper, shared_device_counter

    _, ref = exon_gene
    gene = carried(ref)
    t1, t2 = GeneTyper(gene, device="cpu"), GeneTyper(gene, device="cpu")
    assert t1.counter is t2.counter and t1.alts_left is t2.alts_left
    assert shared_device_counter(gene, "cpu") is \
        shared_device_counter(gene, "cpu")
    sub = gene.exclude_alleles([gene.allele_names[5]])
    assert "_typer_shared_torch" not in sub.__dict__
    assert GeneTyper(sub, device="cpu").counter is not t1.counter
    jsub = ref.exclude_alleles([ref.allele_names[5]])
    assert sub.allele_names == jsub.allele_names
    assert sub.n_vars == jsub.n_vars == gene.n_vars


# ---- db management and the fetch hook (tests/test_components.py) ---- #

def _export_both(ref, d_port, d_jax):
    from hgtpu.db.catalog import Catalog as JaxCatalog
    from hgtpu.db.catalog import export_text as jax_export
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import export_text

    export_text(Catalog(family="hla", genes={"A": carried(ref)}),
                d_port + "/hla")
    jax_export(JaxCatalog(family="hla", genes={"A": ref}), d_jax + "/hla")


def test_db_manage_equals_hgtpu(exon_gene, tmp_path):
    """tests/test_components.py:57."""
    from hgtpu.db import manage as want
    from hgtpu_torch.db import manage as got

    _, ref = exon_gene
    d, dj = str(tmp_path / "db"), str(tmp_path / "dbj")
    os.makedirs(d)
    os.makedirs(dj)
    assert not got.database_exists(d, "hla")
    _export_both(ref, d, dj)
    assert got.database_exists(d, "hla") and want.database_exists(dj, "hla")
    assert got.extract_database_if_not_exists(d, "hla") is False
    for mod, path in ((got, d), (want, dj)):
        with pytest.raises(RuntimeError):
            mod.clone_hisatgenotype_database(path)
    got.inspect(d + "/hla", str(tmp_path / "t.fa"))
    want.inspect(dj + "/hla", str(tmp_path / "h.fa"))
    text = open(tmp_path / "t.fa").read()
    assert text == open(tmp_path / "h.fa").read()
    assert ">A*BACKBONE" in text and ">%s" % ref.allele_names[0] in text


def test_db_fetch_hook_equals_hgtpu(exon_gene, tmp_path, monkeypatch):
    """tests/test_components.py:321: a directory, $HGTPU_DB_SOURCE and a
    callable as the source; none raises."""
    from hgtpu.db import manage as want
    from hgtpu_torch.db import manage as got

    _, ref = exon_gene
    mirror, mj = str(tmp_path / "mirror"), str(tmp_path / "mirrorj")
    os.makedirs(mirror)
    os.makedirs(mj)
    _export_both(ref, mirror, mj)
    for mod, src, tag in ((got, mirror, "t"), (want, mj, "h")):
        d1 = str(tmp_path / ("ix1" + tag))
        mod.clone_hisatgenotype_database(d1, source=src)
        assert mod.database_exists(d1, "hla")
        d2 = str(tmp_path / ("ix2" + tag))
        monkeypatch.setenv("HGTPU_DB_SOURCE", src)
        mod.clone_hisatgenotype_database(d2)
        assert mod.database_exists(d2, "hla")
        monkeypatch.delenv("HGTPU_DB_SOURCE")
        d3 = str(tmp_path / ("ix3" + tag))
        called = []
        mod.download_genome_and_index(d3, source=called.append)
        assert called == [d3]
        with pytest.raises(RuntimeError):
            mod.clone_hisatgenotype_database(str(tmp_path / ("ix4" + tag)))
    for name in sorted(os.listdir(str(tmp_path / "ix1t"))):
        assert open(os.path.join(tmp_path, "ix1t", name), "rb").read() == \
            open(os.path.join(tmp_path, "ix1h", name), "rb").read(), name


# ---- region typing (tests/test_components.py:169) ---- #

def test_region_typing_equals_hgtpu(tmp_path):
    from hgtpu.db import build_catalog_from_msa
    from hgtpu.db.genome import build_genotype_genome
    from hgtpu.db.genome import region_gene as jax_region_gene
    from hgtpu.pipeline import type_reads as jax_type_reads
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import TypingOptions as JaxOptions
    from hgtpu_torch.db.genome import region_gene
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions
    from tests.test_torch_production import assert_same_result

    fam = make_family(genes=("A",), n_alleles=12, length=1200, seed=55)
    cat = build_catalog_from_msa(
        "hla", {g: dict(names=s["names"], rows=s["rows"],
                        ref_allele=s["ref_allele"], exons=s["exons"])
                for g, s in fam["specs"].items()}, min_var_freq=0.0)
    g = cat.genes["A"]
    left, right = fam["loci"]["A"]
    g.chrom, g.chrom_left, g.chrom_right = "chrS", left, right
    out = str(tmp_path / "gg" / "genotype_genome")
    _, offsets = build_genotype_genome({"chrS": fam["genome"]},
                                       {"hla": cat}, out)
    base = offsets[("hla", "A")]
    region = region_gene(out, "chrS", base, base + len(g.backbone))
    want_region = jax_region_gene(out, "chrS", base, base + len(g.backbone))
    assert_same_gene(region, want_region)
    allele = g.allele_names[4]
    r1, r2, _ = simulate_reads(g, [allele], simulate_interval=5)
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    got = type_reads(region, R1, R2,
                     TypingOptions(family="genome", simulation=False),
                     device="cpu")
    assert_same_result(got, jax_type_reads(
        want_region, R1, R2, JaxOptions(family="genome", simulation=False)))
    assert got.prob[0][0] == allele
    assert region_gene(out, "chrS", 0, 2000).n_vars == 0


# ---- observability (tests/test_observability.py) ---- #

def test_trace_report_renders_as_hgtpu():
    from hgtpu.utils.trace import TRACE as JAX_TRACE
    from hgtpu_torch.utils.trace import TRACE

    outs = []
    for t in (TRACE, JAX_TRACE):
        t.reset()
        t.add("x.a", 0.5)
        t.add("x.b", 0.25, n=3)
        buf = io.StringIO()
        t.report(file=buf)
        outs.append((buf.getvalue(), t.summary()))
        t.reset()
    assert outs[0] == outs[1]
    assert "x.a" in outs[0][0] and "66.7%" in outs[0][0]


# the stages the port's TRACE records beyond hgtpu's (PERF.md section 3):
# each typing call's root, the EM's input and its iterations, the
# passes' dispatch and their CUDA graphs' captures, the host's waits on
# device fetches, verify.prep's sub-steps, and a family typing call's
# root with the router, the per-gene alignment and the NH==1 rule
PORT_ONLY_STAGES = {"call.type_reads", "em.build", "em.solve",
                    "pass.dispatch", "pass.capture", "sync.fetch",
                    "verify.prep.proposals", "verify.prep.bound",
                    "verify.prep.filter", "call.type_family",
                    "family.route", "family.align", "family.nh1"}


def test_trace_collects_typing_stages_as_hgtpu():
    """tests/test_observability.py:28: a simulation sweep records every
    stage name hgtpu records, and beyond them only the port's own."""
    from hgtpu.db import build_catalog_from_msa
    from hgtpu.pipeline import simulation_sweep as jax_sweep
    from hgtpu.utils.trace import TRACE as JAX_TRACE
    from hgtpu_torch.pipeline import simulation_sweep
    from hgtpu_torch.utils.trace import TRACE

    fam = make_family(genes=("A",), n_alleles=12, length=1200)
    cat = build_catalog_from_msa(
        "hla", {g: dict(names=s["names"], rows=s["rows"],
                        ref_allele=s["ref_allele"], exons=s["exons"],
                        primary_exon_idx=s["primary_exon_idx"])
                for g, s in fam["specs"].items()}, min_var_freq=0.0)
    ref = cat.gene("A")
    seen = []
    for t, sweep, gene, kw in ((TRACE, simulation_sweep, carried(ref),
                                dict(device="cpu")),
                               (JAX_TRACE, jax_sweep, ref, {})):
        t.reset()
        n, _ = sweep(gene, test_size=1, seed=5, simulate_interval=8, **kw)
        assert n == 1
        summ = t.summary()
        seen.append(sorted(summ))
        for stage in ("place.dispatch", "place.fetch", "type.pileup",
                      "type.read_hts", "type.em"):
            assert summ[stage]["n"] >= 1, stage
        assert t.total("place") >= summ["place.fetch"]["s"]
        t.reset()
    got, want = set(seen[0]), set(seen[1])
    assert want <= got
    assert got - want <= PORT_ONLY_STAGES
    # the host-engine sweep takes the root, the EM's stages and the fetch
    assert {"call.type_reads", "em.build", "em.solve",
            "sync.fetch"} <= got - want


def test_verbose_level_flag_as_hgtpu():
    from hgtpu.cli.main import build_parser as jax_parser
    from hgtpu_torch.cli.main import build_parser

    for argv in (["--verbose-level", "2"], [], ["--verbose"]):
        got = vars(build_parser().parse_args(argv))
        assert got == vars(jax_parser().parse_args(argv)), argv
    assert build_parser().parse_args(["--verbose-level", "2"]) \
        .verbose_level == 2
    assert build_parser().parse_args([]).verbose_level == 0


def test_port_written_bam_types_as_its_fastq(tmp_path):
    """A BAM written with the port alone (mate 2 on the reverse strand)
    through `--bamfile` gives the report of the same pairs as FASTQ."""
    from hgtpu_torch.cli.main import main
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.db.catalog import export_text
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.utils.io import write_fastq
    from tests.test_torch_cli import _report_lines

    spec = make_gene_msa(seed=31, n_alleles=12, length=1500)
    gene, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    gene = dataclasses.replace(gene, chrom="chr6", chrom_left=20000,
                               chrom_right=20000 + len(gene.backbone) - 1)
    truths = [gene.allele_names[4], gene.allele_names[7]]
    r1, r2, _ = simulate_reads(gene, truths, simulate_interval=3, seed=3,
                               perbase_errorrate=1.0)
    recs = []
    for k, (a, b) in enumerate(zip(r1, r2)):
        pos = gene.chrom_left + (k * 3) % (len(gene.backbone) - 250)
        for flag, p, seq in ((0x1 | 0x40, pos, a.seq),
                             (0x1 | 0x80 | 0x10, pos + 150, revcomp(b.seq))):
            recs.append({"name": "rd%d" % k, "flag": flag, "rname": "chr6",
                         "pos": p, "cigar": [("M", len(seq))], "seq": seq,
                         "qual": "I" * len(seq), "tags": {"NH": ("i", 1)}})
    db = str(tmp_path / "db")
    export_text(Catalog(family="hla", genes={"A": gene}), db + "/hla")
    (tmp_path / "b").mkdir()
    (tmp_path / "f").mkdir()
    bam.write_bam(str(tmp_path / "b" / "s.bam"), [("chr6", 60000)], recs)
    write_fastq([("rd%d" % k, r.seq) for k, r in enumerate(r1)],
                str(tmp_path / "f" / "s.1.fq"))
    write_fastq([("rd%d" % k, r.seq) for k, r in enumerate(r2)],
                str(tmp_path / "f" / "s.2.fq"))
    base = ["--base", "hla", "--ix-dir", db]
    assert main(base + ["--bamfile", str(tmp_path / "b" / "s.bam"),
                        "--out-dir", str(tmp_path / "ob")], device="cpu") == 0
    assert main(base + ["-1", str(tmp_path / "f" / "s.1.fq"),
                        "-2", str(tmp_path / "f" / "s.2.fq"),
                        "--out-dir", str(tmp_path / "of")], device="cpu") == 0
    name = "assembly_graph-hla.s.report"
    got = _report_lines(str(tmp_path / "ob" / name))
    assert got == _report_lines(str(tmp_path / "of" / name))
    assert any("1 ranked" in x for x in got)


def test_region_list_cli_equals_hgtpu(tmp_path):
    """tests/test_bam.py:148: `--region-list hla.A` with the simulation
    self-test, both command lines on the same placed gene's database."""
    from hgtpu.cli.main import main as jax_main
    from hgtpu.db.catalog import Catalog as JaxCatalog
    from hgtpu.db.catalog import export_text as jax_export
    from hgtpu_torch.cli.main import main
    from tests.test_torch_cli import _assert_same_reports

    spec = make_gene_msa(seed=31, n_alleles=12, length=1500)
    ref, _ = jax_build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    ref = dataclasses.replace(ref, chrom="chr6", chrom_left=20000,
                              chrom_right=20000 + len(ref.backbone) - 1)
    db = tmp_path / "db"
    db.mkdir()
    jax_export(JaxCatalog(family="hla", genes={"A": ref}), str(db / "hla"))
    argv = ["--region-list", "hla.A", "--ix-dir", str(db), "--debug",
            "basic,test_size:1,set_seed:7", "--out-dir"]
    assert jax_main(argv + [str(tmp_path / "h")]) == 0
    assert main(argv + [str(tmp_path / "t")], device="cpu") == 0
    _assert_same_reports(str(tmp_path / "h"), str(tmp_path / "t"))
