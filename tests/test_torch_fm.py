"""The port's FM index, linear aligner and linear typing equal hgtpu's.

Random genomes made from a seed go through both FMIndex builds, full and
checkpointed, one of them with n + 1 a multiple of 64 (the last rank of
the checkpointed search then reads block row nblk, which XLA clamps and
the port clamps explicitly); the queries carry left N-padding, a mid-
query N, and mutations that kill the range midway.  (lo, hi), count,
locate and pack_queries must be equal; so must LinearAligner's allele
sets and counts, type_reads_linear, and type_reads with linear_typing
(which the port no longer refuses).  The port's SA-IS/BWT/FASTX binding
must give hgtpu's results, with the native library and without it.
Exact equality everywhere.
"""
import dataclasses

import numpy as np
import pytest

from hgtpu.align.linear import LinearAligner as JaxLinear
from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.ops.fm import FMIndex as JaxFM
from hgtpu.ops.fm import pack_queries as jax_pack_queries
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.pipeline.genotype import type_reads_linear as jax_type_linear
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.align import LinearAligner
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.ops.fm import FMIndex, pack_queries
from hgtpu_torch.pipeline import type_reads, type_reads_linear
from hgtpu_torch.typer import TypingOptions
from tests.synth import make_gene_msa
from tests.torch_threads import _torch_threads  # noqa: F401


def _text(seed, n):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _queries(text, seed, n_q=60, L=30):
    """Substrings (shorter ones left-padded with N), substrings with one
    mutated base (their range dies midway), random strings, substrings
    with an N inside, and an all-N query."""
    rng = np.random.default_rng(seed)
    qs = []
    for k in range(n_q):
        ln = int(rng.integers(12, L + 1))
        p = int(rng.integers(0, len(text) - ln))
        q = text[p:p + ln]
        if k % 4 == 1:
            j = int(rng.integers(0, ln))
            q = q[:j] + "ACGT"[("ACGT".index(q[j]) + 1) % 4] + q[j + 1:]
        elif k % 4 == 2:
            q = "".join("ACGT"[i] for i in rng.integers(0, 4, ln))
        elif k % 4 == 3:
            j = int(rng.integers(1, ln - 1))
            q = q[:j] + "N" + q[j + 1:]
        qs.append(q)
    qs.append("N" * 10)
    return qs


# 6,399 + 1 = 100 x 64 rows: the clamp trap; 20,000 + 1 is not
@pytest.mark.parametrize("n", [6399, 20000, 127])
@pytest.mark.parametrize("checkpoint", [False, True])
def test_search_batch_equals_hgtpu(n, checkpoint):
    text = _text(n, n)
    from hgtpu_torch.utils.dna import encode_seq

    codes = encode_seq(text)
    want_fm = JaxFM(codes, checkpoint=checkpoint)
    got_fm = FMIndex(codes, checkpoint=checkpoint, device="cpu")
    assert got_fm.n + 1 == len(got_fm.sa)
    if checkpoint:
        assert got_fm._bwt_dev.shape[0] * 64 >= n + 1
        assert np.array_equal(got_fm._ckpt_dev.numpy(),
                              np.asarray(want_fm._ckpt_dev))
        assert np.array_equal(got_fm._bwt_dev.numpy(),
                              np.asarray(want_fm._bwt_dev))
    else:
        assert np.array_equal(got_fm._occ_dev.numpy(),
                              np.asarray(want_fm._occ_dev))
    assert np.array_equal(got_fm.sa, want_fm.sa)
    assert np.array_equal(got_fm.C, want_fm.C)
    qs = _queries(text, n + 1)
    q = pack_queries(qs, 30)
    assert np.array_equal(q, jax_pack_queries(qs, 30))
    lo, hi = got_fm.search_batch(q)
    w_lo, w_hi = (np.asarray(x) for x in want_fm.search_batch(q))
    assert lo.dtype == hi.dtype == np.int32 and lo.shape == (len(qs),)
    assert np.array_equal(lo, w_lo) and np.array_equal(hi, w_hi)
    # found, died midway and all-pad queries are all present (a mid-
    # query N keeps the range: the query reads as its two halves joined)
    assert (hi > lo).sum() >= len(qs) // 4 and (hi == 0).any()
    assert hi[-1] - lo[-1] == n + 1
    for i in range(0, len(qs) - 1, 3):
        assert got_fm.count(q[i]) == want_fm.count(q[i])
        if i % 4 == 0:                 # an unmutated substring
            assert got_fm.count(q[i]) >= 1
        assert np.array_equal(got_fm.locate(int(lo[i]), int(hi[i]), 5),
                              want_fm.locate(int(w_lo[i]), int(w_hi[i]), 5))
    # an empty batch
    lo0, hi0 = got_fm.search_batch(np.zeros((0, 30), np.int8))
    assert lo0.shape == hi0.shape == (0,)


def test_native_binding_equals_hgtpu(monkeypatch):
    """build_suffix_array, bwt_from_sa and scan_fastx of both packages,
    with the native library and with the numpy fallback."""
    import hgtpu.native as jn
    import hgtpu_torch.native as tn
    from hgtpu_torch.utils.dna import encode_seq

    codes = encode_seq(_text(5, 3000) + "NNAC")
    sa = tn.build_suffix_array(codes)
    assert np.array_equal(sa, jn.build_suffix_array(codes))
    bwt = tn.bwt_from_sa(codes, sa)
    assert np.array_equal(bwt, jn.bwt_from_sa(codes, sa))
    assert tn.have_native() == jn.have_native()
    text = b"".join(b"@r%d\nACGT%s\n+\n%s\n" % (i, b"A" * i, b"I" * (4 + i))
                    for i in range(20))
    assert tn.scan_fastx(text) == jn.scan_fastx(text)
    monkeypatch.setattr(tn, "_LIB", False)
    monkeypatch.setattr(jn, "_LIB", False)
    assert not tn.have_native()
    sa_np = tn.build_suffix_array(codes)
    assert np.array_equal(sa_np, jn.build_suffix_array(codes))
    assert np.array_equal(tn.bwt_from_sa(codes, sa_np),
                          jn.bwt_from_sa(codes, sa_np))
    assert tn.scan_fastx(text) is None


@pytest.fixture(scope="module")
def genes():
    spec = make_gene_msa(seed=11, n_alleles=20, length=1500)
    args = ("A", spec["names"], spec["rows"], spec["ref_allele"])
    want, _ = jax_build_gene_ref(*args, min_var_freq=0.0)
    got, _ = build_gene_ref(*args, min_var_freq=0.0)
    return want, got


@pytest.fixture(scope="module")
def reads(genes):
    want, _ = genes
    allele = want.allele_names[8]
    out = {}
    for err in (0.0, 5.0):
        r1, r2, _ = simulate_reads(want, [allele], simulate_interval=9,
                                   perbase_errorrate=err, seed=7)
        out[err] = ([(r.name, r.seq) for r in r1],
                    [(r.name, r.seq) for r in r2])
    return out


@pytest.mark.parametrize("max_mm", [None, 0, 3])
def test_linear_aligner_equals_hgtpu(genes, reads, max_mm):
    want, got = genes
    ja, ta = JaxLinear(want), LinearAligner(got, device="cpu")
    assert np.array_equal(ta.codes, ja.codes)
    assert np.array_equal(ta.starts, ja.starts)
    seqs = [s for r in reads[5.0] for _, s in r]
    sets = ta.allele_sets(seqs, max_mm=max_mm)
    assert sets == ja.allele_sets(seqs, max_mm=max_mm)
    if max_mm is None:     # the default budget finds most errored reads
        assert sum(bool(s) for s in sets) > 0.5 * len(seqs)
    assert ta.type_linear(seqs, max_mm=max_mm) == \
        ja.type_linear(seqs, max_mm=max_mm)
    assert ta.allele_sets([]) == []


@pytest.mark.parametrize("err", [0.0, 5.0])
@pytest.mark.parametrize("num_mismatch", [0, 2])
def test_type_reads_linear_equals_hgtpu(genes, reads, err, num_mismatch):
    want_gene, got_gene = genes
    r1, r2 = reads[err]
    kw = dict(linear_typing=True, num_mismatch=num_mismatch)
    want = jax_type_linear(want_gene, r1, r2, JaxOptions(**kw))
    got = type_reads_linear(got_gene, r1, r2, TypingOptions(**kw),
                            device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert list(got.cmpt.items()) == list(want.cmpt.items())
    if err == 0.0:
        assert got.prob[0][0] == want_gene.allele_names[8]
    # type_reads routes linear_typing as hgtpu does, single-end too
    routed = type_reads(got_gene, r1, None, TypingOptions(**kw),
                        device="cpu")
    assert dataclasses.asdict(routed) == dataclasses.asdict(
        jax_type_reads(want_gene, r1, None, JaxOptions(**kw)))
