"""The port's count_classes returns hgtpu's dict.

Both two-pass programs (place/spell, host pileup merge, count) run on the
indel gene, paired and single-end, at 0 % and 5 % per-base error, fused
and tiered (HGTPU_FUSED_SPELL=off, as tests/test_production.py flips it),
with the default class cap and with a cap of 8 that forces the overflow
refetch through the full-resolution leaves.  Every entry must be equal:
the per-level class rows, weights and totals, the first-seen order, the
pileup, the punt and exclusion masks, the read and pair counts and the
winner words.  Fused must also equal tiered within the port.  A dense
catalog read at 901 bp holds compat_mxu's counts past bf16's 256.
"""
import random

import numpy as np
import pytest

from hgtpu.db import build_gene_ref
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.parallel.sharded import make_mesh
from hgtpu.sim import simulate_reads
from hgtpu_torch.parallel import e2e
from hgtpu_torch.parallel.e2e import ShardedTyper
from tests.test_torch_db import carried
from tests.test_torch_e2e_passes import ERRS, indel_ref, truths  # noqa: F401
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def typers(indel_ref):  # noqa: F811
    return {cap: (JaxTyper(indel_ref, make_mesh(1), class_cap=cap),
                  ShardedTyper(carried(indel_ref), "cpu", class_cap=cap))
            for cap in (8, 2048)}


@pytest.fixture(scope="module")
def reads(indel_ref):  # noqa: F811
    out = {}
    for err in ERRS:
        r1, r2, _ = simulate_reads(indel_ref, truths(indel_ref),
                                   simulate_interval=4, read_len=100,
                                   frag_len=250, seed=13,
                                   perbase_errorrate=err)
        out[err] = ([r.seq for r in r1], [r.seq for r in r2])
    return out


def run(st, seqs, paired, spell, monkeypatch):
    monkeypatch.setenv("HGTPU_FUSED_SPELL",
                       "off" if spell == "tiered" else "auto")
    c1 = st.encode(seqs[0])
    c2 = st.encode(seqs[1]) if paired else None
    return st.count_classes(c1, c2)


def assert_same_dict(got, want):
    assert set(got) == set(want)
    assert list(got["levels"]) == list(want["levels"])
    for name, (rows, w, tot) in want["levels"].items():
        g_rows, g_w, g_tot = got["levels"][name]
        assert g_rows.dtype == rows.dtype == np.uint32, name
        assert np.array_equal(g_rows, rows), name
        assert np.array_equal(g_w, w), name
        assert np.array_equal(g_tot, tot), name
        assert np.array_equal(got["order"][name], want["order"][name])
    for k in ("pileup", "punt", "excl"):
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got["n_reads"] == want["n_reads"]
    assert got["n_pairs"] == want["n_pairs"]
    assert len(got["winner"]) == len(want["winner"])
    for gw, ww in zip(got["winner"], want["winner"]):
        for k in ww:
            assert np.array_equal(gw[k], ww[k]), k


CASES = [(2048, "fused", True), (2048, "tiered", True),
         (2048, "fused", False), (8, "fused", True), (8, "tiered", False)]


@pytest.mark.parametrize("err", ERRS)
@pytest.mark.parametrize("cap,spell,paired", CASES)
def test_count_classes_equals_hgtpu(typers, reads, monkeypatch, cap, spell,
                                    paired, err):
    jt, tt = typers[cap]
    want = run(jt, reads[err], paired, spell, monkeypatch)
    got = run(tt, reads[err], paired, spell, monkeypatch)
    assert_same_dict(got, want)
    if cap == 8:
        # more unique classes than the cap: the rows came through the
        # overflow refetch
        assert sum(len(rows) for rows, _w, _t in
                   got["levels"].values()) > 8
    assert got["n_pairs"] > 0


@pytest.mark.parametrize("paired", [True, False])
def test_fused_equals_tiered(typers, reads, monkeypatch, paired):
    """The analog of tests/test_production.py's fused-vs-tiered test.
    The tiered pass concatenates its rows tier by tier, so first-seen
    row order differs from the fused pass: compare the aggregated
    class -> weight maps, as that test does."""
    _jt, tt = typers[2048]
    fused = run(tt, reads[5.0], paired, "fused", monkeypatch)
    tiered = run(tt, reads[5.0], paired, "tiered", monkeypatch)
    for k in ("pileup", "punt", "excl"):
        assert np.array_equal(fused[k], tiered[k]), k
    assert fused["n_reads"] == tiered["n_reads"]
    assert fused["n_pairs"] == tiered["n_pairs"]

    def norm(rows, w):
        agg = {}
        for r, x in zip(rows, w):
            agg[tuple(r)] = agg.get(tuple(r), 0) + int(x)
        return agg

    assert list(fused["levels"]) == list(tiered["levels"])
    for name, (t_rows, t_w, t_tot) in tiered["levels"].items():
        f_rows, f_w, f_tot = fused["levels"][name]
        assert np.array_equal(f_tot, t_tot), name
        assert norm(f_rows, f_w) == norm(t_rows, t_w), name


def _every_other_base_gene():
    """One catalog SNP at every even backbone position, carried by A*02
    (all of them), A*03 and A*04 (every other one each): a 901 bp read
    of A*02 meets ~450 of them, past bf16's 256."""
    rng = random.Random(5)
    bases = "ACGT"
    anc = "".join(rng.choice(bases) for _ in range(2400))
    rows = [anc] + ["".join(bases[(bases.index(c) + 1) % 4] if i % q == r
                            else c for i, c in enumerate(anc))
                    for q, r in ((2, 0), (4, 0), (4, 2))]
    names = ["A*%02d:01" % (k + 1) for k in range(4)]
    ref, _ = build_gene_ref("A", names, rows, names[0], min_var_freq=0.0)
    return ref


def test_count_classes_past_bf16_equals_hgtpu(monkeypatch):
    """compat_mxu's counts run to ~350 here, many of them odd: with a
    float32 output the dict equals hgtpu's (whose product has a float32
    output); a bf16 output would round them."""
    gene = _every_other_base_gene()
    r1, r2, _ = simulate_reads(gene, [gene.allele_names[1],
                                      gene.allele_names[2]],
                               simulate_interval=20, read_len=901,
                               frag_len=1000, seed=13)
    seqs = ([r.seq for r in r1], [r.seq for r in r2])
    want = run(JaxTyper(gene, make_mesh(1), read_len=901), seqs, True,
               "fused", monkeypatch)
    counts = []
    real = e2e.count_product

    def spy(x, links):
        out = real(x, links)
        counts.append(out)
        return out

    monkeypatch.setattr(e2e, "count_product", spy)
    got = run(ShardedTyper(carried(gene), "cpu", read_len=901), seqs, True,
              "fused", monkeypatch)
    assert_same_dict(got, want)
    odd = [int(((c > 256) & (c % 2 == 1)).sum()) for c in counts]
    assert counts and min(odd) > 0
