"""The port's pure-device typing programs and entry points equal
hgtpu's.

  em_solve_dense   against hgtpu's jitted _em_dense on tests/test_em.py's
                   cases.  Tolerance atol 1e-5: both run SQUAREM in
                   float32, with sums taken in another order.
  ShardedTyper     __call__, call_pairs, call_allele and _debug on the
                   indel gene (tests/test_torch_e2e_passes.py's), against
                   hgtpu's on a 1-device mesh, em_iters=100, with and
                   without the exon staging (both _solve branches).
                   Totals, n_used, punt and counts exact (0/1 weights,
                   exact in float32); prob within 2e-4 with the same top
                   allele, since the 1e-4 L1 stop may end one iteration
                   apart.
  placement        place_batch and place_with_orientation exact.
  entry            entry() returns hgtpu's entry() output;
                   dryrun_multichip(1) and (2) call the truth on the
                   CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hgtpu.db import build_gene_ref
from hgtpu.ops.placement import (backbone_pwm as jax_pwm,
                                 place_with_orientation as jax_pwo)
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.parallel.sharded import make_mesh
from hgtpu.sim import simulate_reads
from hgtpu.typer.em import em_solve_dense as jax_em
from hgtpu_torch.entry import dryrun_multichip, entry
from hgtpu_torch.ops.placement import place_with_orientation
from hgtpu_torch.parallel.e2e import ShardedTyper
from hgtpu_torch.typer.em import em_solve_dense
from tests.synth import make_gene_msa
from tests.test_em import _random_classes
from tests.test_torch_db import carried
from tests.test_torch_e2e_passes import truths
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("seed,with_len", [(5, False), (7, True),
                                           (11, False), (13, True)])
def test_em_solve_dense_equals_hgtpu(seed, with_len):
    rng = np.random.default_rng(seed)
    M, counts, names, _cmpt = _random_classes(rng)
    lengths = (rng.integers(800, 1200, len(names)).astype(np.float64)
               if with_len else None)
    want = jax_em(M, counts, lengths)
    got = em_solve_dense(M, counts, lengths, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want))


_TYPERS = {}


def typers(staged):
    """(hgtpu's typer, the port's) on the indel gene: staged (family
    "hla") runs the exon and the full EM levels, unstaged (family "cyp")
    one level.  The staged gene's exons are narrow, so alleles share
    exonic variant sets, the exon level groups them and the full level
    expands the winning groups."""
    if staged not in _TYPERS:
        spec = make_gene_msa(seed=3, n_alleles=40)
        ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                                spec["ref_allele"], min_var_freq=8.0)
        if staged:
            ref = dataclasses.replace(ref, exons=[(100, 250), (1000, 1100)],
                                      primary_exons=[(100, 250)])
        family = "hla" if staged else "cyp"
        jt = JaxTyper(ref, make_mesh(1), em_iters=100, family=family)
        tt = ShardedTyper(carried(ref), "cpu", em_iters=100, family=family)
        assert jt._staged == tt._staged == staged
        r1, r2, _ = simulate_reads(ref, truths(ref), simulate_interval=4,
                                   read_len=100, frag_len=250, seed=11,
                                   perbase_errorrate=1.0)
        codes = tuple(tt.encode([r.seq for r in r]) for r in (r1, r2))
        _TYPERS[staged] = (ref, jt, tt, codes)
    return _TYPERS[staged]


def _same_typing(got, want):
    prob_g, tot_g, used_g, punt_g = got
    prob_w, tot_w, used_w, punt_w = (np.asarray(x) for x in want)
    assert np.array_equal(tot_g, tot_w)
    assert used_g == float(used_w)
    assert np.array_equal(punt_g, punt_w)
    np.testing.assert_allclose(prob_g, prob_w, rtol=0, atol=2e-4)
    assert int(np.argmax(prob_g)) == int(np.argmax(prob_w))
    assert used_g > 0 and punt_g.any() and not punt_g.all()


@pytest.mark.parametrize("staged", [False, True])
def test_call_pairs_equals_hgtpu(staged):
    ref, jt, tt, (c1, c2) = typers(staged)
    expanded = []
    real = tt._exon_winners

    def spy(exon_prob):
        sel, prob_sum = real(exon_prob)
        expanded.append(int(sel.sum()))
        return sel, prob_sum

    tt._exon_winners = spy
    try:
        got = tt.call_pairs(c1, c2)
    finally:
        del tt._exon_winners
    _same_typing(got, jt.call_pairs(c1, c2))
    assert ref.allele_names[int(np.argmax(got[0]))] in truths(ref)
    # the staged run took the full level on expanded groups; the
    # unstaged one has no exon level
    assert (expanded[0] > 0) if staged else expanded == []


@pytest.mark.parametrize("staged", [False, True])
def test_call_single_and_allele_equal_hgtpu(staged):
    ref, jt, tt, (c1, _c2) = typers(staged)
    _same_typing(tt(c1), jt(c1))
    name, p, totals, n_used = tt.call_allele(c1)
    j_name, j_p, j_totals, j_used = jt.call_allele(c1)
    assert name == j_name and abs(p - j_p) <= 2e-4
    assert np.array_equal(totals, np.asarray(j_totals)) and n_used == j_used
    # count_em_global over the whole batch is the same program
    g = tt.count_em_global(tt._pad(c1))
    assert np.array_equal(g[1], totals) and g[2] == n_used


def test_debug_equals_hgtpu():
    _ref, jt, tt, (c1, _c2) = typers(False)
    pad = tt._pad(c1)
    got = tt._debug(*tt._tables, tt._dev(pad))
    want = jt._debug(*jt._tables, np.asarray(pad))
    names = ("cnt", "passed", "use_r", "lefts", "rights", "needs_host")
    for name, g, w in zip(names, got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w.astype(g.dtype)), \
            name


def test_place_with_orientation_equals_hgtpu():
    ref, _jt, tt, (c1, _c2) = typers(False)
    fwd = c1[:300]
    rc = np.where(fwd[:, ::-1] < 4, 3 - fwd[:, ::-1], 4).astype(np.int8)
    want = jax_pwo(jax_pwm(ref), fwd, rc, top_k=4)
    got = place_with_orientation(jax_pwm(ref), fwd, rc, top_k=4,
                                 device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_entry_equals_hgtpu():
    jfn, jargs = graft.entry()
    fn, args = entry("cpu")
    for a, ja in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(ja))
    got, want = fn(*args), jfn(*jargs)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_one_device():
    dryrun_multichip(1, device="cpu")
    # more devices are a mesh of shards now (tests/test_torch_mesh*.py)
    dryrun_multichip(2, device="cpu")
