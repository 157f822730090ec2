"""The port's production entry and device EM on a mesh of several
shards equal hgtpu's on the same mesh (the shared set-up is
tests/test_torch_mesh.py's).

  count_classes    with a class cap of 8, every shard's rows come through
                   the overflow refetch of the full-resolution leaves,
                   sliced by shard: equal to hgtpu's at 2 and 8 shards.
  type_reads_device  over make_mesh(n, "cpu"): equal field for field to
                   the port's one-shard run and to hgtpu's run over a
                   mesh of as many devices (the class order depends on
                   the shard count; tests/test_torch_production.py's
                   contract), paired at 2 and 8 shards, single-end at 2.
  call_pairs, __call__, call_allele  equal hgtpu's at the same mesh:
                   totals, n_used and punt exact, prob within 2e-4 with
                   the same top allele (as tests/test_torch_device_em.py);
                   against the port's one-shard run, totals exact and prob
                   within 1e-5: float32 SQUAREM with the shards' sums in
                   another order, measured up to 4.6e-6 on this case at
                   the same iteration count.
"""
import dataclasses

import numpy as np
import pytest

from hgtpu.parallel import sharded as jax_sharded
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.parallel.production import \
    type_reads_device as jax_type_reads_device
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.parallel.e2e import ShardedTyper
from hgtpu_torch.parallel.production import type_reads_device
from hgtpu_torch.parallel.sharded import make_mesh
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.test_torch_e2e_count import assert_same_dict, run
from tests.test_torch_e2e_passes import indel_ref, truths  # noqa: F401
from tests.test_torch_mesh import reads, typers  # noqa: F401
from tests.test_torch_production import assert_same_result
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("n", [2, 8])
def test_count_classes_overflow_on_mesh(typers, reads, monkeypatch, n):
    """A cap of 8 classes: every shard's rows come through the refetch of
    the full-resolution leaves, sliced by shard."""
    jt, _tt = typers[(n, 8)]
    want = run(jt, reads, True, "tiered", monkeypatch)
    got = typers.port(reads, monkeypatch, n, "tiered", True, cap=8)
    assert_same_dict(got, want)
    assert sum(len(rows) for rows, _w, _t in got["levels"].values()) > 8


@pytest.mark.parametrize("n,paired", [(2, True), (8, True), (2, False)])
def test_type_reads_device_on_mesh(indel_ref, n, paired):  # noqa: F811
    r1, r2, _ = simulate_reads(indel_ref, truths(indel_ref),
                               simulate_interval=3, read_len=100,
                               frag_len=250, seed=11, perbase_errorrate=5.0)
    if paired:
        R1 = [(r.name, r.seq) for r in r1]
        R2 = [(r.name, r.seq) for r in r2]
    else:
        R1 = [("u%d|%s" % (i, r.name), r.seq)
              for i, r in enumerate(list(r1) + list(r2))]
        R2 = None
    kw = dict(simulation=True, device_typing="on",
              allow_discordant=not paired)
    gene = carried(indel_ref)
    got = type_reads_device(gene, R1, R2, TypingOptions(**kw),
                            mesh=make_mesh(n, "cpu"))
    one = type_reads_device(gene, R1, R2, TypingOptions(**kw), device="cpu")
    want = jax_type_reads_device(indel_ref, R1, R2, JaxOptions(**kw),
                                 mesh=jax_sharded.make_mesh(n))
    assert_same_result(got, one)
    assert_same_result(got, want)


_EM = {}


def em_typers(staged, n):
    """The staged (family "hla", narrow exons) and unstaged (family
    "cyp") indel gene of tests/test_torch_device_em.py on n shards."""
    if (staged, n) not in _EM:
        spec = make_gene_msa(seed=3, n_alleles=40)
        from hgtpu.db import build_gene_ref
        ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                                spec["ref_allele"], min_var_freq=8.0)
        if staged:
            ref = dataclasses.replace(ref, exons=[(100, 250), (1000, 1100)],
                                      primary_exons=[(100, 250)])
        family = "hla" if staged else "cyp"
        jt = JaxTyper(ref, jax_sharded.make_mesh(n), em_iters=100,
                      family=family)
        tt = ShardedTyper(carried(ref), em_iters=100, family=family,
                          mesh=make_mesh(n, "cpu"))
        r1, r2, _ = simulate_reads(ref, truths(ref), simulate_interval=4,
                                   read_len=100, frag_len=250, seed=11,
                                   perbase_errorrate=1.0)
        codes = tuple(tt.encode([r.seq for r in r]) for r in (r1, r2))
        _EM[(staged, n)] = (jt, tt, codes)
    return _EM[(staged, n)]


def _same_typing(got, want):
    prob_g, tot_g, used_g, punt_g = got
    prob_w, tot_w, used_w, punt_w = (np.asarray(x) for x in want)
    assert np.array_equal(tot_g, tot_w)
    assert used_g == float(used_w)
    assert np.array_equal(punt_g, punt_w)
    np.testing.assert_allclose(prob_g, prob_w, rtol=0, atol=2e-4)
    assert int(np.argmax(prob_g)) == int(np.argmax(prob_w))


@pytest.mark.parametrize("staged", [False, True])
def test_device_em_on_mesh(staged):
    one = em_typers(staged, 1)[1]
    c1, c2 = em_typers(staged, 1)[2]
    base_pairs = one.call_pairs(c1, c2)
    base_single = one(c1)
    for n in (2, 8):
        jt, tt, _ = em_typers(staged, n)
        got = tt.call_pairs(c1, c2)
        _same_typing(got, jt.call_pairs(c1, c2))
        np.testing.assert_allclose(got[0], base_pairs[0], rtol=0, atol=1e-5)
        assert np.array_equal(got[1], base_pairs[1])
        single = tt(c1)
        _same_typing(single, jt(c1))
        np.testing.assert_allclose(single[0], base_single[0], rtol=0,
                                   atol=1e-5)
        name, p, totals, n_used = tt.call_allele(c1)
        j_name, j_p, j_totals, j_used = jt.call_allele(c1)
        assert name == j_name and abs(p - j_p) <= 2e-4
        assert np.array_equal(totals, np.asarray(j_totals))
        assert n_used == j_used
