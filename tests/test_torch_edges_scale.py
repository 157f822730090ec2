"""tests/test_hla_scale.py's typing checks at the 3,600-allele panel,
held against hgtpu.

  truth rank, errors   the host engine (the default off a card in both
                   packages) on test_hla_scale.py's truths, seeds and
                   intervals: the port's result equals hgtpu's field for
                   field, cmpt order included; the truth first at 99.99 %
                   (99 % with 0.2 % errors).
  sharded e2e      ShardedTyper(em_iters=300, max_ht_vars=32,
                   max_indel_cand=8).call_pairs over 8 shards, hgtpu's on
                   its 8-device mesh: totals, n_used and punt exact, prob
                   within 2e-4 with the same top allele
                   (tests/test_torch_mesh_typing.py's tolerance: float32
                   SQUAREM with the shards' sums in another order).
"""
import numpy as np
import pytest

from hgtpu.db import build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_hla_scale_msa
from tests.test_torch_db import carried
from tests.test_torch_production import assert_same_result
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def hla_scale_ref():
    spec = make_hla_scale_msa()
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return ref


@pytest.mark.parametrize("idx,seed,err", [(123, 1, 0.0), (2047, 2, 0.0),
                                          (777, 4, 0.2)])
def test_truth_at_scale_equals_hgtpu(hla_scale_ref, idx, seed, err):
    ref = hla_scale_ref
    allele = ref.allele_names[idx]
    r1, r2, _ = simulate_reads(ref, [allele], simulate_interval=10,
                               seed=seed, perbase_errorrate=err)
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    got = type_reads(carried(ref), R1, R2, TypingOptions(simulation=True),
                     device="cpu")
    assert_same_result(got, jax_type_reads(ref, R1, R2,
                                           JaxOptions(simulation=True)))
    assert got.prob[0][0] == allele and got.counts[0][0] == allele
    assert got.prob[0][1] >= (0.99 if err else 0.9999)


def test_sharded_e2e_at_scale_equals_hgtpu(hla_scale_ref):
    from hgtpu.db.catalog import VT_SINGLE
    from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
    from hgtpu.parallel.sharded import make_mesh as jax_mesh
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.sharded import make_mesh

    ref = hla_scale_ref
    snp = ref.var_type == VT_SINGLE
    truth = next(n for i, n in enumerate(ref.allele_names)
                 if ref.links[~snp, i].any() and ref.links[snp, i].any())
    kw = dict(em_iters=300, max_ht_vars=32, max_indel_cand=8)
    want_t = JaxTyper(ref, jax_mesh(8), **kw)
    got_t = ShardedTyper(carried(ref), mesh=make_mesh(8, "cpu"), **kw)
    r1, r2, _ = simulate_reads(ref, [truth], simulate_interval=8, seed=3)
    c1 = got_t.encode([r.seq for r in r1])
    c2 = got_t.encode([r.seq for r in r2])
    assert np.array_equal(c1, want_t.encode([r.seq for r in r1]))
    prob, totals, n_used, punt = got_t.call_pairs(c1, c2)
    w_prob, w_totals, w_used, w_punt = (np.asarray(x) for x in
                                        want_t.call_pairs(c1, c2))
    assert np.array_equal(totals, w_totals) and n_used == float(w_used)
    assert np.array_equal(punt, w_punt)
    np.testing.assert_allclose(prob, w_prob, rtol=0, atol=2e-4)
    top = int(np.argmax(prob))
    assert top == int(np.argmax(w_prob))
    assert ref.allele_names[top] == truth and prob[top] > 0.999
    assert punt.sum() <= 0.35 * len(r1) and n_used > 0.6 * len(r1)
