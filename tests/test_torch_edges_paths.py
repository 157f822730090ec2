"""Edge genes typed by the port and by hgtpu: the haplotype-window gene,
grafted partial alleles and errored reads.

As tests/test_torch_edges_fuzz.py: hgtpu_torch.devel.edges' cases, the
port's production result equal to hgtpu's at hgtpu's mesh size, field
for field, and to the port's host engine under the host contract.

  two-indels  tests/test_haplotype_paths.py's gene (a deletion in one
              allele, an insertion in another, never together) with
              40-bp pairs of both alleles and one pair whose first mate
              uses both indels; every pair punts to the production
              rescue.  That pair breaks the host contract in hgtpu
              itself: its production path counts it as {X*A}, its host
              engine spells the mate with two novel 1-bp deletions and
              counts {X*A, X*C}.  The port repeats both paths exactly
              (a fault of the reference, ROADMAP section 3); without the
              pair the contract holds.
  partial     tests/test_partial.py's grafted alleles at 900 bp: the
              partial truth is called.
  errors      tests/test_error_correction.py's errored reads (2 % per
              base) at 900 bp: the truth is called.
"""
import pytest

from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.devel import edges
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.typer.engine import TypingOptions
from tests.test_torch_db import assert_same_gene, carried
from tests.test_torch_edges_fuzz import check_case, hgtpu_gene, run_case
from tests.test_torch_production import (assert_host_contract,
                                         assert_same_result, three_ways)
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["two_indels", "partial", "errors"])
def test_edge_gene_builds_equal_hgtpu(name):
    got = edges.build(edges.specs()[name])
    assert_same_gene(got, hgtpu_gene(name))
    if name == "partial":
        partials = {n for n in got.allele_names if n.startswith("A*90:")}
        assert len(partials) == 3 and partials <= got.partial
        for allele in partials:
            for vi in got.allele_var_indices(allele):
                pos = int(got.var_pos[vi])
                assert any(l <= pos <= r for l, r in got.exons), allele


def test_two_indel_gene_equals_hgtpu_on_both_paths(monkeypatch):
    from hgtpu_torch.parallel import production

    rescued = []
    real = production._align_punts

    def spy(gene, opts, reads_1, reads_2, idx, *a, **k):
        rescued.extend(int(i) for i in idx)
        return real(gene, opts, reads_1, reads_2, idx, *a, **k)

    monkeypatch.setattr(production, "_align_punts", spy)
    dev, want, host, truths, (R1, R2) = run_case("two-indels")
    assert R1[-1][0].startswith("999|") and len(R1) == len(R2)
    assert len(R1) - 1 in rescued          # the production rescue's read
    assert_same_result(dev, want)
    ref = hgtpu_gene("two_indels")
    assert_same_result(host, jax_type_reads(
        ref, R1, R2, JaxOptions(simulation=True, device_typing="off")))
    # hgtpu's own paths part on the recombinant pair alone
    assert {k: host.cmpt.get(k, 0) - dev.cmpt.get(k, 0)
            for k in set(host.cmpt) | set(dev.cmpt)
            if host.cmpt.get(k, 0) != dev.cmpt.get(k, 0)} == \
        {"X*A": -1, "X*A-X*C": 1}
    assert (dev.num_reads, dev.num_pairs) == (host.num_reads,
                                              host.num_pairs)
    assert dev.novel_vars == {} and sorted(host.novel_vars.values()) == \
        [("deletion", 20, "1"), ("deletion", 21, "1")]
    assert {a for a, _ in dev.prob} == set(truths)
    # without it, the host contract holds
    dev, want, host = three_ways(ref, R1[:-1], R2[:-1], simulation=True)
    assert_same_result(dev, want)
    assert_host_contract(dev, host, [a for a, _ in host.prob[:2]])
    assert {a for a, _ in dev.prob} == set(truths)


@pytest.mark.parametrize("name", ["partial", "errors"])
def test_edge_gene_typing_equals_hgtpu(name):
    dev, truths, _ = check_case(name)
    assert dev.prob[0][0] == truths[0]
    assert dev.prob[0][1] > 0.99


def test_partial_gene_host_engine_equals_hgtpu():
    """test_partial.py:38 types on the host engine (the default off a
    card): the port's host result equals hgtpu's field for field."""
    _, gene_name, reads, _ = next(c for c in edges.CASES
                                  if c[0] == "partial")
    ref = hgtpu_gene(gene_name)
    from hgtpu.sim import simulate_reads

    R1, R2 = edges.case_reads(simulate_reads, ref, reads)
    got = type_reads(carried(ref), R1, R2, TypingOptions(simulation=True),
                     device="cpu")
    assert_same_result(got, jax_type_reads(ref, R1, R2,
                                           JaxOptions(simulation=True)))
    assert sorted(ref.partial)[0] in [a for a, _ in got.prob[:2]]
