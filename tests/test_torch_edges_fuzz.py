"""Edge genes typed by the port and by hgtpu: tests/test_fuzz.py's.

hgtpu_torch.devel.edges holds each gene as data and each case's reads
and options.  hgtpu builds the gene, simulates the reads and types them
with device_typing="on" over its default mesh (8 CPU devices under
tests/conftest.py); the port types the gene carried across over a mesh
of as many CPU shards (tests/test_torch_production.py's three_ways) and
on its host engine.  The port's production result equals hgtpu's field
for field, cmpt order included (assert_same_result), and its host result
under tests/test_production.py's contract (assert_host_contract: prob
within 1e-9 with the same ranking, the rest exact).  Every gene's build
equals hgtpu's and keeps the invariants hgtpu's tests pin.

Here: the four random-MSA genes of test_fuzz.py:31 (seed 99, 3-12
alleles, 400-900 bp; fuzz1 is in test_torch_production.py), the
leading/trailing-gap gene of :55 at 600 bp (its ACGT repeat places no
read uniquely, so it types nothing in either package) and the same shape
on a random backbone, and the variant-free gene of :46.
"""
import functools

import pytest

from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.db.catalog import GeneRef as JaxGeneRef
from hgtpu.sim import simulate_reads as jax_simulate_reads
from hgtpu_torch.devel import edges
from tests.test_torch_db import assert_same_gene
from tests.test_torch_production import (assert_host_contract,
                                         assert_same_result, three_ways)
from tests.torch_threads import _torch_threads  # noqa: F401


@functools.lru_cache(maxsize=None)
def hgtpu_gene(name):
    """hgtpu's gene of one edges spec, built once per process."""
    spec = edges.specs()[name]
    if "fields" in spec:
        return JaxGeneRef(**spec["fields"])
    return jax_build_gene_ref(*spec["args"], **spec["kw"])[0]


def case_of(name):
    return next(c for c in edges.CASES if c[0] == name)


def run_case(name):
    """(port production at hgtpu's mesh size, hgtpu production, port
    host, truths, reads) of one edges case."""
    _, gene_name, reads, opts = case_of(name)
    gene = hgtpu_gene(gene_name)
    R1, R2 = edges.case_reads(jax_simulate_reads, gene, reads)
    dev, want, host = three_ways(edges.panel(gene, reads), R1, R2,
                                 simulation=True, **opts)
    return dev, want, host, edges.truths(gene, reads), (R1, R2)


def check_case(name):
    """The case's three results: port production == hgtpu's exactly,
    and the host contract against the port's host engine."""
    dev, want, host, truths, reads = run_case(name)
    assert_same_result(dev, want)
    assert_host_contract(dev, host,
                         [a for a, _ in host.prob[:max(2, len(truths))]])
    return dev, truths, reads


@pytest.mark.parametrize("name", ["fuzz0", "fuzz1", "fuzz2", "fuzz3", "gaps",
                                  "gaps_random", "identical"])
def test_edge_gene_builds_equal_hgtpu(name):
    spec = edges.specs()[name]
    got = edges.build(spec)
    want = hgtpu_gene(name)
    assert_same_gene(got, want)
    names, rows = spec["args"][1:3]
    for allele in got.allele_names:
        assert got.allele_seq(allele) == \
            rows[names.index(allele)].replace(".", ""), allele
    if name == "identical":
        assert got.n_vars == 0 and len(got.haplotypes) == 0


def test_random_msa_is_test_fuzzs():
    import random

    from tests.test_fuzz import _random_msa

    a, b = random.Random(99), random.Random(99)
    for _ in range(6):
        n, L = a.randint(3, 12), a.randint(400, 900)
        assert (n, L) == (b.randint(3, 12), b.randint(400, 900))
        assert edges.random_msa(a, n, L) == _random_msa(b, n, L)


@pytest.mark.parametrize("name", ["fuzz0", "fuzz2", "fuzz3", "gaps-random"])
def test_fuzz_gene_typing_equals_hgtpu(name):
    dev, truths, _ = check_case(name)
    if len(truths) == 1 and case_of(name)[2]["err"] == 0.0:
        assert dev.prob[0][0] == truths[0]
    assert dev.num_pairs > 0 and dev.prob


@pytest.mark.parametrize("name", ["gaps", "identical"])
def test_untypable_gene_equals_hgtpu(name):
    """A repeat backbone places no read uniquely, and a gene with no
    variant has nothing to tell apart: neither package raises, and both
    return the same empty call."""
    dev, _truths, reads = check_case(name)
    assert reads[0] and dev.prob == [] and dev.cmpt == {}
