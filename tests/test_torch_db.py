"""The port's own graph-reference build, catalog and read simulator
equal hgtpu's.

hgtpu_torch carries copies of hgtpu's host modules (``db``, ``sim``,
``utils``, ``validate``) so that it imports nothing of hgtpu.  Here the
same MSAs, made from a seed, go through both builds: every GeneRef field
must be equal (arrays by dtype and ``np.array_equal``, lists and sets by
``==``).  A gene hgtpu built must cross into the port unchanged, through
``gene_from_fields`` and through an ``.npz`` written by hgtpu's
``save_npz``, and ``simulate_reads`` must give the same reads and names
from the same seed.  Exact equality everywhere.
"""
import dataclasses
import functools

import numpy as np
import pytest

from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.db.catalog import Catalog as JaxCatalog
from hgtpu.db.catalog import GeneRef as JaxGeneRef
from hgtpu.db.catalog import load_npz as jax_load_npz
from hgtpu.db.catalog import save_npz as jax_save_npz
from hgtpu.sim import parse_truth_name as jax_parse_truth_name
from hgtpu.sim import simulate_reads as jax_simulate_reads
from hgtpu_torch.db import (Catalog, GeneRef, build_gene_ref,
                            gene_from_fields, load_npz, save_npz)
from hgtpu_torch.sim import parse_truth_name, simulate_reads
from tests.synth import make_gene_msa, make_hla_scale_msa, make_nuc_msa
from tests.torch_threads import _torch_threads  # noqa: F401


def _spec(case):
    """(MSA spec, build_gene_ref keyword arguments) of one case."""
    if case == "scale":
        spec = make_hla_scale_msa()
        return spec, dict(exons_ref_coords=spec["exons"],
                          primary_exon_idx=spec["primary_exon_idx"],
                          partial_names=spec["partial"], min_var_freq=0.0)
    if case == "indel":          # insertion variants need min_var_freq 8
        return make_gene_msa(seed=3, n_alleles=40), dict(min_var_freq=8.0)
    if case == "exons":          # exons, a primary exon, grafted partials
        spec = make_gene_msa(seed=11)
        return spec, dict(exons_ref_coords=spec["exons"],
                          primary_exon_idx=(1,), min_var_freq=0.1,
                          partial_msa=make_nuc_msa(spec))
    if case == "whole":          # whole-gene haplotypes, no left shift
        return make_gene_msa(seed=5, n_alleles=24), dict(
            whole_haplotype=True, leftshift=False, base_var_id=100)
    seed = int(case.split("-")[1])
    return make_gene_msa(seed=seed, n_alleles=32, length=2000), dict(
        min_var_freq=0.0)


CASES = ["seed-3", "seed-7", "seed-11", "indel", "exons", "whole", "scale"]


@functools.lru_cache(maxsize=None)
def _built(case):
    """(hgtpu's gene and next id, the port's gene and next id)."""
    spec, kw = _spec(case)
    args = ("A", spec["names"], spec["rows"], spec["ref_allele"])
    return jax_build_gene_ref(*args, **kw), build_gene_ref(*args, **kw)


def _fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


_CARRIED = {}


def carried(g):
    """hgtpu's gene carried into the port: the port's own GeneRef with
    identical contents, one per source gene, so the port's per-gene
    caches live as long as hgtpu's (the other test_torch_* files use
    this, so that each side of a parity test holds its own package's
    gene)."""
    hit = _CARRIED.get(id(g))
    if hit is None or hit[0] is not g:
        hit = _CARRIED[id(g)] = (g, gene_from_fields(_fields(g)))
    return hit[1]


def assert_same_gene(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for name, x in _fields(want).items():
        y = getattr(got, name)
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray) and y.dtype == x.dtype, name
            assert np.array_equal(y, x), name
        else:
            assert y == x, name
    # what __post_init__ derives
    for name in ("backbone_enc", "var_right", "var_maxright"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.allele_lengths() == want.allele_lengths()


@pytest.mark.parametrize("case", CASES)
def test_build_gene_ref_equals_hgtpu(case):
    (want, want_next), (got, got_next) = _built(case)
    assert type(got) is GeneRef and type(want) is JaxGeneRef
    assert got_next == want_next
    assert_same_gene(got, want)
    for name in got.allele_names[:: max(1, got.n_alleles // 16)]:
        assert got.allele_seq(name) == want.allele_seq(name)
    if case == "indel":
        assert {0, 1, 2} <= set(got.var_type.tolist())
    if case == "exons":
        assert got.partial and len(got.primary_exons) == 1


@pytest.mark.parametrize("case", CASES)
def test_gene_from_fields_carries_hgtpus_gene(case):
    """hgtpu's gene, taken apart into its fields, becomes a port GeneRef
    equal to the port's own build, sharing no array with the source."""
    (want, _), (own, _) = _built(case)
    got = gene_from_fields(_fields(want))
    assert type(got) is GeneRef
    assert_same_gene(got, own)
    assert_same_gene(got, want)
    assert not np.shares_memory(got.links, want.links)
    assert "_typer_shared_torch" not in got.__dict__


def test_gene_from_fields_refuses_other_keys():
    (want, _), _ = _built("seed-3")
    fields = _fields(want)
    fields["backbone_enc"] = want.backbone_enc
    with pytest.raises(TypeError, match="backbone_enc"):
        gene_from_fields(fields)
    del fields["backbone_enc"], fields["links"]
    with pytest.raises(TypeError):
        gene_from_fields(fields)


@pytest.mark.parametrize("case", ["seed-11", "exons", "scale"])
def test_npz_written_by_hgtpu_loads_in_the_port(tmp_path, case):
    (want, _), (own, _) = _built(case)
    path = str(tmp_path / "fam.npz")
    jax_save_npz(JaxCatalog(family="hla", genes={"A": want},
                            version="v1"), path)
    cat = load_npz(path)
    assert type(cat) is Catalog and cat.version == "v1"
    assert type(cat.gene("A")) is GeneRef
    assert_same_gene(cat.gene("A"), jax_load_npz(path).gene("A"))
    # the port's own round trip gives the same gene
    path2 = str(tmp_path / "own.npz")
    save_npz(Catalog(family="hla", genes={"A": own}, version="v1"), path2)
    assert_same_gene(load_npz(path2).gene("A"), cat.gene("A"))


@pytest.mark.parametrize("case,kw", [
    ("seed-11", dict(simulate_interval=1, seed=0)),
    ("indel", dict(simulate_interval=3, perbase_errorrate=2.0,
                   perbase_snprate=0.5, seed=9)),
    ("exons", dict(simulate_interval=5, read_len=80, frag_len=200,
                   skip_fragment_regions=((300, 500),), seed=4)),
    ("scale", dict(simulate_interval=7, perbase_errorrate=1.0, seed=1)),
])
def test_simulate_reads_equals_hgtpu(case, kw):
    (want_gene, _), (gene, _) = _built(case)
    truths = [gene.allele_names[1], gene.allele_names[-2]]
    w1, w2, wn = jax_simulate_reads(want_gene, truths, **kw)
    g1, g2, gn = simulate_reads(gene, truths, **kw)
    assert gn == wn and sum(gn) > 0
    for got, want in ((g1, w1), (g2, w2)):
        assert [(r.name, r.seq) for r in got] == \
            [(r.name, r.seq) for r in want]
    for r in (g1 + g2)[::97]:
        assert parse_truth_name(r.name) == jax_parse_truth_name(r.name)
