"""The port's SAM export and import equal hgtpu's.

tests/test_components.py's gene (20 alleles, exons) and its reads go
through both packages' GeneAligner; write_sam must write byte-identical
files (CIGAR, MD, NM and the Zs known-variant tags), read_sam must decode
them into the same alignment records, and type_from_sam must type the
gene the same way — exactly.
"""
import dataclasses
from collections import defaultdict

import pytest

from hgtpu.align import GeneAligner as JaxAligner
from hgtpu.align.sam import read_sam as jax_read_sam
from hgtpu.align.sam import write_sam as jax_write_sam
from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.pipeline.genotype import type_from_sam as jax_type_from_sam
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.align import GeneAligner
from hgtpu_torch.align.sam import aln_to_sam_fields, read_sam, write_sam
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.pipeline import type_from_sam
from hgtpu_torch.typer import TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_aligner import _record
from tests.test_torch_slice import assert_same_result
from tests.torch_threads import _torch_threads  # noqa: F401


def _groups(aligner, r1, r2):
    by = defaultdict(list)
    for mate, reads in (("L", r1), ("R", r2)):
        alns = aligner.align_batch([r.name for r in reads],
                                   [r.seq for r in reads], mate)
        for a in alns:
            if a:
                by[a.read_id.split("|")[0]].append(a)
    return sorted(by.items())


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    """Both packages' genes and SAM files, from the same MSA and reads
    (with sequencing errors, so that MD carries novel mismatches)."""
    spec = make_gene_msa(seed=11, n_alleles=20, length=1500)
    args = ("A", spec["names"], spec["rows"], spec["ref_allele"])
    kw = dict(exons_ref_coords=spec["exons"],
              primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    want, _ = jax_build_gene_ref(*args, **kw)
    got, _ = build_gene_ref(*args, **kw)
    r1, r2, _ = simulate_reads(want, [want.allele_names[7],
                                      want.allele_names[12]],
                               simulate_interval=4, perbase_errorrate=1.0,
                               seed=3)
    root = tmp_path_factory.mktemp("sam")
    paths = (str(root / "jax.sam"), str(root / "port.sam"))
    jax_groups = _groups(JaxAligner(want), r1, r2)
    port_groups = _groups(GeneAligner(got, device="cpu"), r1, r2)
    jax_write_sam(paths[0], want, jax_groups)
    write_sam(paths[1], got, port_groups)
    return want, got, paths, port_groups


def test_write_sam_byte_identical(sams):
    _want, got, (jax_path, port_path), groups = sams
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        text = b.read()
        assert text == a.read()
    assert b"Zs:Z:" in text and b"\tNM:i:1\t" in text
    alns = [a for _, g in groups for a in g]
    assert sum(len(aln_to_sam_fields(got, a)[2]) > 0 for a in alns) > 0


def test_read_sam_equals_hgtpu(sams):
    want, got, (_jax_path, port_path), groups = sams
    back = read_sam(got, port_path)
    ref = jax_read_sam(want, port_path)
    assert [r for r, _ in back] == [r for r, _ in ref]
    for (_r, a), (_s, b) in zip(back, ref):
        assert [_record(x) for x in a] == [_record(x) for x in b]
    # the round trip keeps every aligned read, at its position
    assert len(back) == len(groups)
    assert [[x.pos for x in a] for _, a in back] == \
        [[x.pos for x in a] for _, a in groups]


@pytest.mark.parametrize("primary", [False, True])
def test_type_from_sam_equals_hgtpu(sams, primary):
    want, got, (jax_path, port_path), _groups_ = sams
    kw = dict(simulation=True, type_primary_exons=primary)
    res = type_from_sam(got, port_path, TypingOptions(**kw), device="cpu")
    ref = jax_type_from_sam(want, jax_path, JaxOptions(**kw))
    assert_same_result(res, ref)
    assert {a for a, _ in res.prob[:2]} == {want.allele_names[7],
                                            want.allele_names[12]}
    assert dataclasses.asdict(res)["num_pairs"] > 0
