"""The port's GeneAligner.align_batches returns the same alignment
records as hgtpu's for both mates, on the toy and the indel gene, with
and without sequencing errors."""
import dataclasses

import pytest

from hgtpu.align import GeneAligner as JaxAligner
from hgtpu.db import build_gene_ref
from hgtpu.sim import simulate_reads
from hgtpu_torch.align import GeneAligner
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


def _record(aln):
    """Every ReadAln field but uid (a per-process counter), with the
    int8 codes compared as bytes."""
    if aln is None:
        return None
    d = dataclasses.asdict(aln)
    d.pop("uid")
    d["codes"] = bytes(d["codes"])
    d["alts"] = None if aln.alts is None else [_record(a) for a in aln.alts]
    return d


@pytest.mark.parametrize("min_var_freq", [0.0, 8.0])
def test_align_batches_records_equal(min_var_freq):
    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=min_var_freq)
    ja = JaxAligner(gene, device_verify="off")
    ta = GeneAligner(carried(gene), device="cpu")
    for err in (0.0, 3.0):
        r1, r2, _ = simulate_reads(gene, [gene.allele_names[5],
                                          gene.allele_names[20]],
                                   simulate_interval=7,
                                   perbase_errorrate=err, seed=3)
        groups = [([r.name for r in r1], [r.seq for r in r1], "L"),
                  ([r.name for r in r2], [r.seq for r in r2], "R")]
        want = ja.align_batches(groups)
        got = ta.align_batches(groups)
        assert len(got) == len(want) == 2
        for g_mate, w_mate in zip(got, want):
            assert len(g_mate) == len(w_mate)
            if err == 0.0:
                assert sum(a is not None for a in g_mate) > 0.9 * len(g_mate)
            assert [_record(a) for a in g_mate] == \
                [_record(a) for a in w_mate]


def test_device_verify_on_not_ported():
    """device_verify follows hgtpu's GeneAligner on the CPU: "on" without
    the native verifier builds the DP tables and runs no DP, a value
    other than "auto" or "on" is "off", and "auto" is off.  For each
    setting both packages give the same _dp_tables answer and the same
    records, read for read."""
    spec = make_gene_msa(seed=11, n_alleles=8, length=600)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=0.0)
    r1, r2, _ = simulate_reads(gene, [gene.allele_names[2],
                                      gene.allele_names[5]],
                               simulate_interval=9, perbase_errorrate=2.0,
                               seed=5)
    groups = [([r.name for r in r1], [r.seq for r in r1], "L"),
              ([r.name for r in r2], [r.seq for r in r2], "R")]
    for dv, native in (("on", "off"), ("yes", "auto"), ("auto", "auto")):
        port = GeneAligner(carried(gene), device_verify=dv,
                           use_native=native, device="cpu")
        ref = JaxAligner(gene, device_verify=dv, use_native=native)
        assert (port._dp_tables is None) == (ref._dp_tables is None) \
            == (dv != "on"), dv
        got = port.align_batches(groups)
        want = ref.align_batches(groups)
        assert sum(a is not None for a in got[0]) > 0.5 * len(r1)
        for g_mate, w_mate in zip(got, want):
            assert [_record(a) for a in g_mate] == \
                [_record(a) for a in w_mate], dv
