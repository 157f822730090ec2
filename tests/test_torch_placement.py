"""Placement buffers of the port equal hgtpu's bit for bit.

`place_batch_packed` and `place_scan_batch` (through each aligner's
`_place_chunk`, which encodes both orientations) on the toy gene and on
an indel gene (min_var_freq=8.0 keeps insertion variants), with ragged
read lengths so the scan planes see reads shorter than the padded width.
"""
import numpy as np
import pytest

from hgtpu.align import GeneAligner as JaxAligner
from hgtpu.db import build_gene_ref
from hgtpu.db.catalog import VT_INSERTION
from hgtpu.sim import simulate_reads
from hgtpu_torch.align import GeneAligner
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


def _gene(min_var_freq):
    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=min_var_freq)
    return ref


@pytest.fixture(scope="module")
def genes():
    return {"toy": _gene(0.0), "indel": _gene(8.0)}


def _seqs(gene, err):
    r1, r2, _ = simulate_reads(gene, [gene.allele_names[3],
                                      gene.allele_names[17]],
                               simulate_interval=9, perbase_errorrate=err,
                               seed=5)
    seqs = [r.seq for r in r1] + [r.seq for r in r2]
    # ragged lengths: the planes must ignore bases past each read's end
    return [s[:len(s) - (i % 23)] for i, s in enumerate(seqs)]


@pytest.mark.parametrize("which", ["toy", "indel"])
@pytest.mark.parametrize("scan", ["on", "off"])
def test_place_buffers_bit_equal(genes, which, scan):
    gene = genes[which]
    if which == "indel":
        assert (gene.var_type == VT_INSERTION).any()
    ja = JaxAligner(gene, place_scan=scan, device_verify="off")
    ta = GeneAligner(carried(gene), place_scan=scan, device="cpu")
    assert ta._scan_shifts == ja._scan_shifts
    for err in (0.0, 3.0):
        seqs = _seqs(gene, err)
        want = ja._place_chunk(seqs)
        got = ta._place_chunk(seqs)
        want_buf = np.asarray(want[2])
        got_buf = got[2].numpy()
        assert got_buf.dtype == want_buf.dtype == np.int16
        assert got_buf.shape == want_buf.shape
        assert np.array_equal(got_buf, want_buf)
        # host-side pieces ride along unchanged
        assert got[3] == want[3]
        assert np.array_equal(got[4], want[4])
        assert np.array_equal(got[5], want[5])
