"""The port's assembly at scale equals hgtpu's.

tests/test_hla_scale.py::test_assembly_at_scale through both packages:
the 3,600-allele panel (~1,500 catalog variants, 3.5 kb backbone), the
truth ``allele_names[123]`` homozygous at read interval 4.  The port's
``type_reads(..., assembly=True)`` on the CPU must give hgtpu's call and
contigs (names and sequences), call the truth homozygous, and stay inside
hgtpu's 60 s wall budget.
"""
import time

from hgtpu.db import build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_hla_scale_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


def test_assembly_at_scale_equals_hgtpu():
    spec = make_hla_scale_msa()
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    truth = ref.allele_names[123]
    r1, r2, _ = simulate_reads(ref, [truth], simulate_interval=4, seed=1)
    reads = ([(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2])
    want = jax_type_reads(ref, *reads,
                          JaxOptions(simulation=True, assembly=True))
    gene = carried(ref)
    t0 = time.time()
    got = type_reads(gene, *reads,
                     TypingOptions(simulation=True, assembly=True),
                     device="cpu")
    wall = time.time() - t0
    assert got.prob[0][0] == truth
    assert got.assembly_call is not None
    assert got.assembly_call == want.assembly_call
    assert got.assembly_call[0] == [truth, truth]
    assert list(got.contigs.items()) == list(want.contigs.items())
    assert got.contigs and len(got.contigs) <= 2
    assert got.prob == want.prob
    assert wall < 60.0, "scale assembly blew the wall budget: %.1f s" % wall
