"""The port's production path at the threshold coverages and at scale.

The analogs of tests/test_production.py's threshold-coverage cases (the
count pass must gate against the FINAL, host-merged pileup) and of its
3,600-allele scale panel at interval 12 (the tiered spelling branch,
exon and primary levels, the device fold in the rescue at A >= 1024):
the port's production result equals hgtpu's field for field and the
port's host path under that file's contract.
"""
import pytest

from hgtpu.db import build_gene_ref
from tests.synth import make_hla_scale_msa
from tests.test_torch_db import carried
from tests.test_torch_e2e_passes import indel_ref, truths  # noqa: F401
from tests.test_torch_production import (assert_host_contract,
                                         assert_same_result, pairs,
                                         three_ways)
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("interval,err", [(8, 0.03), (10, 0.03), (8, 0.05)])
def test_production_threshold_coverage(indel_ref, interval, err):  # noqa: F811
    t_indel = truths(indel_ref)[0]
    R1, R2 = pairs(indel_ref, [t_indel], err, 11, interval)
    dev, want, host = three_ways(indel_ref, R1, R2, simulation=True)
    assert_same_result(dev, want)
    assert_host_contract(dev, host, [t_indel])


def test_production_exact_at_scale():
    from hgtpu_torch.parallel.production import (_shared_sharded_typer,
                                                 default_mesh)
    from hgtpu_torch.typer.engine import TypingOptions

    spec = make_hla_scale_msa()
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    pair = [ref.allele_names[500], ref.allele_names[3100]]
    R1, R2 = pairs(ref, pair, 0.0, 9, 12)
    dev, want, host = three_ways(ref, R1, R2, simulation=True)
    assert_same_result(dev, want)
    assert_host_contract(dev, host, pair)
    # the scale panel spells in tiers (its hypothesis ceiling is above 8)
    st = _shared_sharded_typer(carried(ref), TypingOptions(),
                               default_mesh("cpu"), 100)
    assert st._fused_H > 8
