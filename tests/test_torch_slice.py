"""The port's first end-to-end slice equals hgtpu's.

hgtpu_torch.pipeline.type_reads (placement on K1, host verify, the
engine's haplotype loop, the device fold on K2, the staged numpy EM)
must return exactly hgtpu.pipeline.type_reads's GeneTypingResult —
every field, cmpt dict order included — at 0 % and 3 % per-base error
(the simulator's rate is in percent), paired and single-end, with the
device fold on and off.
"""
import dataclasses

import numpy as np
import pytest

from hgtpu.db import build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.pipeline import simulation_sweep, type_reads
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def generef():
    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=0.0)
    return ref


@pytest.fixture(scope="module")
def read_sets(generef):
    out = {}
    for err in (0.0, 3.0):
        r1, r2, _ = simulate_reads(generef, [generef.allele_names[3],
                                             generef.allele_names[17]],
                                   simulate_interval=6,
                                   perbase_errorrate=err, seed=5)
        out[err] = ([(r.name, r.seq) for r in r1],
                    [(r.name, r.seq) for r in r2])
    return out


def assert_same_result(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for level in ("cmpt", "exon_cmpt", "primary_exon_cmpt"):
        assert list(getattr(got, level).items()) == \
            list(getattr(want, level).items()), level


@pytest.mark.parametrize("device_counting", ["off", "on"])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("err", [0.0, 3.0])
def test_type_reads_equals_hgtpu(generef, read_sets, err, paired,
                                 device_counting):
    reads_1, reads_2 = read_sets[err]
    reads_2 = reads_2 if paired else None
    kw = dict(simulation=True, device_counting=device_counting,
              allow_discordant=not paired)
    want = jax_type_reads(generef, reads_1, reads_2, JaxOptions(**kw))
    got = type_reads(carried(generef), reads_1, reads_2, TypingOptions(**kw),
                     device="cpu")
    assert got.prob and got.num_pairs > 0
    assert_same_result(got, want)
    if err == 0.0:
        assert {a for a, _ in got.prob[:2]} == {generef.allele_names[3],
                                                generef.allele_names[17]}


def test_shared_state_does_not_collide(generef, read_sets):
    """hgtpu caches its jax DeviceCounter on its GeneRef; the port keeps
    its own per-device counters under its own key, on its own GeneRef."""
    from hgtpu.typer.device_count import DeviceCounter as JaxCounter
    from hgtpu.typer.engine import shared_device_counter as jax_shared
    from hgtpu_torch.typer.device_count import DeviceCounter
    from hgtpu_torch.typer.engine import shared_device_counter

    assert isinstance(jax_shared(generef), JaxCounter)
    gene = carried(generef)
    dc = shared_device_counter(gene, "cpu")
    assert isinstance(dc, DeviceCounter)
    assert shared_device_counter(gene, "cpu") is dc
    assert "_typer_shared_torch" in gene.__dict__
    assert "_typer_shared" not in gene.__dict__
    assert "_typer_shared_torch" not in generef.__dict__


@pytest.mark.parametrize("opts,match", [
    (dict(linear_typing=True), "ops/fm.py"),
    (dict(assembly=True), "assembly"),
])
def test_unported_options_raise(generef, read_sets, opts, match):
    """Neither option raises any more: linear_typing (ported with
    ops/fm.py; tests/test_torch_fm.py holds it further) and assembly
    (ported with assemble/; tests/test_torch_assembly.py) each return
    hgtpu's result."""
    reads_1, reads_2 = read_sets[0.0]
    args = (reads_1[:40], reads_2[:40])
    got = type_reads(carried(generef), *args,
                     TypingOptions(simulation=True, **opts), device="cpu")
    want = jax_type_reads(generef, *args,
                          JaxOptions(simulation=True, **opts))
    assert_same_result(got, want)
    assert got.prob
    if "assembly" in opts:
        assert got.assembly_call is not None and got.contigs


def test_simulation_sweep_calls_truth(generef):
    n_passed, results = simulation_sweep(
        carried(generef), test_size=2, seed=1, simulate_interval=10,
        device="cpu")
    assert n_passed == 2
    assert all(np.isfinite([p for _, p in res.prob]).all()
               for _, res in results)
