"""The port's production path equals hgtpu's and the host engine.

hgtpu_torch.pipeline.type_reads(..., device_typing="on") runs the port's
production program (place on K1's plain version here, spell, host pileup
merge, count, host rescue with the device fold, staged EM).  Its
GeneTypingResult must equal hgtpu's production result field for field,
cmpt dict order included, at hgtpu's mesh size: hgtpu's type_reads runs
over default_mesh(), one shard per JAX device (8 under
tests/conftest.py), and the order of the classes depends on the shard
count in both packages, so the port runs over as many CPU shards
(``port_production``).  It must also equal the port's host path under
the contract of
tests/test_production.py (cmpt and exon cmpt exact, read and pair counts
exact, prob within 1e-9 with the same ranking).  The cases are the
analogs of that file's error-free, errored and single-end tests; its
threshold-coverage and scale-panel analogs are in
test_torch_production_scale.py.  Routing follows hgtpu's
_take_device_path with CUDA in place of a TPU.
"""
import dataclasses

import jax
import pytest
import torch

from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.parallel import production
from hgtpu_torch.parallel.sharded import make_mesh
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.pipeline.genotype import _take_device_path
from hgtpu_torch.typer.engine import TypingOptions
from tests.test_torch_db import carried
from tests.test_torch_e2e_passes import indel_ref, truths  # noqa: F401
from tests.torch_threads import _torch_threads  # noqa: F401


def assert_same_result(got, want):
    """Field for field, cmpt dict order included."""
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for level in ("cmpt", "exon_cmpt", "primary_exon_cmpt"):
        assert list(getattr(got, level).items()) == \
            list(getattr(want, level).items()), level


def assert_host_contract(dev, host, alleles):
    """tests/test_production.py's contract against the host engine."""
    assert dev.cmpt == host.cmpt
    assert dev.exon_cmpt == host.exon_cmpt
    assert dev.num_reads == host.num_reads
    assert dev.num_pairs == host.num_pairs
    pd = dict(dev.prob)
    ph = dict(host.prob)
    assert set(pd) == set(ph)
    for a in pd:
        assert abs(pd[a] - ph[a]) < 1e-9, a
    k = len(alleles)
    assert [a for a, _ in dev.prob[:k]] == [a for a, _ in host.prob[:k]]
    if k == 1:
        assert dev.prob[0][0] == alleles[0]
        assert dev.prob[0][1] > 0.9999


def hgtpu_mesh():
    """The port's mesh of as many CPU shards as hgtpu's default_mesh()
    has devices."""
    return make_mesh(len(jax.devices()), "cpu")


def port_production(gene, R1, R2, opts):
    """The port's type_reads at hgtpu's mesh size: type_reads_device over
    hgtpu_mesh() where type_reads routes to the production path, else
    type_reads itself (the host engine, on one device in both
    packages)."""
    if _take_device_path(opts, R2 is not None, torch.device("cpu")):
        return production.type_reads_device(gene, R1, R2, opts,
                                            mesh=hgtpu_mesh())
    return type_reads(gene, R1, R2, opts, device="cpu")


def three_ways(ref, R1, R2, **kw):
    """(port production, hgtpu production, port host) results; the port
    types hgtpu's gene ``ref`` carried across, over hgtpu's mesh size."""
    gene = carried(ref)
    dev = port_production(gene, R1, R2,
                          TypingOptions(device_typing="on", **kw))
    want = jax_type_reads(ref, R1, R2,
                          JaxOptions(device_typing="on", **kw))
    host = type_reads(gene, R1, R2,
                      TypingOptions(device_typing="off", **kw), device="cpu")
    return dev, want, host


def pairs(ref, alleles, err, seed, interval):
    r1, r2, _ = simulate_reads(ref, alleles, simulate_interval=interval,
                               read_len=100, frag_len=250, seed=seed,
                               perbase_errorrate=err)
    return [(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2]


# (error in percent, interval): test_production.py's error-free case,
# and its errored case at 5 % per-base error
@pytest.mark.parametrize("err,interval", [(0.0, 3), (5.0, 2)])
@pytest.mark.parametrize("het", [False, True])
def test_production_equals_hgtpu_and_host(indel_ref, err, interval,  # noqa: F811
                                          het):
    alleles = truths(indel_ref)[:2 if het else 1]
    R1, R2 = pairs(indel_ref, alleles, err, 11, interval)
    dev, want, host = three_ways(indel_ref, R1, R2, simulation=True)
    assert_same_result(dev, want)
    if err < 1.0:
        assert_host_contract(dev, host, alleles)
    else:
        # 5 % error: the calls may differ from the truth, never from the
        # host engine's
        assert_host_contract(dev, host,
                             [a for a, _ in host.prob[:len(alleles)]])


def test_production_single_end(indel_ref):  # noqa: F811
    t_indel = truths(indel_ref)[0]
    r1, r2, _ = simulate_reads(indel_ref, [t_indel], simulate_interval=3,
                               read_len=100, frag_len=250, seed=7)
    R = [("u%d|%s" % (i, r.name), r.seq)
         for i, r in enumerate(list(r1) + list(r2))]
    dev, want, host = three_ways(indel_ref, R, None, simulation=True,
                                 allow_discordant=True)
    assert_same_result(dev, want)
    assert dev.prob[0][0] == host.prob[0][0] == t_indel
    assert dev.cmpt == host.cmpt
    assert dev.num_reads == host.num_reads


@pytest.fixture(scope="module")
def fuzz1():
    """tests/test_fuzz.py's second random gene of random.Random(99) at
    3-12 alleles and 400-900 bp (hgtpu_torch.devel.edges): 8 alleles,
    19 variants, 694 bp."""
    from hgtpu.db import build_gene_ref

    from hgtpu_torch.devel import edges

    spec = edges.specs()["fuzz1"]
    return build_gene_ref(*spec["args"], **spec["kw"])[0]


@pytest.mark.parametrize("opts", [{}, dict(remove_low_abundance_alleles=False)])
def test_production_equals_hgtpu_at_its_mesh_size(fuzz1, opts):
    """On this gene the classes come out in another order on one shard
    than on eight, in both packages: the port equals hgtpu only at
    hgtpu's mesh size, and its one-shard run differs from it."""
    alleles = fuzz1.allele_names[:2]
    R1, R2 = pairs(fuzz1, alleles, 1.0, 7, 2)
    dev, want, host = three_ways(fuzz1, R1, R2, simulation=True, **opts)
    assert_same_result(dev, want)
    assert_host_contract(dev, host, [a for a, _ in host.prob[:2]])
    assert {a for a, _ in dev.prob[:2]} == set(alleles)
    one = production.type_reads_device(
        carried(fuzz1), R1, R2,
        TypingOptions(device_typing="on", simulation=True, **opts),
        device="cpu")
    assert one.cmpt == want.cmpt
    assert list(one.cmpt.items()) != list(want.cmpt.items())


# ---- routing ---- #

@pytest.fixture
def calls(monkeypatch):
    """Records every call of the production entry."""
    seen = []
    real = production.type_reads_device

    def spy(*a, **k):
        seen.append(k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(production, "type_reads_device", spy)
    return seen


@pytest.mark.parametrize("opts,paired,production_path", [
    (dict(device_typing="auto"), True, False),     # CPU: host engine
    (dict(device_typing="on"), True, True),
    (dict(device_typing="off"), True, False),
    (dict(device_typing="on", family="codis"), True, False),
    (dict(device_typing="on", error_correction=False), True, False),
    (dict(device_typing="on", use_alts=False), True, False),
    (dict(device_typing="on", allow_discordant=True), True, False),
    (dict(device_typing="on", allow_discordant=True), False, True),
])
def test_routing(indel_ref, calls, opts, paired, production_path):  # noqa: F811
    R1, R2 = pairs(indel_ref, truths(indel_ref)[:1], 0.0, 5, 12)
    res = type_reads(carried(indel_ref), R1, R2 if paired else None,
                     TypingOptions(simulation=True, **opts), device="cpu")
    assert res.num_pairs > 0
    assert len(calls) == int(production_path)
    if production_path:
        assert calls[0] == torch.device("cpu")


def test_auto_takes_production_on_cuda():
    cuda = torch.device("cuda")      # a device name only: nothing runs
    cpu = torch.device("cpu")
    auto = TypingOptions()
    assert _take_device_path(auto, True, cuda)
    assert not _take_device_path(auto, True, cpu)
    assert not _take_device_path(TypingOptions(device_typing="off"), True,
                                 cuda)
    assert not _take_device_path(TypingOptions(family="codis"), True, cuda)


def test_device_typing_supported_as_hgtpu():
    sup = production.device_typing_supported
    assert sup(TypingOptions(), True)
    assert not sup(TypingOptions(family="codis"), True)
    assert not sup(TypingOptions(assembly=True), True)
    assert not sup(TypingOptions(linear_typing=True), True)
    assert not sup(TypingOptions(error_correction=False), True)
    assert not sup(TypingOptions(allow_discordant=True), True)
    assert sup(TypingOptions(allow_discordant=True), False)


def test_rescued_fragment_rows_equals_hgtpu(indel_ref):  # noqa: F811
    """The per-fragment export of the rescue (the multi-host form of
    _count_rescued) on a punt set realigned through both aligners."""
    import numpy as np

    from hgtpu.parallel import production as jax_production

    R1, R2 = pairs(indel_ref, truths(indel_ref), 5.0, 11, 4)
    idx = np.arange(0, len(R1), 3)
    pile = np.zeros((len(indel_ref.backbone), 6), np.int32)
    outs = []
    for mod, gene, opts, kw in (
            (production, carried(indel_ref), TypingOptions(simulation=True),
             dict(device="cpu")),
            (jax_production, indel_ref, JaxOptions(simulation=True), {})):
        by_pair = mod._align_punts(gene, opts, R1, R2, idx, None, **kw)
        mp = mod._merge_pileup(gene, opts, pile, by_pair, idx)
        outs.append(mod._rescued_fragment_rows(gene, opts, R1, by_pair,
                                               idx, mp, **kw))
    (*got, got_novel), (*want, want_novel) = outs
    assert got[4] == want[4] > 0
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got_novel.meta == want_novel.meta
