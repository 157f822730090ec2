"""The port's count_classes on a mesh of several shards equals hgtpu's
on the same mesh.

hgtpu_torch.parallel.sharded.Mesh holds n CPU shards here (make_mesh(n,
"cpu")); hgtpu's programs run on n of the 8 virtual CPU devices
(tests/conftest.py).  At 1, 2 and 8 shards the port's dict equals
hgtpu's exactly: every level's rows, weights, totals and first-seen
order, the pileup, the punt and exclusion masks, n_reads, n_pairs and
the winner words; paired and single-end, fused and tiered, at 5 %
per-base error.  Across the port's own mesh sizes the aggregated
class -> weight maps, totals, pileup, punt and counts are equal
(tests/test_production.py's mesh-invariance case).  Mesh.psum and the
shard layout on their own.  tests/test_torch_mesh_typing.py holds the
class cap's overflow, type_reads_device and the device EM on a mesh,
tests/test_torch_mesh_steps.py sharded.py's step functions and the dry
run.
"""
import numpy as np
import pytest
import torch

from hgtpu.parallel import sharded as jax_sharded
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.sim import simulate_reads
from hgtpu_torch.parallel.e2e import ShardedTyper
from hgtpu_torch.parallel.sharded import Sharded, make_mesh
from tests.test_torch_db import carried
from tests.test_torch_e2e_count import assert_same_dict, run
from tests.test_torch_e2e_passes import indel_ref, truths  # noqa: F401
from tests.torch_threads import _torch_threads  # noqa: F401

MESHES = (1, 2, 8)


class MeshTypers:
    """(hgtpu's typer on n devices, the port's on n shards) per (n, class
    cap), built on first use, and the port's count_classes dicts."""

    def __init__(self, ref):
        self.ref, self.gene = ref, carried(ref)
        self.typers, self.dicts = {}, {}

    def __getitem__(self, key):
        if key not in self.typers:
            n, cap = key
            self.typers[key] = (
                JaxTyper(self.ref, jax_sharded.make_mesh(n), class_cap=cap),
                ShardedTyper(self.gene, class_cap=cap,
                             mesh=make_mesh(n, "cpu")))
        return self.typers[key]

    def port(self, reads, monkeypatch, n, spell, paired, cap=2048):
        key = (n, spell, paired, cap)
        if key not in self.dicts:
            self.dicts[key] = run(self[(n, cap)][1], reads, paired, spell,
                                  monkeypatch)
        return self.dicts[key]


@pytest.fixture(scope="module")
def typers(indel_ref):  # noqa: F811
    return MeshTypers(indel_ref)


@pytest.fixture(scope="module")
def reads(indel_ref):  # noqa: F811
    r1, r2, _ = simulate_reads(indel_ref, truths(indel_ref),
                               simulate_interval=4, read_len=100,
                               frag_len=250, seed=13, perbase_errorrate=5.0)
    return [r.seq for r in r1], [r.seq for r in r2]


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("spell", ["fused", "tiered"])
@pytest.mark.parametrize("n", MESHES)
def test_count_classes_equals_hgtpu_on_mesh(typers, reads, monkeypatch, n,
                                            spell, paired):
    want = run(typers[(n, 2048)][0], reads, paired, spell, monkeypatch)
    got = typers.port(reads, monkeypatch, n, spell, paired)
    assert_same_dict(got, want)
    assert got["punt"].any() and got["n_pairs"] > 0


def _agg(rows, w):
    agg = {}
    for r, x in zip(rows, w):
        agg[tuple(r)] = agg.get(tuple(r), 0) + int(x)
    return agg


@pytest.mark.parametrize("n", [2, 8])
def test_count_classes_mesh_invariant(typers, reads, monkeypatch, n):
    """Classes dedup per shard, so rows and first-seen order depend on
    the mesh; what the host merge makes of them must not."""
    for spell in ("fused", "tiered"):
        ref_out = typers.port(reads, monkeypatch, 1, spell, True)
        o = typers.port(reads, monkeypatch, n, spell, True)
        for k in ("pileup", "punt", "excl"):
            assert np.array_equal(o[k], ref_out[k]), (n, spell, k)
        assert (o["n_reads"], o["n_pairs"]) == (ref_out["n_reads"],
                                                ref_out["n_pairs"])
        for name, (r_rows, r_w, r_tot) in ref_out["levels"].items():
            o_rows, o_w, o_tot = o["levels"][name]
            assert np.array_equal(o_tot, r_tot), (n, spell, name)
            assert _agg(o_rows, o_w) == _agg(r_rows, r_w), (n, spell, name)


def test_mesh_psum_and_layout():
    """psum sums the shards in order and hands the sum to every shard; a
    one-shard mesh hands back its own tensor, untouched."""
    mesh = make_mesh(3, "cpu")
    parts = [torch.tensor([1.0, 2.0]) * (s + 1) for s in range(3)]
    out = mesh.psum(parts)
    assert len(out) == 3 and all(torch.equal(o, torch.tensor([6.0, 12.0]))
                                 for o in out)
    one = make_mesh(1, "cpu")
    t = torch.arange(4)
    assert one.psum([t])[0] is t and one.shard(t)[0] is t
    assert mesh.size == 3 and mesh.world == 1
    x = torch.arange(12).reshape(6, 2)
    blocks = mesh.shard(x)
    assert [b.tolist() for b in blocks] == [x[0:2].tolist(), x[2:4].tolist(),
                                            x[4:6].tolist()]
    assert torch.equal(Sharded(blocks).cpu(), x)
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard(torch.arange(4))
