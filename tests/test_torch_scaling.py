"""The port's shard sweep (hgtpu_torch.devel.scaling, the twin of
scripts/scaling_bench.py) equals hgtpu's sharded steps.

At 1 and 2 CPU shards, on the sweep's own inputs at the script's shapes
(the tiny gene at 3,072 bp, 192 SNPs, 1,024 alleles; 512 reads of 128 bp
and 512 hts per shard; 64 classes), the port's ``sharded_place`` and
``sharded_count`` give hgtpu's outputs on hgtpu's mesh of as many CPU
devices (tests/conftest.py's virtual devices, as
tests/test_torch_mesh_steps.py takes them): scores, positions, masks and
totals exact, the replicated float32 EM's prob within 1e-5 (100
iterations, sums in another order).  The sweep itself runs at 1 and 2
shards and prints its JSON with the shared-device note.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from hgtpu_torch.devel import scaling
from hgtpu_torch.parallel.sharded import make_mesh
from hgtpu_torch.typer.device_count import DeviceCounter
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("n", [1, 2])
def test_sweep_steps_equal_hgtpu(n):
    import __graft_entry__ as ge
    from hgtpu.parallel import sharded as jax_sharded
    from hgtpu.typer.device_count import DeviceCounter as JaxCounter

    s = scaling.SHAPES
    gene = scaling.make_gene()
    jgene = ge._tiny_gene(backbone_len=s["backbone_len"], n_snp=s["n_snp"],
                          n_alleles=s["n_alleles"])
    assert gene.backbone == jgene.backbone
    assert np.array_equal(gene.links, jgene.links)
    x = scaling.make_inputs(gene, n, np.random.default_rng(0))
    assert len(x["reads"]) == len(x["hts"]) == 512 * n
    got = scaling.outputs(scaling.Steps(
        gene, DeviceCounter(gene, device="cpu"), make_mesh(n, "cpu"), x)())

    jdc = JaxCounter(jgene)
    mesh = jax_sharded.make_mesh(n)
    lefts, rights, vars_ = jdc.pack_hts(x["hts"])
    scores, pos = jax_sharded.sharded_place(mesh)(
        jnp.asarray(x["pwm_ext"]), jnp.asarray(x["reads"]))
    masks, totals, prob = jax_sharded.sharded_count(mesh)(
        *jax_sharded.device_tables(jdc), jnp.asarray(lefts),
        jnp.asarray(rights), jnp.asarray(vars_),
        jnp.asarray(x["class_mask"]), jnp.asarray(x["class_counts"]))
    want = [np.asarray(a) for a in (scores, pos, masks, totals, prob)]
    for name, g, w in zip(scaling.OUTPUT_NAMES[:4], got[:4], want[:4]):
        assert g.shape == w.shape and np.array_equal(g, w), name
    assert got[4].shape == want[4].shape
    assert np.abs(got[4] - want[4]).max() < 1e-5
    # the counts are real: haplotypes with variants, alleles compatible
    assert want[3].sum() > 0 and (want[2].sum(1) < gene.n_alleles).any()


def test_sweep_prints_json(capsys):
    out = scaling.main(["--max-shards", "2", "--reps", "1",
                        "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    res = printed["results"]
    assert sorted(res) == ["1", "2"]
    assert [res[k]["reads"] for k in ("1", "2")] == [512, 1024]
    assert res["1"]["scaling_efficiency"] == 1.0
    for r in res.values():
        assert r["sec"] > 0 and r["reads_per_s"] == r["reads"] / r["sec"]
    assert printed["devices"] == ["cpu"] and "not scaling" in printed["note"]
