"""Device counting of the port equals hgtpu's.

- DeviceCounter tables built by the port equal hgtpu's tables carried
  across with DeviceCounter.from_arrays;
- compat_masks (bitset AND through K2's plain version + range counts)
  equal hgtpu's and the host GeneCounter;
- DeviceFold.run and the raw _fold_levels buffers equal hgtpu's on the
  inputs hgtpu's own engine hands its fold.
"""
import numpy as np
import pytest
import torch

import hgtpu.typer.device_fold as jax_fold
from hgtpu.db import build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.counting import GeneCounter, HtOp
from hgtpu.typer.device_count import DeviceCounter as JaxCounter
from hgtpu.typer.engine import GeneTyper as JaxTyper
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.typer import device_fold
from hgtpu_torch.typer.device_count import TABLES, DeviceCounter
from hgtpu_torch.typer.engine import GeneTyper, TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def generef():
    spec = make_gene_msa(seed=11, n_alleles=32, length=2000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"],
                            exons_ref_coords=spec["exons"],
                            primary_exon_idx=spec["primary_exon_idx"],
                            min_var_freq=0.0)
    return ref


@pytest.fixture(scope="module")
def tgene(generef):
    """hgtpu's gene as the port's own GeneRef."""
    return carried(generef)


def _jax_arrays(dc):
    return {name: np.asarray(getattr(dc, name)) for name in TABLES}


def _sample_hts(gene, n, seed):
    rng = np.random.default_rng(seed)
    hts = []
    for _ in range(n):
        a = rng.integers(0, gene.n_alleles)
        avars = np.flatnonzero(gene.links[:, a])
        left = int(rng.integers(0, len(gene.backbone) - 120))
        right = left + int(rng.integers(40, 120))
        vs = [int(v) for v in avars
              if left <= gene.var_pos[v] and gene.var_right[v] <= right]
        hts.append((left, right, vs))
    return hts


def test_tables_built_equal_converted(generef, tgene):
    jdc = JaxCounter(generef)
    built = DeviceCounter(tgene, "cpu")
    across = DeviceCounter.from_arrays(tgene, _jax_arrays(jdc), "cpu")
    for name in TABLES:
        a, b = getattr(built, name), getattr(across, name)
        assert a.dtype == b.dtype == torch.int32, name
        assert torch.equal(a, b), name
    assert np.array_equal(built.links_packed.numpy().view(np.uint32),
                          np.asarray(jdc.links_packed))
    with pytest.raises(KeyError):
        DeviceCounter.from_arrays(tgene, {"nd_pos": np.zeros(1)}, "cpu")


@pytest.mark.parametrize("n,seed,k", [(200, 3, 16), (37, 9, 32)])
def test_compat_masks_equal(generef, tgene, n, seed, k):
    jdc = JaxCounter(generef)
    tdc = DeviceCounter(tgene, "cpu")
    hts = _sample_hts(generef, n, seed)
    lefts, rights, vars_ = tdc.pack_hts(hts, k=k)
    got = tdc.compat_masks(lefts, rights, vars_)
    assert np.array_equal(got, jdc.compat_masks(lefts, rights, vars_))
    counter = GeneCounter(generef)
    for i, (left, right, vs) in enumerate(hts[:40]):
        ops = [HtOp(("mismatch", "deletion", "insertion")[
            int(generef.var_type[v])], int(generef.var_pos[v]),
            int(generef.var_len[v]), v, generef.var_data[v]) for v in vs]
        assert np.array_equal(got[i],
                              counter.alleles_for_ht(left, right, ops))


@pytest.fixture(scope="module")
def fold_capture(generef):
    """Run hgtpu's engine with the device fold and record what its fold
    was given and returned, and the arguments of its _fold_levels."""
    runs, levels = [], []
    orig_run = JaxTyper.device_fold_run
    orig_levels = jax_fold._fold_levels

    def spy_run(self, hts_sorted, novel, grouped):
        out = orig_run(self, hts_sorted, novel, grouped)
        runs.append((self.opts, hts_sorted, novel, grouped, out))
        return out

    def spy_levels(*args, **kw):
        levels.append((args, kw))
        return orig_levels(*args, **kw)

    JaxTyper.device_fold_run = spy_run
    jax_fold._fold_levels = spy_levels
    try:
        for err, allele in ((0.0, 3), (3.0, 9)):
            r1, r2, _ = simulate_reads(
                generef, [generef.allele_names[allele]],
                simulate_interval=5, perbase_errorrate=err, seed=11)
            jax_type_reads(generef, [(r.name, r.seq) for r in r1],
                           [(r.name, r.seq) for r in r2],
                           JaxOptions(simulation=True, device_counting="on"))
    finally:
        JaxTyper.device_fold_run = orig_run
        jax_fold._fold_levels = orig_levels
    assert len(runs) == 2 and len(levels) == 2
    return runs, levels


def test_device_fold_run_equal(tgene, fold_capture):
    runs, _ = fold_capture
    for opts, hts_sorted, novel, grouped, want in runs:
        typer = GeneTyper(tgene, TypingOptions(**vars(opts)), "cpu")
        got = typer.device_fold_run(hts_sorted, novel, grouped)
        assert len(got) == len(want) == 3
        for (rows, uw, tt), (rows_j, uw_j, tt_j) in zip(got, want):
            assert rows.dtype == np.uint32
            assert np.array_equal(rows, rows_j)
            assert np.array_equal(uw, uw_j)
            assert np.array_equal(tt, tt_j)


@pytest.mark.parametrize("n_cap", [None, 3])
def test_fold_levels_buffers_equal(tgene, fold_capture, n_cap):
    """The raw single-fetch buffer and the two-step outputs, including a
    cap below the unique count (the overflow layout)."""
    _, levels = fold_capture
    for args, kw in levels:
        kw = dict(kw)
        if n_cap is not None:
            kw["n_cap"] = n_cap
        want = [np.asarray(x) for x in jax_fold._fold_levels(*args, **kw)]
        arrays = [np.asarray(a) for a in args]
        tables = {n: a for n, a in zip(TABLES, arrays[:8])}
        tdc = DeviceCounter.from_arrays(tgene, tables, "cpu")
        rest = [torch.from_numpy(np.array(a)) for a in arrays[8:]]
        got = device_fold._fold_levels(tdc.tables(), *rest, **kw)
        buf, fs, is_first, uw, min_idx = [g.numpy() for g in got]
        assert int(want[0][-1]) > 3             # n_cap=3 overflows
        assert np.array_equal(buf.view(np.uint32), want[0])
        assert np.array_equal(fs.view(np.uint32), want[1])
        assert np.array_equal(is_first, want[2])
        assert np.array_equal(uw, want[3])
        assert np.array_equal(min_idx, want[4])


def test_ht_masks_batch_equal(generef, tgene, fold_capture):
    """The engine's per-ht device batch (DeviceCounter) equals the host
    batch, and hgtpu's host batch, at all three levels."""
    runs, _ = fold_capture
    opts, hts_sorted, novel, _grouped, _out = runs[1]
    typer = GeneTyper(tgene, TypingOptions(**vars(opts)), "cpu")
    dev, host, ref = {}, {}, {}
    typer.ht_masks_batch(hts_sorted, novel, dev)
    typer.ht_masks_batch_host(hts_sorted, novel, host)
    JaxTyper(generef, opts).ht_masks_batch_host(hts_sorted, novel, ref)
    assert list(dev) == list(host) == list(ref) == list(hts_sorted)
    for h in hts_sorted:
        for a, b, c in zip(dev[h], host[h], ref[h]):
            assert np.array_equal(a, b) and np.array_equal(a, c), h
