"""hgtpu's parallel/sharded.py step functions and the multi-shard dry
run, in the port.

Each step function of hgtpu_torch.parallel.sharded (``sharded_place``
on K1's plain version here, ``sharded_verify_filter``,
``sharded_banded_dp`` on the DP's plain version, ``sharded_count`` with
K2's plain version in ``_compat`` and its psum-reduced totals, and
``sharded_typing_step``) equals hgtpu's at make_mesh(2), as
tests/test_parallel.py holds hgtpu's: positions, lower bounds, costs,
overflow flags, masks and totals exact, scores exact, the replicated EM's
prob within 1e-5 (float32, 100 iterations, sums in another order).
``entry.dryrun_multichip(2)`` and ``(8)`` on the CPU call the truth.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgtpu.parallel import sharded as jax_sharded
from hgtpu_torch.entry import dryrun_multichip
from hgtpu_torch.parallel import sharded
from hgtpu_torch.parallel.sharded import Sharded, make_mesh
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def generef():
    from hgtpu.db import build_gene_ref
    spec = make_gene_msa(seed=11, n_alleles=32, length=1600)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=0.0)
    return ref


def _np(x):
    return (x.cpu() if isinstance(x, (torch.Tensor, Sharded)) else
            torch.from_numpy(np.array(x))).numpy()


def test_sharded_place_equals_hgtpu(generef):
    from hgtpu.ops.placement import backbone_pwm

    rng = np.random.default_rng(0)
    reads = rng.integers(0, 4, (64, 96)).astype(np.int8)
    pwm = backbone_pwm(generef)
    pwm_ext = np.concatenate([pwm, np.zeros((96, 5), np.float32)])
    s_j, p_j = jax_sharded.sharded_place(jax_sharded.make_mesh(2))(
        jnp.asarray(pwm_ext), jnp.asarray(reads))
    s_t, p_t = sharded.sharded_place(make_mesh(2, "cpu"))(
        torch.from_numpy(pwm_ext), torch.from_numpy(reads))
    assert isinstance(p_t, Sharded) and len(p_t.parts) == 2
    assert np.array_equal(_np(s_t), _np(s_j))
    assert np.array_equal(_np(p_t), _np(p_j))


def test_sharded_verify_filter_equals_hgtpu():
    rng = np.random.default_rng(23)
    R, W, PAD = 300, 24, 4
    tbl = rng.random((R + 2 * PAD + W, 6)) < 0.5
    tbl[:, 4:] = False
    E = 16
    reads = rng.integers(0, 4, (E, W)).astype(np.int8)
    starts = rng.integers(0, R - 1, E).astype(np.int32)
    w_eff = rng.integers(0, W + 1, E).astype(np.int32)
    want = jax_sharded.sharded_verify_filter(
        jax_sharded.make_mesh(2), lb_pad=PAD)(
        jnp.asarray(tbl), jnp.asarray(reads), jnp.asarray(starts),
        jnp.asarray(w_eff))
    got = sharded.sharded_verify_filter(make_mesh(2, "cpu"), lb_pad=PAD)(
        *(torch.from_numpy(a) for a in (tbl, reads, starts, w_eff)))
    assert np.array_equal(_np(got), _np(want))


def test_sharded_banded_dp_equals_hgtpu():
    from hgtpu.db import build_gene_ref
    from hgtpu.ops.banded_dp import BandedDPTables as JaxTables
    from hgtpu.utils.dna import encode_seq
    from hgtpu_torch.ops.banded_dp import BandedDPTables

    spec = make_gene_msa(seed=11, n_alleles=16, length=1200)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=0.0)
    jtab, ttab = JaxTables(ref), BandedDPTables(carried(ref), "cpu")
    rng = np.random.default_rng(5)
    E, W = 32, 80
    reads = np.full((E, W), 4, np.int8)
    lens = np.full(E, W, np.int32)
    starts = np.zeros(E, np.int32)
    for i in range(E):
        seq = ref.allele_seq(ref.allele_names[int(rng.integers(
            0, ref.n_alleles))])
        s = int(rng.integers(0, len(seq) - W - 4))
        r = list(seq[s:s + W])
        if rng.random() < 0.5:
            r[int(rng.integers(1, W - 1))] = "ACGT"[int(rng.integers(0, 4))]
        reads[i] = encode_seq("".join(r))
        starts[i] = s
    want_c, want_o = jax_sharded.sharded_banded_dp(jax_sharded.make_mesh(2))(
        jtab.P, jtab.del_lens, jtab.ins_lens)(
        jtab.arrays, jnp.asarray(reads), jnp.asarray(lens),
        jnp.asarray(starts))
    got_c, got_o = sharded.sharded_banded_dp(make_mesh(2, "cpu"))(
        ttab.P, ttab.del_lens, ttab.ins_lens)(
        (ttab.table, ttab.planes), torch.from_numpy(reads),
        torch.from_numpy(lens), torch.from_numpy(starts))
    assert np.array_equal(_np(got_c), _np(want_c))
    assert np.array_equal(_np(got_o), _np(want_o))


def _count_inputs(generef):
    from hgtpu.typer.device_count import DeviceCounter as JaxCounter
    from hgtpu_torch.typer.device_count import DeviceCounter

    jdc = JaxCounter(generef)
    tdc = DeviceCounter(carried(generef), "cpu")
    rng = np.random.default_rng(1)
    hts = []
    for _ in range(64):
        left = int(rng.integers(0, len(generef.backbone) - 120))
        right = left + 99
        vs = [int(v) for v in range(generef.n_vars)
              if left <= generef.var_pos[v] <= right][:3]
        hts.append((left, right, vs))
    lefts, rights, vars_ = jdc.pack_hts(hts)
    class_mask = rng.random((8, generef.n_alleles)) < 0.2
    class_counts = rng.integers(1, 20, 8).astype(np.float32)
    return jdc, tdc, (lefts, rights, vars_, class_mask, class_counts)


def test_sharded_count_equals_hgtpu(generef):
    jdc, tdc, args = _count_inputs(generef)
    A = generef.n_alleles
    want = jax_sharded.sharded_count(jax_sharded.make_mesh(2))(
        *jax_sharded.device_tables(jdc), *(jnp.asarray(a) for a in args))
    got = sharded.sharded_count(make_mesh(2, "cpu"))(
        *sharded.device_tables(tdc), *(torch.from_numpy(a) for a in args))
    assert np.array_equal(_np(got[0])[:, :A], _np(want[0])[:, :A])
    # the psum-reduced totals are the global per-allele sums
    assert np.array_equal(_np(got[1])[:A], _np(want[1])[:A])
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=0, atol=1e-5)
    assert abs(float(got[2].sum()) - 1.0) < 1e-4


def test_sharded_typing_step_equals_hgtpu(generef):
    from hgtpu.ops.placement import backbone_pwm

    jdc, tdc, (lefts, rights, vars_, cmask, ccounts) = _count_inputs(
        generef)
    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, (64, 96)).astype(np.int8)
    pwm_ext = np.concatenate([backbone_pwm(generef),
                              np.zeros((96, 5), np.float32)])
    tbl = rng.random((len(generef.backbone) + 200, 6)) < 0.5
    starts = rng.integers(0, len(generef.backbone) - 100, 64).astype(
        np.int32)
    w_eff = np.full(64, 96, np.int32)
    rest = (tbl, starts, w_eff)
    want = jax_sharded.sharded_typing_step(jax_sharded.make_mesh(2))(
        jnp.asarray(pwm_ext), jnp.asarray(reads),
        *(jnp.asarray(a) for a in rest), jax_sharded.device_tables(jdc),
        *(jnp.asarray(a) for a in (lefts, rights, vars_, cmask, ccounts)))
    got = sharded.sharded_typing_step(make_mesh(2, "cpu"))(
        torch.from_numpy(pwm_ext), torch.from_numpy(reads),
        *(torch.from_numpy(a) for a in rest), sharded.device_tables(tdc),
        *(torch.from_numpy(a) for a in (lefts, rights, vars_, cmask,
                                        ccounts)))
    A = generef.n_alleles
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        if k == 2:
            g, w = g[:A], w[:A]
        if k == 3:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_mesh(n):
    dryrun_multichip(n, device="cpu")
