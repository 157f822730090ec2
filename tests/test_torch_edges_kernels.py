"""The kernels' plain versions at degenerate shapes, against hgtpu.

hgtpu_torch.devel.edges names the shapes: K1 with no read, one read,
one diagonal and none, fewer diagonals than one 128-wide tile, read
widths of 1 and 0; K2 with no haplotype, one, one word per row, one
table row (the sentinel alone), no index and one; the bit DP with no
entry, one, reads one base wide, on the 104-bp two-indel gene and the
variant-free gene.  On the CPU the wrappers take their plain versions
(what the CUDA kernels are held against on the card by
tests/test_torch_cuda.py and chip_smoke.py's edges phase), and each must
equal hgtpu's function on the same inputs: its XLA placement product and
its Pallas AND-reduce in interpret mode, and its banded DP.  hgtpu's
Pallas kernels refuse the empty shapes (N = 0 or P1 = 0; H = 0 or
K = 0) with a TypeError in interpret mode, and its paths never hand them
such a shape; there the port's answer is held against hgtpu's XLA
product, or the AND over no row (all ones).  Exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgtpu.db.catalog import GeneRef as JaxGeneRef
from hgtpu.ops.banded_dp import BandedDPTables as JaxTables
from hgtpu.ops.compat_kernel import and_reduce_pallas
from hgtpu.ops.placement import correlate_scores
from hgtpu.ops.placement_pallas import correlate_scores_pallas
from hgtpu_torch.devel import edges
from hgtpu_torch.ops.banded_dp import BandedDPTables
from hgtpu_torch.ops.compat_kernel import (and_reduce, and_reduce_slab,
                                           and_reduce_wide)
from hgtpu_torch.ops.placement_kernel import placement_scores
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("n,m,P1", edges.K1_SHAPES)
def test_k1_plain_at_degenerate_shapes_equals_hgtpu(n, m, P1):
    pwm, reads = edges.k1_operands(n, m, P1, seed=n + m + P1)
    got = placement_scores(torch.from_numpy(pwm), torch.from_numpy(reads))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, P1)
    want = np.asarray(correlate_scores(jnp.asarray(pwm), jnp.asarray(reads)))
    assert np.array_equal(got.numpy(), want)
    if n and m and P1:
        pallas = correlate_scores_pallas(jnp.asarray(pwm), jnp.asarray(reads))
        assert np.array_equal(got.numpy(), np.asarray(pallas))
    else:
        assert not got.any()
        if not (n and P1):
            with pytest.raises(TypeError):
                correlate_scores_pallas(jnp.asarray(pwm),
                                        jnp.asarray(reads))


@pytest.mark.parametrize("V1,W,H,K", edges.K2_SHAPES)
def test_k2_plain_at_degenerate_shapes_equals_hgtpu(V1, W, H, K):
    links, vars_ = edges.k2_operands(V1, W, H, K, seed=V1 + W + H + K)
    lt, vt = torch.from_numpy(links), torch.from_numpy(vars_)
    got = and_reduce(lt, vt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
    for variant in (and_reduce_slab(lt, vt), and_reduce_wide(lt, vt)):
        assert torch.equal(variant, got)
    if H and K:
        want = np.asarray(and_reduce_pallas(jnp.asarray(links.view(np.uint32)),
                                            jnp.asarray(vars_)))
        assert np.array_equal(got.numpy().view(np.uint32), want)
    else:
        assert (got == -1).all()
        with pytest.raises(TypeError):
            and_reduce_pallas(jnp.asarray(links.view(np.uint32)),
                              jnp.asarray(vars_))


@pytest.mark.parametrize("name,E,W,budget", edges.DP_SHAPES)
def test_dp_plain_at_degenerate_shapes_equals_hgtpu(name, E, W, budget):
    spec = edges.specs()[name]
    if "fields" in spec:
        ref = JaxGeneRef(**spec["fields"])
    else:
        from hgtpu.db import build_gene_ref

        ref = build_gene_ref(*spec["args"], **spec["kw"])[0]
    reads, lens, starts = edges.dp_operands(ref, E, W, seed=E + W)
    jc, jo = JaxTables(ref).costs(reads, lens, starts, budget)
    cost, over = BandedDPTables(carried(ref), "cpu").costs(
        reads, lens, starts, budget)
    assert tuple(cost.shape) == tuple(over.shape) == (E,)
    assert np.array_equal(cost.numpy(), np.asarray(jc)[:E])
    assert np.array_equal(over.numpy(), np.asarray(jo)[:E])
