"""The port's production tables equal hgtpu's.

hgtpu_torch.parallel.e2e.ShardedTyper builds its device tables from the
GeneRef with the same numpy code as hgtpu's ShardedTyper; they must
equal hgtpu's ``_tables`` array for array (uint32 words as int32 bit
patterns, the bf16 link matrix as bf16), on the toy gene (exons, fused
branch) and on the indel gene.  ``tables_from_arrays`` carries hgtpu's
tables across unchanged.  compat_mxu's bf16 products have a float32
output, so a catalog whose counts pass bf16's 256 builds and counts
exactly; a count that could pass float32's exact range raises.
"""
import random

import numpy as np
import pytest
import torch

from hgtpu.db import build_gene_ref
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.parallel.sharded import make_mesh
from hgtpu_torch.parallel import e2e
from hgtpu_torch.parallel.e2e import (ShardedTyper, count_product,
                                      max_overlap, tables_from_arrays)
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


def _toy():
    spec = make_gene_msa(seed=11, n_alleles=60, length=3000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"],
                            exons_ref_coords=spec["exons"],
                            min_var_freq=0.0)
    return ref


def _indel():
    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=8.0)
    return ref


GENES = {"toy": _toy, "indel": _indel}


@pytest.fixture(scope="module", params=sorted(GENES))
def typers(request):
    gene = GENES[request.param]()
    return (gene, JaxTyper(gene, make_mesh(1)),
            ShardedTyper(carried(gene), "cpu"))


def as_numpy(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """A port tensor in the dtype of hgtpu's array (uint32 words from
    their int32 bit patterns, bf16 through float32)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    a = t.numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


def test_tables_equal_hgtpu(typers):
    _gene, jt, tt = typers
    assert len(jt._tables) == len(tt._tables) == 24
    for i, (a, t) in enumerate(zip(jt._tables, tt._tables)):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
            assert t.dtype == torch.bfloat16, i
        got = as_numpy(t, a)
        assert got.dtype == a.dtype, (i, got.dtype, a.dtype)
        assert np.array_equal(got, a), i


def test_constants_equal_hgtpu(typers):
    _gene, jt, tt = typers
    for name in ("_K", "_offs", "_fused_ns", "_fused_H", "_gate_n",
                 "_staged", "_with_primary", "_NLEV", "_W32", "_NSTATE",
                 "_tier_cfg", "A", "P_bb", "n_devices"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert [n for n, _ in tt._levels] == [n for n, _ in jt._levels]
    for (_, a), (_, b) in zip(tt._levels, jt._levels):
        assert np.array_equal(a, b)
    assert np.array_equal(tt._rep_mask_np, jt._rep_mask_np)
    assert np.array_equal(tt._primary_mask_np, jt._primary_mask_np)
    # the toy and the indel gene both take the fused branch
    assert tt._fused_H <= 8


def test_tables_from_arrays_carries_hgtpu_tables(typers):
    _gene, jt, tt = typers
    carried = tables_from_arrays([np.asarray(a) for a in jt._tables], "cpu")
    for i, (c, t) in enumerate(zip(carried, tt._tables)):
        assert c.dtype == t.dtype, (i, c.dtype, t.dtype)
        assert torch.equal(c, t), i


def _dense_gene():
    """Every backbone position carries all three SNP alleles: a read
    window meets ~3 catalog variants per base."""
    rng = random.Random(5)
    bases = "ACGT"
    anc = "".join(rng.choice(bases) for _ in range(400))
    rows = [anc] + ["".join(bases[(bases.index(c) + k) % 4] for c in anc)
                    for k in (1, 2, 3)]
    names = ["A*%02d:01" % (k + 1) for k in range(4)]
    ref, _ = build_gene_ref("A", names, rows, names[0], min_var_freq=0.0)
    return carried(ref)


def test_bf16_count_bound_raises(monkeypatch):
    """A catalog whose counts could pass bf16's 256 builds, as it does in
    hgtpu (compat_mxu's output is float32); the guard raises once a
    count could pass the output's exact range."""
    gene = _dense_gene()
    assert max_overlap(gene, 100) >= 256
    tt = ShardedTyper(gene, "cpu")
    assert 256 <= tt._max_count < e2e.COUNT_EXACT
    monkeypatch.setattr(e2e, "COUNT_EXACT", 256)
    with pytest.raises(ValueError, match="float32"):
        ShardedTyper(gene, "cpu")


def test_bf16_count_bound_holds_on_real_sizes(typers):
    _gene, _jt, tt = typers
    assert tt._K <= tt._max_count < e2e.COUNT_EXACT


@pytest.mark.parametrize("n", [255, 257, 301, 4097])
def test_count_product_exact_above_bf16(n):
    """0/1 bf16 operands, counts past bf16's 256: exact float32 counts,
    where a bf16 output rounds the odd ones."""
    x = torch.zeros((3, 5000), dtype=torch.bfloat16)
    x[0, :n] = 1
    x[1, 1:n + 1:2] = 1
    links = torch.ones((5000, 2), dtype=torch.bfloat16)
    links[::3, 1] = 0
    out = count_product(x, links)
    want = x.double() @ links.double()
    assert out.dtype == torch.float32
    assert torch.equal(out.double(), want)
    if n > 256:
        assert not torch.equal((x @ links).double(), want)


@pytest.mark.parametrize("span", [1, 7, 100, 131])
def test_max_overlap_equals_brute_force(span):
    gene = carried(_indel())
    pos = gene.var_pos.astype(np.int64)
    right = gene.var_right.astype(np.int64)
    want = max(int(((pos <= lo + span - 1) & (right >= lo)).sum())
               for lo in range(-span, len(gene.backbone) + span))
    assert max_overlap(gene, span) == want
