"""The panel router keeps a paralog's reads where the exhaustive path
types them, and a family typing call is one TRACE call with the router's
spans and counters.

The family is built by hand: gene A, whose alleles carry a catalogued
2-bp deletion; gene B, a paralog whose backbone is A's with that
deletion and a substitution every 12 bases; gene C, unrelated.  A read
of A across the deletion scores far higher on B's ungapped diagonal than
on A's, so A is not among its first candidates, and B cannot align it.
"""
import time

import numpy as np
import pytest

from hgtpu_torch.align import FamilyAligner
from hgtpu_torch.db import build_catalog_from_msa
from hgtpu_torch.pipeline import type_family
from hgtpu_torch.sim import simulate_reads
from hgtpu_torch.typer import TypingOptions
from hgtpu_torch.utils.trace import TRACE
from tests.torch_threads import _torch_threads  # noqa: F401

DEL = (450, 452)          # A's catalogued deletion, backbone columns


def _snp(row, p):
    return row[:p] + "ACGT"[("ACGT".index(row[p]) + 1) % 4] + row[p + 1:]


@pytest.fixture(scope="module")
def family():
    rng = np.random.default_rng(11)
    x = "".join("ACGT"[i] for i in rng.integers(0, 4, 900))
    gap = x[:DEL[0]] + ".." + x[DEL[1]:]
    a = dict(names=["A*01:01", "A*02:01", "A*03:01", "A*04:01"],
             rows=[x, gap, _snp(x, 200), _snp(x, 700)])
    y = x[:DEL[0]] + x[DEL[1]:]
    for p in range(5, len(y), 12):
        y = _snp(y, p)
    b = dict(names=["B*01:01", "B*02:01", "B*03:01"],
             rows=[y, _snp(y, 300), _snp(y, 500)])
    z = "".join("ACGT"[i] for i in rng.integers(0, 4, 800))
    c = dict(names=["C*01:01", "C*02:01", "C*03:01"],
             rows=[z, _snp(z, 250), _snp(z, 550)])
    msas = {}
    for g, spec in (("A", a), ("B", b), ("C", c)):
        msas[g] = dict(spec, ref_allele=spec["names"][0],
                       exons=[(100, 300), (400, 600)], primary_exon_idx=(0,))
    return build_catalog_from_msa("hla", msas, min_var_freq=0.0), gap


def test_a_read_with_its_genes_indel_is_kept_past_a_paralog(family):
    catalog, gap = family
    fa = FamilyAligner(catalog, device="cpu")
    read = gap.replace(".", "")[400:500]
    gm, lens = fa.router.gene_max([read])
    assert gm[0, 1] - gm[0, 0] > fa.slack      # B outscores A past the slack
    assert gm[0, 0] >= fa.min_seed_frac * lens[0]
    res = fa.align_batch(["r0"], [read], "L")
    assert res["B"][0] is None and res["C"][0] is None
    aln = res["A"][0]
    assert aln is not None and aln.nm == 0
    assert any(op[0] == "deletion" for op in aln.cmp)


def sample(catalog):
    r1, r2 = [], []
    for g, pair in (("A", ["A*01:01", "A*02:01"]),
                    ("B", ["B*01:01", "B*02:01"]),
                    ("C", ["C*01:01", "C*02:01"])):
        m1, m2, _ = simulate_reads(catalog.genes[g], pair,
                                   simulate_interval=6, seed=3)
        r1 += [(g + r.name, r.seq) for r in m1]
        r2 += [(g + r.name, r.seq) for r in m2]
    return r1, r2


def test_router_on_types_the_pairs_of_router_off(family):
    catalog, _ = family
    r1, r2 = sample(catalog)
    pairs = {}
    for route in ("on", "off"):
        fa = FamilyAligner(catalog, route=route, device="cpu")
        res = type_family(catalog, r1, r2, opts=TypingOptions(),
                          family_aligner=fa, device="cpu")
        pairs[route] = {g: r.num_pairs for g, r in res.items()}
    assert all(abs(pairs["on"][g] - pairs["off"][g]) <= 1
               for g in pairs["off"]), pairs
    assert min(pairs["off"].values()) > 0


def test_a_family_call_is_one_call_with_the_routers_counters(family):
    catalog, _ = family
    r1, r2 = sample(catalog)
    fa = FamilyAligner(catalog, device="cpu")
    t0 = time.perf_counter()
    type_family(catalog, r1, r2, family_aligner=fa, device="cpu")
    calls = TRACE.calls(t0, time.perf_counter())
    assert len(calls) == 1
    call = calls[0]
    assert call["spans"][0][0] == "call.type_family"
    assert call["spans"][0][3] == -1 and call["dropped"] == 0
    st = call["stages"]
    assert st["family.route"]["n"] == 2 and st["family.nh1"]["n"] == 2
    assert st["family.align"]["n"] == 4              # two rounds, two mates
    assert "type.em" in st and "verify.prep" in st
    c = call["counters"]
    assert c["route.reads"] == len(r1) + len(r2)
    assert len(r1) < c["route.candidates"] < 3 * (len(r1) + len(r2))
    # the reads across A's deletion go to the second round and no others
    assert 0 < c["route.second_reads"] <= c["route.second_genes"]
    assert c["route.second_reads"] < 0.2 * c["route.reads"]
