"""The passes as CUDA graphs on the card (marked ``cuda``; they skip
without one).  This file imports no jax:

    python -m pytest --noconftest tests/test_torch_cuda_graphs.py -q

On HLA-A samples from the benchmark's generator (``benchmark/gen.py``,
configuration ``hla-a-imgt``, both traffic mixes), ``count_classes``
replayed from graphs must equal the eager passes on the card bit for
bit: paired and single-end, in an order where another sample's passes
replay between a sample's capture and its replay (A, B, A), and at a
class cap of 8, which takes the overflow refetch from the count graph's
outputs.  The fused spelling (a gene of few indels) likewise, and
``type_reads_device``'s results with graphs equal its results with the
eager passes.  K1 stays out of the graphs: every replay calls
``ops.placement.placement_scores`` with each launch's shape.  Six genes
at two read lengths, typed on six threads at once, share the card's
budget and equal the eager passes, with the budget as it is and with
one so small that every call captures anew.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from torch_threads import _torch_threads  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SEED = 2 ** 31 + 77
# sample indices: 0-7 at WGS depth, 8-11 at capture depth; each index
# replays after another sample's shapes ran in between
ORDER = [0, 8, 0, 1, 9, 1, 2, 10, 2, 3, 11, 3, 4, 5, 6, 7, 8]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hla():
    """(HLA-A gene, 12 samples of (reads_1, reads_2)) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = load(os.path.join(BENCH, "gen.py"), "bench_gen")
    system = load(os.path.join(BENCH, "systems", "gene.py"),
                  "bench_system_gene")
    with open(os.path.join(BENCH, "configs", "hla-a-imgt.json")) as f:
        cfg = json.load(f)
    specs = gen.catalog_specs(cfg)
    ref = system.catalog(cfg, specs)
    samples = []
    for name, n in (("wgs30", 8), ("deep", 4)):
        with open(os.path.join(BENCH, "mixes", name + ".json")) as f:
            mix = json.load(f)
        samples += [gen.draw_sample(specs, mix, SEED, i)[1:]
                    for i in range(n)]
    return ref, samples


def same(got, want):
    assert list(got["levels"]) == list(want["levels"])
    for name, parts in want["levels"].items():
        for g, w in zip(got["levels"][name], parts):
            assert np.array_equal(g, w), name
        assert np.array_equal(got["order"][name], want["order"][name])
    for k in ("pileup", "punt", "excl"):
        assert np.array_equal(got[k], want[k]), k
    assert (got["n_reads"], got["n_pairs"]) == (want["n_reads"],
                                                want["n_pairs"])
    assert len(got["winner"]) == len(want["winner"])
    for gw, ww in zip(got["winner"], want["winner"]):
        for k in ww:
            assert np.array_equal(gw[k], ww[k]), k


def typers(gene, **kw):
    """(graphed, eager) typers of `gene` on cuda:0."""
    from hgtpu_torch.parallel.e2e import ShardedTyper

    graphed = ShardedTyper(gene, "cuda:0", **kw)
    eager = ShardedTyper(gene, "cuda:0", **kw)
    eager._graphs = None
    assert graphed._graphs is not None
    return graphed, eager


@pytest.mark.cuda
@pytest.mark.parametrize("cap,paired", [(2048, True), (8, True),
                                        (2048, False)])
def test_hla_count_classes_graphed_equals_eager(hla, cap, paired):
    ref, samples = hla
    graphed, eager = typers(ref, class_cap=cap)
    want = {}
    for k in ORDER:
        r1, r2 = samples[k]
        c1 = graphed.encode([s for _, s in r1])
        c2 = graphed.encode([s for _, s in r2]) if paired else None
        if k not in want:
            want[k] = eager.count_classes(c1, c2)
        got = graphed.count_classes(c1, c2)
        same(got, want[k])
        if cap == 8:
            # more rows than the cap: they came through the overflow leaves
            assert len(got["levels"]["full"][0]) > cap
    # the tiered spelling (HLA-A's hypothesis ceiling is past the fused
    # one's) and at least place, one spell tier and count per sample
    assert graphed._fused_H > 8
    assert len(graphed._graphs) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("spell", ["auto", "off"])
@pytest.mark.parametrize("paired", [True, False])
def test_fused_and_tiered_graphed_equal_eager(monkeypatch, spell, paired):
    """The indel gene of tests/test_torch_cuda.py at 5 % errors, whose
    hypothesis ceiling takes the fused spelling unless it is off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads
    from synth import make_gene_msa

    monkeypatch.setenv("HGTPU_FUSED_SPELL", spell)
    spec = make_gene_msa(seed=3, n_alleles=40)
    gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                             spec["ref_allele"], min_var_freq=8.0)
    graphed, eager = typers(gene, class_cap=64)
    assert graphed._fused_H <= 8      # fused unless the spelling is off
    reads = []
    for interval, seed in ((2, 11), (5, 12)):
        r1, r2, _ = simulate_reads(gene, gene.allele_names[:2],
                                   simulate_interval=interval, read_len=100,
                                   frag_len=250, seed=seed,
                                   perbase_errorrate=5.0)
        c1 = graphed.encode([r.seq for r in r1])
        c2 = graphed.encode([r.seq for r in r2]) if paired else None
        reads.append((c1, c2, eager.count_classes(c1, c2)))
    for k in (0, 1, 0, 1):
        c1, c2, want = reads[k]
        same(graphed.count_classes(c1, c2), want)


@pytest.mark.cuda
def test_k1_is_called_from_python_on_every_replay(hla, monkeypatch):
    """Each replay calls K1 through ``ops.placement``, as the eager passes
    do, with the same shapes; its kernel runs and its launches count."""
    from torch.profiler import ProfilerActivity, profile

    from hgtpu_torch.ops import placement
    from hgtpu_torch.ops.placement_kernel import placement_scores

    shapes = []
    real = placement.placement_scores

    def k1(pwm_ext, reads):
        shapes.append((tuple(pwm_ext.shape), tuple(reads.shape)))
        return real(pwm_ext, reads)

    monkeypatch.setattr(placement, "placement_scores", k1)
    ref, samples = hla
    graphed, eager = typers(ref)
    r1, r2 = samples[0]
    c1 = graphed.encode([s for _, s in r1])
    c2 = graphed.encode([s for _, s in r2])
    before = placement_scores.launches
    want = eager.count_classes(c1, c2)
    per_call = shapes[:]
    assert len(per_call) == 4                         # both orientations
    assert placement_scores.launches == before + 4    # of both mates
    graphed.count_classes(c1, c2)                     # captures
    n = len(graphed._graphs)
    del shapes[:]
    before = placement_scores.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        same(graphed.count_classes(c1, c2), want)     # replays only
        torch.cuda.synchronize()
    assert len(graphed._graphs) == n
    assert shapes == per_call
    assert placement_scores.launches == before + 4
    names = [e.name for e in prof.events()]
    assert sum("placement_scores" in k for k in names) == 4, \
        sorted(set(names))[:20]


@pytest.mark.cuda
def test_type_reads_device_with_graphs_equals_eager(hla):
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.parallel.production import (_shared_sharded_typer,
                                                 type_reads_device)
    from hgtpu_torch.parallel.sharded import Mesh
    from hgtpu_torch.typer import TypingOptions

    ref, samples = hla
    dev = torch.device("cuda:0")
    opts = TypingOptions()
    aligner = GeneAligner(ref, device=dev)
    st = _shared_sharded_typer(ref, opts, Mesh([dev]), 100)
    graphs = st._graphs
    assert graphs is not None
    for k in ORDER:
        r1, r2 = samples[k]
        st._graphs = None
        try:
            want = type_reads_device(ref, r1, r2, opts, aligner=aligner)
        finally:
            st._graphs = graphs
        got = type_reads_device(ref, r1, r2, opts, aligner=aligner)
        assert got == want, k
    assert len(graphs) >= 3 and graphs.bytes <= graphs.budget


@pytest.mark.cuda
@pytest.mark.parametrize("budget", ["card", "tiny"])
def test_six_genes_on_threads_share_the_card(monkeypatch, budget):
    """Six genes at read lengths 100 and 150 (twelve typers), each gene
    on a thread of its own, every sample typed twice: the same results
    as the eager passes.  With the card's budget the graphs of all twelve
    stay under it; with one of a byte every call gives the pools of the
    caches not in a call back, while other threads capture and replay."""
    from concurrent.futures import ThreadPoolExecutor

    from hgtpu_torch.db import build_catalog_from_msa
    from hgtpu_torch.parallel.graphs import Card
    from hgtpu_torch.parallel.production import (_shared_sharded_typer,
                                                 type_reads_device)
    from hgtpu_torch.parallel.sharded import Mesh
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.typer import TypingOptions
    from synth import make_family

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fam = make_family(genes=tuple("ABCDEF"), n_alleles=16, length=2000,
                      seed=21)
    cat = build_catalog_from_msa("hla", {
        g: dict(names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"])
        for g, s in fam["specs"].items()}, min_var_freq=0.0)
    dev = torch.device("cuda:0")
    mesh = Mesh([dev])
    opts = TypingOptions()
    jobs = {}
    for gi, g in enumerate(cat.genes):
        gene = cat.genes[g]
        for read_len in (100, 150):
            r1, r2, _ = simulate_reads(
                gene, gene.allele_names[:2], simulate_interval=5,
                read_len=read_len, frag_len=350, seed=31 + gi,
                perbase_errorrate=1.0)
            jobs[g, read_len] = ([(r.name, r.seq) for r in r1],
                                 [(r.name, r.seq) for r in r2])
    want, caches = {}, []
    for (g, read_len), (r1, r2) in jobs.items():
        st = _shared_sharded_typer(cat.genes[g], opts, mesh, read_len)
        graphs, st._graphs = st._graphs, None
        try:
            want[g, read_len] = type_reads_device(cat.genes[g], r1, r2,
                                                  opts, device=dev)
        finally:
            st._graphs = graphs
        caches.append(graphs)
    card = Card.of(dev)
    assert all(c.card is card for c in caches)
    if budget == "tiny":
        monkeypatch.setattr(card, "budget", 1)

    def gene_thread(g):
        got = []
        for _round in range(2):
            for read_len in (100, 150):
                r1, r2 = jobs[g, read_len]
                got.append(((g, read_len), type_reads_device(
                    cat.genes[g], r1, r2, opts, device=dev)))
        return got

    with ThreadPoolExecutor(max_workers=6) as ex:
        results = [r for got in ex.map(gene_thread, list(cat.genes))
                   for r in got]
    assert len(results) == 24
    for key, got in results:
        assert got == want[key], key
    # the fused or a tiered spelling, and count, for every typer
    assert all(len(c) >= 2 for c in caches) or budget == "tiny"
    assert not any(c._in_call for c in caches)
    if budget == "card":
        assert 0 < card.bytes <= card.budget
        assert card.budget == \
            torch.cuda.get_device_properties(dev).total_memory // 8
    else:
        caches[0].begin()           # no cache in a call: every pool goes
        caches[0].end()
        assert card.bytes == 0
