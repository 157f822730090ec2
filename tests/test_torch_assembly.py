"""The port's assembly equals hgtpu's.

``hgtpu_torch.assemble`` copies hgtpu's node model (AsmNode, its helpers,
viterbi_path, the node builders and the PDF writer) and derives
``AssemblyGraph.guided_debruijn`` anew.  On hgtpu's own inputs
(tests/test_assembly.py, tests/synth.py) every piece must give hgtpu's
result: the node operations, the allele and read nodes, the call
``[[a1, a2], log10 score]``, the contigs (names, coordinates, sequences)
in ``graph.nodes`` and ``graph.nodes2``, ``type_reads(..., assembly=True)``
and the PDF bytes.  The read nodes come from hgtpu's own typing run (its
``_run_assembly`` is spied on), so both packages assemble the same
nodes.  The derivation must not reuse the identifiers of the
transliteration hgtpu's guided_debruijn is.
"""
import dataclasses
import os
import random
import re

import numpy as np
import pytest

import hgtpu.typer.engine as jax_engine
from hgtpu.assemble import graph as jax_graph
from hgtpu.assemble import nodes as jax_nodes
from hgtpu.assemble import pdf as jax_pdf
from hgtpu.db import build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.typer.alts import VarTable as JaxVarTable
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.assemble import graph, nodes, pdf
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.typer.alts import VarTable
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gene(min_var_freq=0.0):
    spec = make_gene_msa(seed=11)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"],
        min_var_freq=min_var_freq)
    return ref


@pytest.fixture(scope="module")
def generef():
    return _gene()


def _sample(ref, alleles, interval=2, err=0.0, seed=0):
    """Reads of the given alleles with distinct ids (test_assembly's
    heterozygous layout)."""
    r1, r2 = [], []
    for k, a in enumerate(alleles):
        x1, x2, _ = simulate_reads(ref, [ref.allele_names[a]],
                                   simulate_interval=interval,
                                   perbase_errorrate=err, seed=seed + k)
        r1 += x1
        r2 += x2
    return ([("%d|L_x" % i, r.seq) for i, r in enumerate(r1)],
            [("%d|R_x" % i, r.seq) for i, r in enumerate(r2)])


def _capture(ref, reads_1, reads_2, assemble=True):
    """hgtpu's typing result and what it handed its _run_assembly: the
    gene, the novel variants, the read haplotypes and the abundances.
    With assemble=False hgtpu's own assembly is skipped (its call and
    contigs stay None)."""
    seen = []
    real = jax_engine._run_assembly

    def spy(gene, typer, novel, asm_reads, prob):
        seen.append((gene, dict(novel.meta), asm_reads, prob))
        if not assemble:
            return None, None
        return real(gene, typer, novel, asm_reads, prob)

    jax_engine._run_assembly = spy
    try:
        res = jax_type_reads(ref, reads_1, reads_2,
                             JaxOptions(simulation=False, assembly=True))
    finally:
        jax_engine._run_assembly = real
    assert len(seen) == 1
    return res, seen[0]


# the captured runs: (gene, alleles, read interval, error %, seed)
RUNS = {
    "single": (0.0, [7], 3, 0.0, 0),
    "het": (0.0, [3, 24], 4, 0.0, 0),
    # insertion variants exist only past the carriers' fraction
    "indel": (30.0, [5, 9], 4, 0.0, 1),
    "errors": (0.0, [11, 19], 4, 3.0, 2),
}


@pytest.fixture(scope="module")
def runs(generef):
    genes = {0.0: generef, 30.0: _gene(30.0)}
    out = {}
    for name, (mvf, alleles, interval, err, seed) in RUNS.items():
        ref = genes[mvf]
        reads = _sample(ref, alleles, interval, err, seed)
        # type_reads' parity test needs hgtpu's call for these two
        out[name] = (ref, reads) + _capture(
            ref, *reads, assemble=name in ("single", "het"))
    return out


def _graph(pkg, gene, meta, asm_reads, predicted, keep=None):
    """An AssemblyGraph of `pkg` (hgtpu's or the port's modules) over
    the captured read haplotypes, as _run_assembly builds it."""
    mods = {"h": (jax_graph, jax_nodes, JaxVarTable),
            "t": (graph, nodes, VarTable)}[pkg]
    g_mod, n_mod, vt_cls = mods
    if pkg == "t":
        gene = carried(gene)
    vt = vt_cls(gene, dict(meta))
    g = g_mod.AssemblyGraph(
        gene.backbone, vt, gene.exons, gene.primary_exons,
        predicted_allele_nodes={a: n_mod.allele_node(gene, a, vt)
                                for a in predicted})
    for i, (_rid, per_mate) in enumerate(asm_reads):
        if keep is not None and not keep(i):
            continue
        for aln, hts in per_mate:
            nid = "%s|%s" % (aln.read_id.split("|")[0], aln.mate)
            for rid, sub, node in n_mod.read_nodes_from_hts(
                    gene, vt, nid, hts, aln.seq):
                g.add_node(rid, sub, node)
    return g


def _node_view(node):
    return (node.id, node.left, node.right, node.ins_len, node.get_seq(),
            [sorted(d.items()) for d in node.seq], sorted(node.read_ids),
            sorted(node.mate_ids), node.avg)


def _view(nodes_):
    if nodes_ is None:
        return None
    return [(k, _node_view(n)) for k, n in nodes_.items()]


def _assemble(g):
    """guided_debruijn's call and the graph's node tables after it; or
    "raised": hgtpu's engine turns any exception there into no call, and
    draws nothing, so a raise only has to be a raise."""
    try:
        call = g.guided_debruijn()
    except Exception:
        return "raised"
    return call, _view(g.nodes), _view(g.nodes2)


def _predicted(res, gene, kind):
    top = [a for a, _p in res.prob[:3]]
    return {"top2": top[:2], "top1": top[:1], "none": [],
            "wrong": [gene.allele_names[0], gene.allele_names[1]]}[kind]


# --------------------------------------------------------------------- #
# the node model
# --------------------------------------------------------------------- #
def _random_node_data(rng, left, length):
    seq, vars_ = [], []
    for p in range(length):
        r = rng.random()
        if r < 0.06:
            seq.append("D")
            vars_.append("hvD%d" % (p % 7))
        elif r < 0.10:
            seq.append("I" + rng.choice("ACGT"))
            vars_.append("hvI")
        else:
            seq.append(rng.choice("ACGT"))
            vars_.append("" if rng.random() < 0.7 else "hv%d" % (p % 5))
    extra = [(rng.random() < 0.3, rng.choice("ACGT"), rng.randint(1, 3))
             for _ in seq]
    return left, seq, vars_, extra


def _make(mod, nid, data):
    left, seq, vars_, extra = data
    node = mod.AsmNode(nid, left, seq, [60] * len(seq), vars_, ref_seq="",
                       ref_vars={}, mpileup=None)
    for d, (thick, alt, n) in zip(node.seq, extra):
        if thick:
            if alt in d:
                d[alt][0] += n
            else:
                d[alt] = [n, ""]
    node.calculate_avg_cov()
    return node


def test_overlap_and_combine_equal_hgtpu():
    """test_overlap_with_matches_oracle's 60 randomised node pairs:
    overlap_with (both skipN settings) and combine_with as hgtpu's."""
    rng = random.Random(41)
    compared = 0
    for _trial in range(60):
        la = rng.randint(40, 90)
        da = _random_node_data(rng, 100, la)
        db = _random_node_data(rng, 100 + rng.randint(0, la + 4),
                               rng.randint(20, 80))
        pairs = [(_make(m, "a|L", da), _make(m, "b|L", db))
                 for m in (jax_graph, graph)]
        (ha, hb), (ta, tb) = pairs
        if ha.left > hb.left or ha.right < hb.left:
            continue
        for skip in (False, True):
            assert ta.overlap_with(tb, skip) == ha.overlap_with(hb, skip)
        ha.combine_with(hb)
        ta.combine_with(tb)
        assert _node_view(ta) == _node_view(ha)
        assert ta.get_var_ids() == ha.get_var_ids()
        compared += 1
    assert compared > 30


def test_viterbi_path_equals_hgtpu():
    rng = np.random.default_rng(5)
    for _ in range(50):
        rows = int(rng.integers(1, 12))
        trellis = [list(rng.choice([-1.0, -0.5, 0.0, -0.25], size=2))
                   for _ in range(rows)]
        states = [[[0, 1], [1, 0]] if rng.random() < 0.5
                  else [[0, 0], [0, 0]] for _ in range(rows)]
        assert graph.viterbi_path(trellis, states) == \
            jax_graph.viterbi_path(trellis, states)


def test_allele_and_read_nodes_equal_hgtpu(runs):
    for name in ("het", "indel"):
        ref, _reads, _res, (gene, meta, asm_reads, _prob) = runs[name]
        tgene = carried(gene)
        jvt, tvt = JaxVarTable(gene, dict(meta)), VarTable(tgene, dict(meta))
        for a in gene.allele_names[:12]:
            assert _node_view(nodes.allele_node(tgene, a, tvt)) == \
                _node_view(jax_nodes.allele_node(gene, a, jvt))
        n = 0
        kinds = set()
        for _rid, per_mate in asm_reads:
            for aln, hts in per_mate:
                args = ("%s|%s" % (aln.read_id, aln.mate), hts, aln.seq)
                got = nodes.read_nodes_from_hts(tgene, tvt, *args)
                want = jax_nodes.read_nodes_from_hts(gene, jvt, *args)
                assert [(r, s, _node_view(x)) for r, s, x in got] == \
                    [(r, s, _node_view(x)) for r, s, x in want]
                for _r, _s, x in got:
                    kinds |= {nt[0] for d in x.seq for nt in d}
                n += len(got)
        assert n > 100
        if name == "indel":
            assert {"D", "I"} <= kinds


@pytest.mark.parametrize("case", [
    "single-top2", "het-top2", "indel-top2", "errors-top2",
    "het-sparse-top2", "het-sparse-none", "het-sparse-wrong",
    "indel-sparse-top1", "errors-sparse-top2", "single-sparse-wrong"])
def test_guided_debruijn_equals_hgtpu(runs, case):
    """From the same nodes both packages give the same call, the same
    graph.nodes and graph.nodes2 (ids, coordinates, sequences, counts)
    — or both raise.  "sparse" keeps a fifth of the reads, so the graph
    breaks into many strand groups and the merge rules run."""
    name, *mods, kind = case.split("-")
    _ref, _reads, res, (gene, meta, asm_reads, _prob) = runs[name]
    keep = None
    if "sparse" in mods:
        pick = random.Random(sum(map(ord, case)))
        kept = {i for i in range(len(asm_reads)) if pick.random() < 0.2}
        keep = kept.__contains__
    predicted = _predicted(res, gene, kind)
    want = _assemble(_graph("h", gene, meta, asm_reads, predicted, keep))
    got = _assemble(_graph("t", gene, meta, asm_reads, predicted, keep))
    assert got == want
    if kind == "top2" and not mods and name in ("single", "het"):
        call, contigs, _ = got
        truth = [gene.allele_names[a] for a in RUNS[name][1]]
        assert sorted(call[0]) == sorted(truth * (3 - len(truth)))
        assert contigs and len(contigs) <= 2


def _allele_columns(backbone, variants, chosen):
    """An allele's node columns [(backbone pos, column, var id)]: a base,
    "D" per deleted base, "I<base>" per inserted base."""
    snp, dels, ins = {}, {}, {}
    for vid in chosen:
        kind, pos, data = variants[vid]
        {"single": snp, "deletion": dels, "insertion": ins}[kind][pos] = \
            (data, vid)
    cols, p = [], 0
    while p < len(backbone):
        if p in ins:
            cols += [(p, "I" + c, ins[p][1]) for c in ins[p][0]]
        if p in dels:
            n = int(dels[p][0])
            cols += [(q, "D", dels[p][1])
                     for q in range(p, min(p + n, len(backbone)))]
            p += n
            continue
        cols.append((p,) + (snp[p] if p in snp else (backbone[p], "")))
        p += 1
    return cols


def _synthetic_graph(mod, seed):
    """A random gene (SNPs, deletions, insertions), 1-4 alleles, and
    read nodes cut from them: 30-140 columns (some under K), paired or
    not, with errors, a rare N, and some reads with a second haplotype
    node; predicted alleles right, partial, none or wrong."""
    rng = random.Random(seed)
    hard = seed % 2
    n = rng.randint(250, 700)
    backbone = "".join(rng.choice("ACGT") for _ in range(n))
    variants, used = {}, set()
    for k in range(rng.randint(3, 25)):
        p = rng.randrange(5, n - 10)
        if used & set(range(p - 1, p + 8)):
            continue
        r, vid = rng.random(), "hv%d" % k
        if r < 0.6:
            variants[vid] = ("single", p, rng.choice(
                [c for c in "ACGT" if c != backbone[p]]))
            used.add(p)
        elif r < 0.8:
            d = rng.randint(1, 5)
            variants[vid] = ("deletion", p, str(d))
            used.update(range(p, p + d))
        else:
            variants[vid] = ("insertion", p, "".join(
                rng.choice("ACGT") for _ in range(rng.randint(1, 3))))
            used.add(p)
    alleles = {"X*%02d" % a: [v for v in variants if rng.random() < 0.4]
               for a in range(rng.choice([3, 4] if hard else [1, 2, 2, 3]))}
    cols = {a: _allele_columns(backbone, variants, ch)
            for a, ch in alleles.items()}
    err = rng.choice([0.0, 0.0, 0.01, 0.03])
    reads = []
    for f in range(rng.randint(60, 250) if hard else rng.randint(10, 120)):
        a = rng.choice(list(cols))
        for mate in ("L", "R"):
            if mate == "R" and rng.random() < 0.2:
                continue
            ln = rng.choice([rng.randint(30, 70), rng.randint(60, 140),
                             100, 100])
            if len(cols[a]) <= ln:
                continue
            st = rng.randrange(0, len(cols[a]) - ln)
            win = cols[a][st:st + ln]
            while win and win[0][1][0] == "I":
                win = win[1:]
            seq, var = [], []
            for _pos, col, vid in win:
                if col[0] not in "DI" and rng.random() < err:
                    col, vid = rng.choice([x for x in "ACGT" if x != col]), \
                        "unknown"
                if col[0] not in "DI" and rng.random() < 0.002:
                    col, vid = "N", ""
                seq.append(col)
                var.append(vid)
            if not win:
                continue
            rid = "%d|%s" % (f, mate)
            reads.append((rid, 0, win[0][0], seq, var))
            if rng.random() < 0.15 and len(cols) > 1:
                other = cols[rng.choice([x for x in cols if x != a])]
                w2 = [t for t in other if win[0][0] <= t[0] <= win[-1][0]]
                while w2 and w2[0][1][0] == "I":
                    w2 = w2[1:]
                if w2:
                    reads.append((rid, 1, w2[0][0], [t[1] for t in w2],
                                  [t[2] for t in w2]))
    names = list(alleles)
    predicted = rng.choice([names[:2], names[:1], [], names[-2:][::-1]])

    def allele_node(name):
        seq, var = list(backbone), [""] * n
        for vid in alleles[name]:
            kind, pos, data = variants[vid]
            if kind == "single":
                seq[pos], var[pos] = data, vid
            elif kind == "deletion":
                d = int(data)
                seq[pos:pos + d] = ["D"] * d
                var[pos:pos + d] = [vid] * d
        return mod.AsmNode(name, 0, seq, None, var, backbone, variants, None)

    g = mod.AssemblyGraph(backbone, variants, [(0, n - 1)], [],
                          predicted_allele_nodes={a: allele_node(a)
                                                  for a in predicted})
    for rid, sub, left, seq, var in reads:
        g.add_node(rid, sub, mod.AsmNode(rid, left, list(seq), None,
                                         list(var), backbone, variants,
                                         None))
    return g


@pytest.mark.parametrize("first", range(0, 36, 6))
def test_guided_debruijn_synthetic_equals_hgtpu(first):
    """Random genes and read nodes built straight from AsmNodes (short
    nodes, N bases, reads with two haplotype nodes, three or four
    alleles, wrong predictions): six seeds a case, each equal to
    hgtpu's call, graph.nodes and graph.nodes2, or raising as it does."""
    compared = 0
    for seed in range(first, first + 6):
        want = _assemble(_synthetic_graph(jax_graph, seed))
        got = _assemble(_synthetic_graph(graph, seed))
        assert got == want, seed
        compared += want != "raised"
    assert compared >= 4


def test_type_reads_assembly_equals_hgtpu(runs):
    """type_reads(..., assembly=True): every result field, the call and
    the contig calls included."""
    for name in ("single", "het"):
        ref, reads, want, _captured = runs[name]
        got = type_reads(carried(ref), *reads,
                         TypingOptions(simulation=False, assembly=True),
                         device="cpu")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.assembly_call is not None and got.contigs
        truth = {ref.allele_names[a] for a in RUNS[name][1]}
        assert set(got.assembly_call[0]) == truth


def test_draw_assembly_equal_bytes(runs, tmp_path):
    """The plots of a phased run, and the per-base zoom of
    test_pdf_per_base_zoom_text, byte for byte."""
    _ref, _reads, res, (gene, meta, asm_reads, _prob) = runs["indel"]
    out = {}
    keep = set(range(0, len(asm_reads), 2)).__contains__
    for pkg, mods in (("h", (jax_pdf, gene)), ("t", (pdf, carried(gene)))):
        mod, g_ref = mods
        g = _graph(pkg, gene, meta, asm_reads, _predicted(res, gene, "top2"),
                   keep)
        panels = [("a. Read alignment",
                   mod.panel_from_nodes(g, g_ref, g.nodes))]
        g.guided_debruijn()
        panels.append(("b. Assembly", mod.panel_from_nodes(g, g_ref,
                                                           g.nodes)))
        panels.append(("c. Assembly with known alleles",
                       mod.panel_from_nodes(g, g_ref, g.nodes2)))
        g.calculate_coverage()
        path = str(tmp_path / ("%s.pdf" % pkg))
        mod.draw_assembly(path, len(g_ref.backbone), panels,
                          coverage=g.coverage, exons=g_ref.exons)
        zoom = str(tmp_path / ("%s.zoom.pdf" % pkg))
        mod.draw_assembly(zoom, 60, [("a. Read alignment", [
            ("n0", 0, 19, [5], "ACGTACGTACGTACGTACGT")])], exons=[(2, 30)])
        out[pkg] = (open(path, "rb").read(), open(zoom, "rb").read(),
                    g.coverage)
    assert out["t"] == out["h"]
    assert out["t"][0].startswith(b"%PDF") and \
        out["t"][0].endswith(b"%%EOF\n")


# hgtpu's guided_debruijn transliterates GPL code; the port derives it
# anew and must not carry the transliteration's names
TRANSLITERATED = ("min_n", "kmer_seq", "first_pair", "try_hard", "del_row",
                  "del_col", "add_merge", "add_copy", "add_remove",
                  "vertice_count")


def test_no_transliterated_identifiers():
    d = os.path.join(ROOT, "hgtpu_torch", "assemble")
    files = sorted(f for f in os.listdir(d) if f.endswith(".py"))
    assert "graph.py" in files
    for f in files:
        src = open(os.path.join(d, f)).read()
        for name in TRANSLITERATED:
            assert not re.search(r"\b%s\b" % name, src), (f, name)
        assert '"%d-%d"' not in src and "'%d-%d'" not in src, f
