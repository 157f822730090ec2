"""The port's family typing and panel routing equal hgtpu's.

The same synthetic families (tests/synth.make_family) go through both
packages' build_catalog_from_msa; then, each package on its own catalog:
PanelRouter.gene_max (the panel product on K1's plain version and the
per-gene segment max), FamilyAligner.align_batch with the router on and
off (the NH==1 rule), type_family (one thread and two, with per-gene SAM
output, and with a RunLog when one gene raises), and ReadExtractor on
tests/test_family.py's WGS-style reads.  Exact equality everywhere.
"""
import os
import random

import numpy as np
import pytest

import hgtpu.pipeline.genotype as jax_genotype
import hgtpu_torch.pipeline.genotype as genotype
from hgtpu.align.family import FamilyAligner as JaxFamilyAligner
from hgtpu.align.panel import PanelRouter as JaxRouter
from hgtpu.db import build_catalog_from_msa as jax_build_catalog
from hgtpu.pipeline import ReadExtractor as JaxExtractor
from hgtpu.pipeline import type_family as jax_type_family
from hgtpu.sim import simulate_reads
from hgtpu.utils.dna import revcomp
from hgtpu.utils.runlog import RunLog as JaxRunLog
from hgtpu_torch.align import FamilyAligner, PanelRouter
from hgtpu_torch.db import build_catalog_from_msa
from hgtpu_torch.pipeline import ReadExtractor, type_family
from hgtpu_torch.utils.runlog import RunLog
from tests.synth import make_family
from tests.test_torch_aligner import _record
from tests.test_torch_db import assert_same_gene
from tests.test_torch_slice import assert_same_result
from tests.torch_threads import _torch_threads  # noqa: F401


def _catalogs(fam):
    specs = {g: dict(names=s["names"], rows=s["rows"],
                     ref_allele=s["ref_allele"], exons=s["exons"],
                     primary_exon_idx=s["primary_exon_idx"])
             for g, s in fam["specs"].items()}
    return (jax_build_catalog("hla", specs, min_var_freq=0.0),
            build_catalog_from_msa("hla", specs, min_var_freq=0.0))


@pytest.fixture(scope="module")
def trio():
    """A 3-gene family (route "auto" takes the router) and reads of each
    gene plus random background reads, as tests/test_family.py:120."""
    fam = make_family(genes=("A", "B", "C"), n_alleles=10, length=1200,
                      seed=33)
    want, got = _catalogs(fam)
    rng = random.Random(5)
    reads_1, reads_2 = [], []
    for g in ("A", "B", "C"):
        ref = want.gene(g)
        r1, r2, _ = simulate_reads(ref, [ref.allele_names[2],
                                         ref.allele_names[6]],
                                   simulate_interval=12, seed=rng.random())
        reads_1 += [("%s%d" % (g, i), r.seq) for i, r in enumerate(r1)]
        reads_2 += [("%s%d" % (g, i), r.seq) for i, r in enumerate(r2)]
    for i in range(20):
        reads_1.append(("bg%d" % i, "".join(rng.choice("ACGT")
                                            for _ in range(100))))
        reads_2.append(("bg%d" % i, "".join(rng.choice("ACGT")
                                            for _ in range(100))))
    return fam, want, got, reads_1, reads_2


def test_build_catalog_from_msa_equals_hgtpu(trio):
    _fam, want, got, _r1, _r2 = trio
    assert got.family == want.family and list(got.genes) == list(want.genes)
    for g in want.genes:
        assert_same_gene(got.genes[g], want.genes[g])
    # family-global variant ids continue across genes
    assert got.genes["B"].var_ids[0] == "hv%d" % want.genes["A"].n_vars


def test_gene_max_equals_hgtpu(trio):
    """Reads of 100 bp (m = 128), reads past the spacer (clipped to 512)
    and a ragged batch (the reverse complement's shifted build)."""
    _fam, want, got, reads_1, _r2 = trio
    refs = [(g, want.genes[g]) for g in want.genes]
    jr = JaxRouter(refs)
    tr = PanelRouter([(g, got.genes[g]) for g in got.genes], device="cpu")
    assert np.array_equal(tr.pwm_concat.numpy(), np.asarray(jr.pwm_concat))
    rng = np.random.default_rng(3)
    seqs = [s for _, s in reads_1]
    genome = "".join(got.genes[g].backbone for g in got.genes)
    long_reads = []
    for ln in (700, 520, 300, 450):
        p = int(rng.integers(0, len(genome) - ln))
        long_reads.append(genome[p:p + ln])
    ragged = [s[:int(rng.integers(30, 101))] for s in seqs[::5]]
    for batch in (seqs, long_reads, ragged):
        gm, lens = tr.gene_max(batch)
        w_gm, w_lens = jr.gene_max(batch)
        assert gm.dtype == np.float32 and gm.shape == (len(batch), 3)
        assert np.array_equal(gm, np.asarray(w_gm))
        assert np.array_equal(lens, w_lens)
    assert sorted(tr._seg_cache) == [128, 512]
    # each gene's reads score best in their own gene
    gm, _ = tr.gene_max(seqs[:40])
    assert (gm.argmax(1)[:10] == 0).all()


@pytest.mark.parametrize("route", ["on", "off"])
def test_align_batch_equals_hgtpu(trio, route):
    _fam, want, got, reads_1, _r2 = trio
    ids = [n for n, _ in reads_1]
    seqs = [s for _, s in reads_1]
    fa = FamilyAligner(got, route=route, device="cpu")
    ja = JaxFamilyAligner(want, route=route)
    assert (fa.router is None) == (ja.router is None) == (route == "off")
    res = fa.align_batch(ids, seqs, "L")
    ref = ja.align_batch(ids, seqs, "L")
    assert list(res) == list(ref) == ["A", "B", "C"]
    for g in res:
        assert [_record(a) for a in res[g]] == [_record(a) for a in ref[g]]
    kept = sum(a is not None for g in res for a in res[g])
    assert kept >= 0.9 * (len(seqs) - 20)
    # the NH == 1 rule: no read is kept in two genes
    for i in range(len(seqs)):
        assert sum(res[g][i] is not None for g in res) <= 1


@pytest.mark.parametrize("threads", [1, 2])
def test_type_family_equals_hgtpu(trio, threads, tmp_path):
    _fam, want, got, reads_1, reads_2 = trio
    w = jax_type_family(want, reads_1, reads_2, threads=threads,
                        sam_out=str(tmp_path / "jax"))
    r = type_family(got, reads_1, reads_2, threads=threads,
                    sam_out=str(tmp_path / "port"), device="cpu")
    assert list(r) == list(w) == ["A", "B", "C"]
    for g in r:
        assert_same_result(r[g], w[g])
        truths = {want.gene(g).allele_names[2], want.gene(g).allele_names[6]}
        assert {a for a, _ in r[g].prob[:2]} == truths
        with open(tmp_path / ("port.%s.sam" % g), "rb") as f_got, \
                open(tmp_path / ("jax.%s.sam" % g), "rb") as f_want:
            assert f_got.read() == f_want.read()


def test_type_family_runlog_maps_a_failing_gene_to_none(trio, tmp_path,
                                                        monkeypatch):
    """With a RunLog, a gene whose typing raises is logged and maps to
    None in both packages; the other genes are typed as without it."""
    _fam, want, got, reads_1, reads_2 = trio

    def failing(real):
        def type_gene(gene, *a, **k):
            if gene.gene == "B":
                raise RuntimeError("gene B fails")
            return real(gene, *a, **k)
        return type_gene

    monkeypatch.setattr(jax_genotype, "type_gene",
                        failing(jax_genotype.type_gene))
    monkeypatch.setattr(genotype, "type_gene", failing(genotype.type_gene))
    logs = {}
    for name, fn, log_cls, cat, kw in (
            ("jax", jax_type_family, JaxRunLog, want, {}),
            ("port", type_family, RunLog, got, dict(device="cpu"))):
        os.makedirs(tmp_path / name)
        log = log_cls(str(tmp_path / name))
        logs[name] = fn(cat, reads_1, reads_2, locus_list=["A", "B"],
                        runlog=log, **kw), log
    (w, w_log), (r, r_log) = logs["jax"], logs["port"]
    assert r["B"] is None and w["B"] is None and list(r) == ["A", "B"]
    assert_same_result(r["A"], w["A"])
    with open(r_log.path) as f:
        text = f.read()
    assert os.path.basename(r_log.path) == os.path.basename(w_log.path)
    assert text.startswith("> Base and Files:hla B\n")
    assert "RuntimeError: gene B fails" in text
    with pytest.raises(RuntimeError, match="gene B fails"):
        type_family(got, reads_1[:30], reads_2[:30], locus_list=["B"],
                    device="cpu")


@pytest.fixture(scope="module")
def duo():
    """tests/test_family.py's 2-gene family and its WGS-style reads:
    gene A reads plus background fragments from the flanks."""
    fam = make_family(genes=("A", "B"), n_alleles=16, length=1600, seed=21)
    want, got = _catalogs(fam)
    genome = fam["genome"]
    rng = random.Random(3)
    a_allele = want.gene("A").allele_names[2]
    rA1, rA2, _ = simulate_reads(want.gene("A"), [a_allele],
                                 simulate_interval=6)
    bg_1, bg_2 = [], []
    for i in range(60):
        p = rng.choice([rng.randrange(0, 2800),
                        rng.randrange(len(genome) - 2900, len(genome) - 350)])
        frag = genome[p:p + 250]
        bg_1.append(("bg%d" % i, frag[:100]))
        bg_2.append(("bg%d" % i, revcomp(frag[-100:])))
    reads_1 = [("a%d" % i, r.seq) for i, r in enumerate(rA1)] + bg_1
    reads_2 = [("a%d" % i, r.seq) for i, r in enumerate(rA2)] + bg_2
    return want, got, reads_1, reads_2


@pytest.mark.parametrize("paired", [True, False])
def test_read_extractor_equals_hgtpu(duo, paired):
    want, got, reads_1, reads_2 = duo
    reads_2 = reads_2 if paired else None
    routed = ReadExtractor({"hla": got}, device="cpu").extract(reads_1,
                                                                reads_2)
    ref = JaxExtractor({"hla": want}).extract(reads_1, reads_2)
    assert routed == ref
    names = {n for n, _ in routed["hla"][0]}
    assert sum(n.startswith("a") for n in names) >= 0.95 * (len(reads_1)
                                                            - 60)
    assert sum(n.startswith("bg") for n in names) <= 2
