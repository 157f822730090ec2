"""The port's genotype-genome build and genome-scale extraction equal
hgtpu's.

tests/test_extract_genome.py's two-family fixture (HLA-A and a CYP-like
gene spliced into one synthetic chromosome) goes through both packages:
build_genotype_genome must return equal dicts and write byte-identical
files (with external variants too, which take the clinvar haplotype
grouping), region_gene and liftover must agree, GenomeExtractor (the
checkpointed FM index on the CPU) must route and bin the same reads,
write_block_fastqs the same records under the same names, and type_family
on the routed reads the same calls.  Exact equality everywhere.
"""
import gzip
import os
import random

import numpy as np
import pytest

from hgtpu.db import build_catalog_from_msa as jax_build_catalog
from hgtpu.db.genome import build_genotype_genome as jax_build_genome
from hgtpu.db.genome import liftover as jax_liftover
from hgtpu.db.genome import region_gene as jax_region_gene
from hgtpu.pipeline import type_family as jax_type_family
from hgtpu.pipeline.extract_genome import GenomeExtractor as JaxExtractor
from hgtpu.pipeline.extract_genome import (
    write_block_fastqs as jax_write_blocks)
from hgtpu.sim import simulate_reads
from hgtpu.utils.dna import revcomp
from hgtpu_torch.db import (build_catalog_from_msa, build_genotype_genome,
                            liftover, region_gene)
from hgtpu_torch.pipeline import (GenomeExtractor, type_family,
                                  write_block_fastqs)
from tests.synth import make_family
from tests.test_torch_db import assert_same_gene
from tests.test_torch_slice import assert_same_result
from tests.torch_threads import _torch_threads  # noqa: F401

_FILES = (".fa", ".coord", ".locus", ".snp", ".index.snp", ".haplotype",
          ".link", ".allele", ".partial", ".clnsig")


def _spec(fam, g):
    s = fam["specs"][g]
    return dict(names=s["names"], rows=s["rows"],
                ref_allele=s["ref_allele"], exons=s["exons"],
                primary_exon_idx=s["primary_exon_idx"])


def _placed(build, fam):
    cats = {"hla": build("hla", {"A": _spec(fam, "A")}, min_var_freq=0.0),
            "cyp": build("cyp", {"B": _spec(fam, "B")}, min_var_freq=0.0)}
    for c in cats.values():
        for g, ref in c.genes.items():
            ref.chrom = "chrS"
            ref.chrom_left, ref.chrom_right = fam["loci"][g]
    return cats


def _external(fam):
    """External variants on chrS: some in the flanks (kept, shifted and
    grouped into haplotype windows), one inside locus A (dropped)."""
    left_a = fam["loci"]["A"][0]
    vars_ = [(100, "single", "A", "rs1"), (110, "deletion", "3", "rs2"),
             (200, "insertion", "TT", "rs3"),
             (left_a + 50, "single", "C", "rs4"),
             (len(fam["genome"]) - 500, "single", "G", "rs5")]
    return {"chrS": vars_}, {"rs1": ("GENE1", "Pathogenic"),
                             "rs5": ("GENE2", "Benign")}


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    fam = make_family(genes=("A", "B"), n_alleles=12, length=1500, seed=41)
    want_cats, got_cats = _placed(jax_build_catalog, fam), \
        _placed(build_catalog_from_msa, fam)
    root = tmp_path_factory.mktemp("gg")
    want = jax_build_genome({"chrS": fam["genome"]}, want_cats,
                            str(root / "jax" / "gg"))
    got = build_genotype_genome({"chrS": fam["genome"]}, got_cats,
                                str(root / "port" / "gg"))
    ex_want = JaxExtractor(*want, want_cats)
    ex_got = GenomeExtractor(*got, got_cats, device="cpu")
    return fam, root, want_cats, got_cats, want, got, ex_want, ex_got


@pytest.mark.parametrize("external", [False, True])
def test_build_genotype_genome_equals_hgtpu(wgs, tmp_path, external):
    fam, root, want_cats, got_cats, want, got, _ew, _eg = wgs
    if external:
        ext, clnsig = _external(fam)
        want = jax_build_genome({"chrS": fam["genome"]}, want_cats,
                                str(tmp_path / "jax" / "gg"), ext, clnsig)
        got = build_genotype_genome({"chrS": fam["genome"]}, got_cats,
                                    str(tmp_path / "port" / "gg"), ext,
                                    clnsig)
        root = tmp_path
    assert got == want
    for suffix in _FILES:
        paths = [str(root / side / "gg") + suffix for side in ("jax", "port")]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1]), suffix
        if suffix == ".clnsig":
            assert os.path.exists(paths[0]) == external
        if os.path.exists(paths[0]):
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), suffix
    if external:
        with open(str(root / "port" / "gg.haplotype")) as f:
            text = f.read()
        assert "\trs1,rs2\n" in text and "rs4" not in text


def test_region_gene_and_liftover_equal_hgtpu(wgs):
    _fam, root, _wc, _gc, want, got, _ew, _eg = wgs
    left = got[1][("hla", "A")]
    prefix = {s: str(root / s / "gg") for s in ("jax", "port")}
    r_want = jax_region_gene(prefix["jax"], "chrS", left - 100, left + 900)
    r_got = region_gene(prefix["port"], "chrS", left - 100, left + 900)
    assert type(r_got).__module__ == "hgtpu_torch.db.catalog"
    assert_same_gene(r_got, r_want)
    assert r_got.n_vars > 0
    f_want = jax_liftover(prefix["jax"] + ".coord")
    f_got = liftover(prefix["port"] + ".coord")
    for pos in range(0, len(got[0]["chrS"]), 97):
        assert f_got("chrS", pos) == f_want("chrS", pos)
    assert f_got("chrS", left + 10) is None


def _reads(wgs):
    """Reads of A and B alleles plus background fragments outside both
    loci, as tests/test_extract_genome.py draws them."""
    fam, _root, want_cats, _gc, _w, _g, _ew, _eg = wgs
    a_allele = want_cats["hla"].gene("A").allele_names[4]
    b_allele = want_cats["cyp"].gene("B").allele_names[7]
    rA1, rA2, _ = simulate_reads(want_cats["hla"].gene("A"), [a_allele],
                                 simulate_interval=6, seed=1)
    rB1, rB2, _ = simulate_reads(want_cats["cyp"].gene("B"), [b_allele],
                                 simulate_interval=6, seed=2)
    rng = random.Random(9)
    genome = fam["genome"]
    loci = sorted(fam["loci"].values())
    bg_1, bg_2 = [], []
    for i in range(40):
        while True:
            p = rng.randrange(0, len(genome) - 260)
            if all(p + 250 <= l or p >= r for l, r in loci):
                break
        frag = genome[p:p + 250]
        bg_1.append(("x%d" % i, frag[:100]))
        bg_2.append(("x%d" % i, revcomp(frag[-100:])))
    reads_1 = [("a%d" % i, r.seq) for i, r in enumerate(rA1)] \
        + [("b%d" % i, r.seq) for i, r in enumerate(rB1)] + bg_1
    reads_2 = [("a%d" % i, r.seq) for i, r in enumerate(rA2)] \
        + [("b%d" % i, r.seq) for i, r in enumerate(rB2)] + bg_2
    return a_allele, b_allele, reads_1, reads_2


def test_extract_and_type_equal_hgtpu(wgs):
    _fam, _root, want_cats, got_cats, _w, _g, ex_want, ex_got = wgs
    assert np.array_equal(ex_got.fm._ckpt_dev.numpy(),
                          np.asarray(ex_want.fm._ckpt_dev))
    a_allele, b_allele, reads_1, reads_2 = _reads(wgs)
    routed = ex_got.extract(reads_1, reads_2)
    assert routed == ex_want.extract(reads_1, reads_2)
    assert set(routed) == {"hla", "cyp"}
    assert ex_got.extract(reads_1, None) == ex_want.extract(reads_1, None)
    seqs = [s for _, s in reads_1]
    assert ex_got._place_unique(seqs) == ex_want._place_unique(seqs)
    for fam, truth in (("hla", a_allele), ("cyp", b_allele)):
        got = type_family(got_cats[fam], *routed[fam], device="cpu")
        want = jax_type_family(want_cats[fam], *routed[fam])
        assert list(got) == list(want)
        for g in got:
            assert_same_result(got[g], want[g])
            assert got[g].prob[0][0] == truth


def test_block_binning_equals_hgtpu(wgs, tmp_path):
    fam, _root, _wc, _gc, _w, _g, ex_want, ex_got = wgs
    genome = fam["genome"]
    rng = random.Random(3)
    reads_1, reads_2 = [], []
    for i in range(30):
        p = rng.randrange(0, len(genome) - 260)
        frag = genome[p:p + 250]
        reads_1.append(("r%d" % i, frag[:100]))
        reads_2.append(("r%d" % i, revcomp(frag[-100:])))
    block = 4000
    got = ex_got.extract(reads_1, reads_2, block_size=block)
    want = ex_want.extract(reads_1, reads_2, block_size=block)
    assert got == want and len(got[1]) > 1
    written = {}
    for side, fn in (("jax", jax_write_blocks), ("port", write_block_fastqs)):
        os.makedirs(tmp_path / side)
        paths = fn(str(tmp_path / side), "samp", got[1], block, paired=True)
        written[side] = {}
        for p in paths:
            with gzip.open(p, "rb") as f:
                written[side][os.path.basename(p)] = f.read()
    assert written["port"] == written["jax"]
    assert any(n.endswith("-extracted-1.fq.gz") for n in written["port"])
