"""The port reads and writes the reference's files as hgtpu does.

The text database (``export_text`` / ``import_text``) is the main way a
family crosses into the port from the command line: a database hgtpu
wrote must load into the port equal field for field, and the port's
export of a gene carried across with ``gene_from_fields`` must be
byte-identical to hgtpu's.  The host parsers the command line reads
with (MSF, FASTA/FASTQ, BAM, VCF, UCSC dbSNP) and the small host helpers
it writes with must give equal results on equal inputs.  Exact equality
everywhere.
"""
import dataclasses
import gzip
import os
import random

import pytest

from hgtpu.db import build_catalog_from_msa as jax_build_catalog
from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.db.catalog import Catalog as JaxCatalog
from hgtpu.db.catalog import export_text as jax_export_text
from hgtpu.db.catalog import import_text as jax_import_text
from hgtpu_torch.db import Catalog, gene_from_fields
from hgtpu_torch.db.catalog import export_text, import_text
from tests.synth import make_family, make_gene_msa, make_nuc_msa
from tests.test_torch_db import assert_same_gene
from tests.torch_threads import _torch_threads  # noqa: F401

_DB_FILES = ("_backbone.fa", "_sequences.fa", ".snp", ".index.snp",
             ".snp.freq", ".link", ".haplotype", ".locus", ".allele",
             ".partial")


def _fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def _jax_catalog(case):
    """hgtpu's catalog of one case."""
    if case == "family":
        fam = make_family(genes=("A", "B", "C"), n_alleles=10, length=900,
                          seed=23)
        cat = jax_build_catalog(
            "hla", {g: dict(names=s["names"], rows=s["rows"],
                            ref_allele=s["ref_allele"], exons=s["exons"])
                    for g, s in fam["specs"].items()}, min_var_freq=0.0)
        for g, (left, right) in fam["loci"].items():
            cat.genes[g] = dataclasses.replace(
                cat.genes[g], chrom="chrS", chrom_left=left,
                chrom_right=right)
        return cat
    # one gene with insertions, deletions, grafted partial alleles, a
    # primary exon, and sub-threshold variants (.index.snp differs)
    spec = make_gene_msa(seed=3, n_alleles=40)
    gene, _ = jax_build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"], primary_exon_idx=(1,),
        min_var_freq=8.0, partial_msa=make_nuc_msa(spec))
    assert {0, 1, 2} <= set(gene.var_type.tolist()) and gene.partial
    return JaxCatalog(family="hla", genes={"A": gene})


@pytest.mark.parametrize("case", ["indels_partials", "family"])
def test_export_text_byte_identical(tmp_path, case):
    want = _jax_catalog(case)
    got = Catalog(family=want.family,
                  genes={g: gene_from_fields(_fields(r))
                         for g, r in want.genes.items()})
    jax_export_text(want, str(tmp_path / "h" / "hla"))
    export_text(got, str(tmp_path / "t" / "hla"))
    for suffix in _DB_FILES:
        a = open(tmp_path / "h" / ("hla" + suffix), "rb").read()
        b = open(tmp_path / "t" / ("hla" + suffix), "rb").read()
        assert a == b, suffix
    assert os.path.getsize(tmp_path / "h" / "hla.link") > 0


@pytest.mark.parametrize("case", ["indels_partials", "family"])
def test_import_text_equals_hgtpu(tmp_path, case):
    jax_export_text(_jax_catalog(case), str(tmp_path / "hla"))
    want = jax_import_text("hla", str(tmp_path / "hla"))
    got = import_text("hla", str(tmp_path / "hla"))
    assert type(got) is Catalog
    assert (got.family, got.version) == (want.family, want.version)
    assert list(got.genes) == list(want.genes)
    for g in want.genes:
        assert_same_gene(got.genes[g], want.genes[g])
        for name in want.genes[g].allele_names[::7]:
            assert got.genes[g].allele_seq(name) == \
                want.genes[g].allele_seq(name)
    if case == "indels_partials":
        assert got.genes["A"].partial


# --------------------------------------------------------------------- #
# host parsers and helpers, one case each
# --------------------------------------------------------------------- #
def _reads(n=40, seed=3):
    rng = random.Random(seed)
    return [("r%d/%d" % (i, 1 + i % 2),
             "".join(rng.choice("ACGTN")
                     for _ in range(rng.randint(20, 90))))
            for i in range(n)]


def _write_msf(path, names, rows, width=50):
    with open(path, "w") as f:
        f.write("PileUp\n\n   MSF: %d  Type: N\n\n" % len(rows[0]))
        for name in names:
            f.write(" Name: %s\tLen: %d  Check: 0  Weight: 1.00\n"
                    % (name, len(rows[0])))
        f.write("\n//\n\n")
        for s in range(0, len(rows[0]), width):
            for name, row in zip(names, rows):
                chunk = row[s:s + width]
                f.write("%s %s\n" % (name, " ".join(
                    chunk[k:k + 10] for k in range(0, len(chunk), 10))))
            f.write("\n")


def _case_msf(tmp_path):
    from hgtpu.db.msf import read_msf as want
    from hgtpu_torch.db.msf import read_msf as got

    spec = make_gene_msa(seed=5, n_alleles=12, length=700)
    path = str(tmp_path / "A_gen.msf")
    _write_msf(path, spec["names"], spec["rows"])
    assert got(path) == want(path)
    assert list(got(path)[0]) == spec["names"]
    assert got(path)[1] == spec["rows"]
    lines = open(path).read().splitlines()
    assert got(lines, "NN", "GG") == want(lines, "NN", "GG")


def _case_fastx(tmp_path):
    from hgtpu.utils import io as want
    from hgtpu_torch.utils import io as got

    reads = _reads()
    for suffix in ("fq", "fq.gz"):
        a = str(tmp_path / ("h." + suffix))
        b = str(tmp_path / ("t." + suffix))
        want.write_fastq(reads, a)
        got.write_fastq(reads, b)
        opener = gzip.open if suffix.endswith(".gz") else open
        assert opener(a, "rb").read() == opener(b, "rb").read()
        assert got.read_fastx(a) == want.read_fastx(a) == \
            [(n, s) for n, s in reads]
    for suffix in ("fa", "fa.gz"):
        path = str(tmp_path / ("r." + suffix))
        own = str(tmp_path / ("t." + suffix))
        want.write_fasta_reads(reads, path)
        got.write_fasta_reads(reads, own)
        opener = gzip.open if suffix.endswith(".gz") else open
        assert opener(own, "rb").read() == opener(path, "rb").read()
        assert got.read_fastx(own) == want.read_fastx(path)
    empty = tmp_path / "e.fq"
    empty.write_text("")
    assert got.read_fastx(str(empty)) == want.read_fastx(str(empty)) == []


def _case_bam(tmp_path):
    from hgtpu.utils import bam as want
    from hgtpu.utils.dna import revcomp
    from hgtpu_torch.utils import bam as got

    rng = random.Random(9)
    recs = []
    for k in range(300):
        seq = "".join(rng.choice("ACGT") for _ in range(60))
        nh = 1 if k % 5 else 2
        for mate, flag in ((1, 0x1 | 0x40), (2, 0x1 | 0x80 | 0x10)):
            recs.append({
                "name": "p%d" % k, "flag": flag,
                "rname": "chr6" if k % 7 else "chrX",
                "pos": 100 + 13 * k + (150 if mate == 2 else 0),
                "cigar": [("M", 30), ("D", 2), ("M", 30)],
                "seq": seq if mate == 1 else revcomp(seq),
                "qual": "".join(chr(33 + rng.randint(2, 40))
                                for _ in range(60)),
                "tags": {"NH": ("i", nh), "MD": ("Z", "60"),
                         "AS": ("i", -k % 9), "XS": ("A", "+")}})
    path = str(tmp_path / "s.bam")
    want.write_bam(path, [("chr6", 10000), ("chrX", 5000)], recs,
                   header_text="@HD\tVN:1.6\n")
    assert list(got.read_bam(path)) == list(want.read_bam(path))
    region = ("chr6", 1500, 2500)
    assert list(got.read_bam(path, region)) == \
        list(want.read_bam(path, region))
    for paired in (True, False):
        assert got.reads_from_bam(path, "chr6", 0, 3000, paired=paired) \
            == want.reads_from_bam(path, "chr6", 0, 3000, paired=paired)
    a, b = str(tmp_path / "h.bgzf"), str(tmp_path / "t.bgzf")
    for cls, p in ((want.BgzfWriter, a), (got.BgzfWriter, b)):
        with cls(p) as w:
            w.write(b"ACGT" * 40000)
    assert open(a, "rb").read() == open(b, "rb").read()


def _case_vcf_ucsc(tmp_path):
    from hgtpu.db import clinvar as want
    from hgtpu_torch.db import clinvar as got

    vcf = "\n".join([
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
        "chrS\t11\trs1\tA\tG\t.\t.\tGENEINFO=GENE1:111;CLNSIG=Pathogenic",
        "chrS\t21\trs2\tC\tT\t.\t.\tCLNSIG=Benign",
        "chrS\t61\trs3\tGAA\tG\t.\t.\t.",
        "chrS\t81\trs4\tT\tTTTT\t.\t.\t.",
        "chrS\t90\trs5\tAC\tGT\t.\t.\t.",
        "chr2\t7\trs6\tA\tC,G,N\t.\t.\tCLNSIG=Uncertain",
        "short\tline",
        ""])
    vcf_path = str(tmp_path / "c.vcf.gz")
    with gzip.open(vcf_path, "wt") as f:
        f.write(vcf)
    assert got.read_vcf_variants(vcf_path) == \
        want.read_vcf_variants(vcf_path)
    row = lambda *c: "\t".join(map(str, c))
    txt = "\n".join([
        row(585, "chr1", 100, 101, "rs10", 0, "+", "A", "A", "A/G",
            "genomic", "single"),
        row(585, "chr1", 200, 203, "rs11", 0, "+", "TTT", "TTT", "-/TTT",
            "genomic", "deletion"),
        row(585, "chrM", 50, 50, "rs12", 0, "+", "-", "-", "-/CC",
            "genomic", "insertion"),
        row(585, "chr1", 300, 301, "rs13", 0, "+", "C", "C", "C/T/G",
            "genomic", "single"),
        row(585, "chr1", 400, 401, "rs14", 0, "+", "C", "C", "C/T",
            "genomic", "mnp"),
        ""])
    ucsc = str(tmp_path / "snp144Common.txt")
    open(ucsc, "w").write(txt)
    vars_ = want.read_ucsc_common(ucsc)
    assert got.read_ucsc_common(ucsc) == vars_
    assert got.group_haplotypes(vars_, 50) == \
        want.group_haplotypes(vars_, 50)


def _case_names_fasta(tmp_path):
    from hgtpu.sim import simulate_reads
    from hgtpu.sim.simulator import write_fasta as want_write
    from hgtpu.utils.names import sort_genall as want_sort
    from hgtpu_torch.sim.simulator import write_fasta
    from hgtpu_torch.utils.names import sort_genall

    genes = ["DRB10", "A", "DQB1", "B", "DRB1", "C", "DQA1", "DRB3"]
    alleles = ["A*02:01:01:01", "A*01:01", "A*11:01:01G", "A*01:01:01:02N",
               "A*02:101", "A*01:01:01:01"]
    assert sort_genall(genes) == want_sort(genes)
    assert sort_genall(alleles, alleles=True) == \
        want_sort(alleles, alleles=True)
    assert sort_genall(["x*y:z", "a"], alleles=True) == \
        want_sort(["x*y:z", "a"], alleles=True)
    spec = make_gene_msa(seed=3, n_alleles=6, length=600)
    gene, _ = jax_build_gene_ref("A", spec["names"], spec["rows"],
                                 spec["ref_allele"], min_var_freq=0.0)
    r1, _, _ = simulate_reads(gene, [gene.allele_names[2]],
                              simulate_interval=20)
    want_write(r1, str(tmp_path / "h.fa"))
    write_fasta(r1, str(tmp_path / "t.fa"))
    assert open(tmp_path / "h.fa").read() == open(tmp_path / "t.fa").read()


def _case_manage(tmp_path):
    from hgtpu.db import manage as want
    from hgtpu_torch.db import manage as got

    d = str(tmp_path / "db")
    assert not got.database_exists(d, "hla")
    jax_export_text(_jax_catalog("indels_partials"), d + "/hla")
    assert got.database_exists(d, "hla") and want.database_exists(d, "hla")
    assert got.extract_database_if_not_exists(d, "hla") is False
    with got.dir_lock(d):
        pass
    want.inspect(d + "/hla", str(tmp_path / "h.fa"))
    got.inspect(d + "/hla", str(tmp_path / "t.fa"))
    assert open(tmp_path / "h.fa").read() == open(tmp_path / "t.fa").read()
    with pytest.raises(FileNotFoundError, match="hgtpu_torch.cli.toolkit"):
        got.extract_database_if_not_exists(str(tmp_path / "none"), "hla")
    mirror = str(tmp_path / "mirror")
    got.clone_hisatgenotype_database(mirror, source=d)
    assert got.database_exists(mirror, "hla")
    with pytest.raises(RuntimeError, match="network access unavailable"):
        got.download_genome_and_index(str(tmp_path / "g"), source=None)


def _case_results_batch(tmp_path):
    from hgtpu.tools import batch as want_batch
    from hgtpu.tools import results as want
    from hgtpu_torch.tools import batch as got_batch
    from hgtpu_torch.tools import results as got

    d = tmp_path / "reports"
    d.mkdir()
    (d / "s1.report").write_text(
        "\t\t\t\t1 ranked A*01:01:01 (abundance: 55.10%)\n"
        "\t\t\t\t2 ranked A*02:01 (abundance: 40.00%)\n"
        "\t\t\t\t3 ranked A*03:01 (abundance: 4.90%)\n"
        "\t\t\t\t1 ranked B*07:02 (abundance: 100.00%)\n")
    (d / "s2.report").write_text(
        "\t\t\t*** 1 ranked A*11:01 (abundance: 98.00%)\n")
    (d / "notes.txt").write_text("1 ranked X*01 (abundance: 50.00%)\n")
    assert got.parse_report_dir(str(d)) == want.parse_report_dir(str(d))
    calls = want.parse_report_dir(str(d))
    want.to_csv(calls, str(tmp_path / "h.csv"))
    got.to_csv(calls, str(tmp_path / "t.csv"))
    assert open(tmp_path / "h.csv").read() == \
        open(tmp_path / "t.csv").read()
    for alleles in (["A*01:01:01:01", "A*01:01:01:02"], ["A*01", "B*02"],
                    ["A*01:01"]):
        assert got.collapse_calls(alleles) == want.collapse_calls(alleles)
    rd = tmp_path / "reads"
    rd.mkdir()
    for name in ("NA1.extracted.1.fq.gz", "NA1.extracted.2.fq.gz",
                 "NA2.extracted.1.fq.gz"):
        (rd / name).write_text("")
    assert got_batch.find_samples(str(rd)) == want_batch.find_samples(str(rd))
    kid = [("A*01", 0.5), ("A*02", 0.5)]
    mom, dad = [("A*01", 1.0)], [("A*02", 0.6), ("A*03", 0.4)]
    assert got_batch.top_two(dad) == want_batch.top_two(dad)
    assert got_batch.top_two(mom) == want_batch.top_two(mom)
    for trio in ((kid, mom, dad), (kid, dad, dad), (mom, mom, mom)):
        assert got_batch.trio_concordant(*trio) == \
            want_batch.trio_concordant(*trio)


_MODULE_CASES = {
    "msf": _case_msf,
    "fastx": _case_fastx,
    "bam": _case_bam,
    "vcf_ucsc": _case_vcf_ucsc,
    "names_fasta": _case_names_fasta,
    "manage": _case_manage,
    "results_batch": _case_results_batch,
}


@pytest.mark.parametrize("case", sorted(_MODULE_CASES))
def test_host_module_equals_hgtpu(tmp_path, case):
    _MODULE_CASES[case](tmp_path)
