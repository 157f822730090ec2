"""The port's command line equals hgtpu's.

``hgtpu_torch.cli.main.main(argv, device="cpu")`` and hgtpu's
``hgtpu.cli.main.main(argv)`` run in process on the same text databases
and reads; every ``.report`` they write must be byte-identical except the
line after ``# COMMAND:`` (the process's own argv), in every mode the
command line has, ``--assembly`` included.  ``--assembly``'s ``.fasta``
and ``.pdf`` files, ``--keep-alignment``'s SAM files and the toolkit's
outputs (every command hgtpu's toolkit has) must be byte-identical too.
The two parsers must register the same flags, defaults, dests and
choices, and map them to equal TypingOptions, and the two toolkits the
same commands.  With no card the port refuses to run unless the CPU is
asked for.  ``python -m hgtpu_torch`` and
``python -m hgtpu_torch.cli.toolkit`` run once each as subprocesses with
HGTPU_TORCH_DEVICE=cpu.
"""
import dataclasses
import gzip
import os
import random
import subprocess
import sys

import pytest
import torch

import hgtpu.cli.main as jax_cli
import hgtpu.cli.toolkit as jax_toolkit
from hgtpu.db import build_catalog_from_msa as jax_build_catalog
from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.db.catalog import Catalog as JaxCatalog
from hgtpu.db.catalog import export_text as jax_export_text
from hgtpu.db.genome import build_genotype_genome as jax_build_genome
from hgtpu.pipeline import type_family as jax_type_family
from hgtpu.sim import simulate_reads
from hgtpu.utils.bam import write_bam as jax_write_bam
from hgtpu.utils.dna import revcomp
from hgtpu.utils.io import write_fastq
import hgtpu_torch
import hgtpu_torch.cli.main as cli
import hgtpu_torch.cli.toolkit as toolkit
from hgtpu_torch.utils.bam import write_bam
from tests.synth import make_family, make_gene_msa, make_nuc_msa
from tests.test_torch_textdb import _write_msf
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fq(reads, path):
    write_fastq([(r.name.replace(" ", "_"), r.seq) for r in reads], path)
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two text databases hgtpu wrote, reads, a BAM, a SAM and a
    genotype genome."""
    root = tmp_path_factory.mktemp("cli")
    p = {"root": root}
    # one gene with indels and grafted partial alleles, placed on chr6
    spec = make_gene_msa(seed=11, n_alleles=20, length=1500)
    gene, _ = jax_build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0,
        partial_msa=make_nuc_msa(spec, n_partial=3))
    gene = dataclasses.replace(gene, chrom="chr6", chrom_left=20000,
                               chrom_right=20000 + len(gene.backbone) - 1)
    assert gene.partial
    p["gene_db"] = str(root / "gene")
    jax_export_text(JaxCatalog(family="hla", genes={"A": gene}),
                    p["gene_db"] + "/hla")
    truth = next(a for a in gene.allele_names[6:] if a not in gene.partial)
    p["truth"] = truth
    r1, r2, _ = simulate_reads(gene, [truth], simulate_interval=4, seed=1)
    p["s1"] = _fq(r1, str(root / "s.1.fq"))
    p["s2"] = _fq(r2, str(root / "s.2.fq"))
    p["u"] = _fq(r1, str(root / "u.fq"))
    recs = []
    for k, (a, b) in enumerate(zip(r1, r2)):
        pos = gene.chrom_left + (k * 3) % (len(gene.backbone) - 250)
        recs.append({"name": "rd%d" % k, "flag": 0x1 | 0x40,
                     "rname": "chr6", "pos": pos,
                     "cigar": [("M", len(a.seq))], "seq": a.seq,
                     "qual": "I" * len(a.seq), "tags": {"NH": ("i", 1)}})
        recs.append({"name": "rd%d" % k, "flag": 0x1 | 0x80 | 0x10,
                     "rname": "chr6", "pos": pos + 150,
                     "cigar": [("M", len(b.seq))], "seq": revcomp(b.seq),
                     "qual": "I" * len(b.seq), "tags": {"NH": ("i", 1)}})
    # hgtpu's CLI reads the BAM hgtpu wrote, the port's the one it wrote
    # (same name: the report is named after it)
    p["bam"] = str(root / "sample.bam")
    os.makedirs(str(root / "port"))
    p["bam_port"] = str(root / "port" / "sample.bam")
    jax_write_bam(p["bam"], [("chr6", 60000)], recs)
    write_bam(p["bam_port"], [("chr6", 60000)], recs)
    assert open(p["bam_port"], "rb").read() == open(p["bam"], "rb").read()
    # a three-gene family on chrS (the panel router), its genome
    fam = make_family(genes=("A", "B", "C"), n_alleles=8, length=900,
                      seed=13)
    p["fam"] = fam
    cat = jax_build_catalog(
        "hla", {g: dict(names=s["names"], rows=s["rows"],
                        ref_allele=s["ref_allele"], exons=s["exons"])
                for g, s in fam["specs"].items()}, min_var_freq=0.0)
    for g, (left, right) in fam["loci"].items():
        cat.genes[g].chrom = "chrS"
        cat.genes[g].chrom_left = left
        cat.genes[g].chrom_right = right
    p["fam_db"] = str(root / "fam")
    jax_export_text(cat, p["fam_db"] + "/hla")
    p["genome_fa"] = str(root / "genome.fa")
    with open(p["genome_fa"], "w") as f:
        f.write(">chrS\n%s\n" % fam["genome"])
    p["gg"] = p["fam_db"] + "/gg"
    _, offsets = jax_build_genome({"chrS": fam["genome"]}, {"hla": cat},
                                  p["gg"])
    base = offsets[("hla", "A")]
    p["region"] = "chrS:%d-%d" % (base, base + len(cat.genes["A"].backbone))
    f1, f2 = [], []
    for g, ref in cat.genes.items():
        a1, a2, _ = simulate_reads(ref, [ref.allele_names[3]],
                                   simulate_interval=8, seed=4)
        f1 += [(g + r.name.replace(" ", "_"), r.seq) for r in a1]
        f2 += [(g + r.name.replace(" ", "_"), r.seq) for r in a2]
    p["f1"], p["f2"] = str(root / "f.1.fq"), str(root / "f.2.fq")
    write_fastq(f1, p["f1"])
    write_fastq(f2, p["f2"])
    jax_type_family(cat, f1, f2, locus_list=["A"],
                    sam_out=str(root / "aln"))
    p["sam"] = str(root / "aln.A.sam")
    return p


def _gene(p):
    return ["--base", "hla", "--ix-dir", p["gene_db"]]


def _fam(p):
    return ["--base", "hla", "--ix-dir", p["fam_db"]]


MODES = {
    "simulation": lambda p: _gene(p) + [
        "--locus-list", "A", "--debug", "basic,test_size:2,set_seed:101",
        "--simulate-interval", "5"],
    "paired": lambda p: _fam(p) + ["-1", p["f1"], "-2", p["f2"]],
    "single_U": lambda p: _gene(p) + ["-U", p["u"]],
    "alignment": lambda p: _fam(p) + [
        "--locus-list", "A", "--alignment-file", p["sam"]],
    "bamfile": lambda p: _gene(p) + ["--bamfile", p["bam"]],
    "region_list": lambda p: [
        "--ix-dir", p["fam_db"], "--region-list", "hla.B,hla.C",
        "-1", p["f1"], "-2", p["f2"]],
    "genome": lambda p: [
        "--reference-type", "genome", "-x", p["gg"],
        "--locus-list", p["region"], "-1", p["f1"], "-2", p["f2"]],
    "bowtie2": lambda p: _gene(p) + [
        "--aligner", "bowtie2", "-1", p["s1"], "-2", p["s2"]],
    "only_locus_list": lambda p: _fam(p) + [
        "--only-locus-list", "B", "-1", p["f1"], "-2", p["f2"]],
    "no_partial": lambda p: _gene(p) + [
        "--no-partial", "-1", p["s1"], "-2", p["s2"]],
    "exclude_allele_list": lambda p: _gene(p) + [
        "--exclude-allele-list", p["truth"], "-1", p["s1"], "-2", p["s2"]],
    "assembly_simulation": lambda p: MODES["simulation"](p) + ["--assembly"],
    "assembly_paired": lambda p: MODES["paired"](p) + ["--assembly"],
}


def _report_lines(path):
    """The report's lines without the one after `# COMMAND:` (argv)."""
    lines = open(path).read().split("\n")
    i = lines.index("# COMMAND:")
    return lines[:i + 1] + lines[i + 2:]


def _run_both(argv, out, port_argv=None):
    """hgtpu's and the port's CLI in process (the port's on `port_argv`
    when given); (rc, rc, hgtpu's dir, the port's dir)."""
    h, t = str(out / "h"), str(out / "t")
    rc_h = jax_cli.main(argv + ["--out-dir", h])
    rc_t = cli.main((port_argv or argv) + ["--out-dir", t], device="cpu")
    return rc_h, rc_t, h, t


def _assert_same_reports(h, t):
    names = sorted(f for f in os.listdir(h) if f.endswith(".report"))
    assert names and names == sorted(
        f for f in os.listdir(t) if f.endswith(".report"))
    for name in names:
        assert _report_lines(os.path.join(t, name)) == \
            _report_lines(os.path.join(h, name)), name
    return names


def _assert_same_files(h, t, suffix):
    """Every `suffix` file of hgtpu's run, byte for byte in the port's."""
    names = sorted(f for f in os.listdir(h) if f.endswith(suffix))
    assert names and names == sorted(
        f for f in os.listdir(t) if f.endswith(suffix))
    for name in names:
        want = open(os.path.join(h, name), "rb").read()
        assert open(os.path.join(t, name), "rb").read() == want, name
    return names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reports_equal_hgtpu(inputs, tmp_path, mode):
    port_argv = None
    if mode == "bamfile":                   # the BAM the port wrote
        port_argv = _gene(inputs) + ["--bamfile", inputs["bam_port"]]
    rc_h, rc_t, h, t = _run_both(MODES[mode](inputs), tmp_path, port_argv)
    assert rc_h == rc_t == 0
    names = _assert_same_reports(h, t)
    text = open(os.path.join(t, names[0])).read()
    assert "ranked" in text
    if mode in ("simulation", "assembly_simulation"):
        assert len(names) == 2 and "*** 1 ranked" in text
    if mode.startswith("assembly"):
        # the contigs and the assembly plots, one per report and gene
        fastas = _assert_same_files(h, t, ".fasta")
        pdfs = _assert_same_files(h, t, ".pdf")
        assert len(fastas) == len(names)
        assert len(pdfs) == len(names) * (3 if mode.endswith("paired")
                                          else 1)
        for name in pdfs:
            data = open(os.path.join(t, name), "rb").read()
            assert data.startswith(b"%PDF") and data.endswith(b"%%EOF\n")
        for name in names:
            text = open(os.path.join(t, name)).read()
            calls = text.split("Assembly Coloring Allele Collapse:")[1]
            assert "Group score: 1.00000" in calls and "NONE" not in calls
    if mode in ("bowtie2", "no_partial"):
        assert "1 ranked %s (abundance:" % inputs["truth"] in text
    if mode == "exclude_allele_list":
        assert inputs["truth"] not in text
    if mode == "only_locus_list":
        assert "B*" in text and "A*" not in text


def test_keep_alignment_sam_equal(inputs, tmp_path):
    argv = _fam(inputs) + ["-1", inputs["f1"], "-2", inputs["f2"],
                           "--keep-alignment"]
    rc_h, rc_t, h, t = _run_both(argv, tmp_path)
    assert rc_h == rc_t == 0
    _assert_same_reports(h, t)
    sams = _assert_same_files(h, t, ".sam")
    assert len(sams) == 3
    for name in sams:
        assert open(os.path.join(t, name), "rb").read().count(b"\n") > 10


# --------------------------------------------------------------------- #
# toolkit
# --------------------------------------------------------------------- #
def _tree(d):
    """{relative path: bytes} of every file under d, gzip members
    decompressed (their headers carry the write time)."""
    out = {}
    for dirpath, _dirs, files in os.walk(d):
        for f in files:
            path = os.path.join(dirpath, f)
            data = open(path, "rb").read()
            if f.endswith(".gz"):
                data = gzip.decompress(data)
            out[os.path.relpath(path, d)] = data
    return out


def _tk_extract_vars(p, out):
    msf = out / "msf"
    msf.mkdir()
    for g, s in p["fam"]["specs"].items():
        _write_msf(str(msf / ("%s_gen.msf" % g)), s["names"], s["rows"])
    return ["extract-vars", "--msf-dir", str(msf), "--base", "hla",
            "--min-var-freq", "0.1", "--locus-list", "A,C"], "--ix-dir"


def _tk_extract_reads_panel(p, out):
    return ["extract-reads", "--database-list", "hla", "--ix-dir",
            p["fam_db"], "-1", p["f1"], "-2", p["f2"], "--suffix",
            "fq"], "--out-dir"


def _tk_extract_reads_genome(p, out):
    return ["extract-reads", "--database-list", "hla", "--ix-dir",
            p["fam_db"], "-x", p["gg"], "-1", p["f1"], "-2", p["f2"],
            "--suffix", "fq"], "--out-dir"


def _tk_parse_results(p, out):
    reports = out / "reports"
    assert jax_cli.main(MODES["simulation"](p)
                        + ["--out-dir", str(reports)]) == 0
    return ["parse-results", "--in-dir", str(reports), "--csv"], "csv"


def _tk_inspect(p, out):
    return ["inspect", p["gene_db"] + "/hla", "-o"], "file"


def _tk_build_genome(p, out):
    vcf = str(out / "clinvar.vcf")
    g = p["fam"]["genome"]
    with open(vcf, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, alt in ((11, "G"), (21, "T"), (len(g) - 9, "C")):
            f.write("chrS\t%d\trs%d\t%s\t%s\t.\t.\tCLNSIG=Benign\n"
                    % (pos, pos, g[pos - 1], alt))
    return ["build-genome", "--genome", p["genome_fa"], "--database-list",
            "hla", "--ix-dir", p["fam_db"], "--clinvar", vcf], "--out-dir"


def _tk_extract_codis_data(p, out):
    from tests.test_torch_tools import HTML

    pages = out / "pages"
    pages.mkdir()
    (pages / "str_D18S51.htm").write_text(HTML)
    return ["extract-codis-data", "--html-dir", str(pages), "--locus-list",
            "D18S51,FGA"], "dat"


def _tk_convert_codis(p, out):
    from tests.test_tools import _flanks

    f5, f3 = _flanks(7, 300)
    dat = out / "codis.dat"
    dat.write_text("".join("D3S1358\t%d\t[TCTA]%d\n" % (n, n)
                           for n in (14, 15, 16, 17))
                   + "D18S51\t14.2\t[AGAA]13 GA [AGAA]1\n"
                   + "D18S51\t13\t[AGAA]13\n")
    freqs = out / "freq.tsv"
    freqs.write_text("D3S1358\t14\t0.10\nD3S1358\t15\t0.30\n"
                     "D3S1358\t16\t0.005\nD3S1358\t17\t0.20\n"
                     "D18S51\t14.2\t0.05\nD18S51\t13\t0.2\n")
    return ["convert-codis", "--base", "codis", "--dat", str(dat),
            "--freq-table", str(freqs), "--min-freq", "0.01",
            "--flank5", f5, "--flank3", f3], "--ix-dir"


def _tk_extract_rbg(p, out):
    from tests.test_cli import _rbg_variants
    from tests.test_tools import _genbank_record

    rng = random.Random(21)
    seq = "".join(rng.choice("ACGT") for _ in range(1200))
    exons = [(41, 400), (501, 1100)]
    gb = out / "gypb.gb"
    gb.write_text("\n".join(
        _genbank_record("RB%03d" % k, "GYPB", s, exons)
        for k, s in enumerate(_rbg_variants(seq, rng))) + "\n")
    return ["extract-rbg", "--base", "rbg", "--genbank", str(gb)], \
        "--ix-dir"


def _tk_compare(p, out):
    from tests.test_torch_tools import CALLS, TRUTH

    calls, truth = out / "calls.tsv", out / "truth.tsv"
    calls.write_text("\n".join(CALLS) + "\n")
    truth.write_text("\n".join(TRUTH) + "\n")
    return ["compare", str(calls), str(truth), "--genes", "A"], "stdout"


TOOLKIT = {
    "extract_vars": _tk_extract_vars,
    "extract_reads_panel": _tk_extract_reads_panel,
    "extract_reads_genome": _tk_extract_reads_genome,
    "parse_results": _tk_parse_results,
    "inspect": _tk_inspect,
    "build_genome": _tk_build_genome,
    "extract_codis_data": _tk_extract_codis_data,
    "convert_codis": _tk_convert_codis,
    "extract_rbg": _tk_extract_rbg,
    "compare": _tk_compare,
}


@pytest.mark.parametrize("command", sorted(TOOLKIT))
def test_toolkit_outputs_equal_hgtpu(inputs, tmp_path, capsys, command):
    argv, where = TOOLKIT[command](inputs, tmp_path)
    outputs = {}
    for side, run in (("h", jax_toolkit.main),
                      ("t", lambda a: toolkit.main(a, device="cpu"))):
        d = tmp_path / side
        d.mkdir()
        if where == "csv":
            a = argv + [str(d / "calls.csv")]
        elif where == "file":
            a = argv + [str(d / "inspect.fa")]
        elif where == "dat":
            a = argv + ["--base", str(d / "codis")]
        elif where == "stdout":
            a = argv
        else:
            a = argv + [where, str(d)]
        capsys.readouterr()
        assert run(a) == 0
        outputs[side] = (_tree(d), capsys.readouterr().out)
    files, stdout = outputs["h"]
    assert outputs["t"] == (files, stdout)
    if where == "stdout":
        assert not files and "Level: 1" in stdout
    else:
        assert any(files.values())
    if command == "parse_results":
        assert stdout.startswith("assembly_graph-hla.test-1\tA\t")
    if command == "convert_codis":
        # --min-freq dropped the rare allele
        text = files["codis.allele"].decode()
        assert "D3S1358*16" not in text and "D3S1358*17" in text


def test_toolkit_samples_and_hla_cyp_equal_hgtpu(inputs, tmp_path, capsys):
    """`samples` (the batch runner on the port's type_family) and
    `hla-cyp` print what hgtpu's print."""
    rd = tmp_path / "reads"
    rd.mkdir()
    for sample in ("NA1", "NA2"):
        for mate in ("1", "2"):
            src = inputs["s%s" % mate]
            with open(src, "rb") as f, \
                    gzip.open(rd / ("%s.extracted.%s.fq.gz" % (sample, mate)),
                              "wb") as g:
                g.write(f.read())
    runs = [["samples", "--base", "hla", "--ix-dir", inputs["gene_db"],
             "--read-dir", str(rd), "--pp", "2"],
            ["hla-cyp", "--base", "hla", "--ix-dir", inputs["gene_db"],
             "--allele-list", inputs["truth"], "--simulate-interval", "8",
             "--aligner-list", "hisat2.graph,bowtie2.linear"]]
    for argv in runs:
        capsys.readouterr()
        rc_h = jax_toolkit.main(argv)
        want = capsys.readouterr().out
        rc_t = toolkit.main(argv, device="cpu")
        assert (rc_t, capsys.readouterr().out) == (rc_h, want)
        assert rc_h == 0 and want


# --------------------------------------------------------------------- #
# flag tables
# --------------------------------------------------------------------- #
def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                   a.choices and tuple(a.choices), a.nargs, a.const,
                   getattr(a.type, "__name__", None), type(a).__name__)
                  for a in parser._actions)


def test_parsers_register_equal_actions():
    assert _actions(cli.build_parser()) == _actions(jax_cli.build_parser())
    assert len(cli.build_parser()._actions) > 40


def test_reference_flag_registry_complete():
    """Every flag of hgtpu's CLI sources is registered in the port's."""
    import re

    def flags(pkg):
        d = os.path.join(ROOT, pkg, "cli")
        src = "".join(open(os.path.join(d, f)).read()
                      for f in os.listdir(d) if f.endswith(".py"))
        return set(re.findall(r'"--([a-zA-Z0-9_-]+)"', src))

    want = flags("hgtpu")
    assert {"assembly", "region-list", "bamfile", "min-freq", "clinvar",
            "novel_allele_detection", "platinum-check", "html-dir",
            "download", "dat", "freq-table", "flank5", "flank3", "genbank",
            "genes"} <= want
    assert want - flags("hgtpu_torch") == set()


def test_toolkit_commands_equal_hgtpu(capsys):
    """The port's toolkit has hgtpu's commands, in hgtpu's order, and
    every one of them parses its --help."""
    assert list(toolkit.COMMANDS) == list(jax_toolkit.COMMANDS)
    assert not hasattr(toolkit, "UNPORTED")
    for cmd in toolkit.COMMANDS:
        with pytest.raises(SystemExit) as e:
            toolkit.main([cmd, "--help"], device="cpu")
        assert e.value.code == 0
    assert toolkit.main(["no-such-command"], device="cpu") == 1


def test_flag_behavior_table():
    """typing_options_from_args gives equal TypingOptions, field for
    field, over hgtpu's flag table (tests/test_options.py)."""
    cases = [[], ["--num-editdist", "3"], ["--discordant"],
             ["--no-error-correction"], ["--assembly"], ["--best-alleles"],
             ["--type-primary-exons"], ["--keep-low-abundance-alleles"],
             ["--display-alleles", "A*01:01,A*02"], ["--aligner", "bowtie2"],
             ["--linear-index"], ["--strict-pair-distance"],
             ["--base", "codis"], ["--num-mismatch", "4"],
             ["--device-typing", "on"], ["--device-typing", "off"],
             ["--output-allele-counts"], ["-1", "r1.fq", "-2", "r2.fq"],
             ["-U", "r.fq"]]
    debugs = [None, {"single-end": True}, {"basic": True}]
    for argv in cases:
        for debug in debugs:
            want = jax_cli.typing_options_from_args(
                jax_cli.build_parser().parse_args(argv), debug)
            got = cli.typing_options_from_args(
                cli.build_parser().parse_args(argv), debug)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (argv, debug)


# --------------------------------------------------------------------- #
# the device: no silent CPU; the module entries
# --------------------------------------------------------------------- #
def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k != cli.DEVICE_ENV}
    env.update(PYTHONPATH=ROOT, **kw)
    return env


def test_no_card_refuses_without_cpu_request(inputs, tmp_path, capsys,
                                             monkeypatch):
    from hgtpu_torch.db.catalog import import_text
    from hgtpu_torch.pipeline import type_reads

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default")
    with pytest.raises(RuntimeError, match="HGTPU_TORCH_DEVICE=cpu"):
        hgtpu_torch.default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hgtpu_torch.resolve_device(None)
    gene = import_text("hla", inputs["gene_db"] + "/hla").genes["A"]
    reads = [("r1", "ACGT" * 25)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        type_reads(gene, reads, reads)
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    argv = MODES["simulation"](inputs) + ["--out-dir", str(tmp_path / "o")]
    assert cli.main(argv) != 0
    assert toolkit.main(["extract-reads", "--database-list", "hla",
                         "--ix-dir", inputs["fam_db"], "-1", inputs["f1"],
                         "--out-dir", str(tmp_path)]) != 0
    assert capsys.readouterr().err.count("HGTPU_TORCH_DEVICE=cpu") == 2
    assert not os.path.exists(tmp_path / "o")
    proc = subprocess.run([sys.executable, "-m", "hgtpu_torch"] + argv,
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "HGTPU_TORCH_DEVICE=cpu" in proc.stderr
    assert not os.path.exists(tmp_path / "o")
    # the CPU runs where it is asked for, by the environment
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    assert cli.main(argv) == 0


def test_module_entries_run_on_the_cpu(inputs, tmp_path):
    """`python -m hgtpu_torch` with HGTPU_TORCH_DEVICE=cpu writes
    hgtpu's reports, and `python -m hgtpu_torch.cli.toolkit
    parse-results` reads them as hgtpu's toolkit does."""
    argv = _gene(inputs) + ["--locus-list", "A", "--debug",
                            "basic,test_size:1,set_seed:7",
                            "--simulate-interval", "5"]
    h, t = tmp_path / "h", tmp_path / "t"
    assert jax_cli.main(argv + ["--out-dir", str(h)]) == 0
    run = dict(cwd=ROOT, env=_env(HGTPU_TORCH_DEVICE="cpu"),
               capture_output=True, text=True, timeout=300)
    proc = subprocess.run([sys.executable, "-m", "hgtpu_torch"] + argv
                          + ["--out-dir", str(t)], **run)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Passed so far: 1/1" in proc.stderr
    _assert_same_reports(str(h), str(t))
    proc = subprocess.run(
        [sys.executable, "-m", "hgtpu_torch.cli.toolkit", "parse-results",
         "--in-dir", str(t), "--csv", str(tmp_path / "t.csv")], **run)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert jax_toolkit.main(["parse-results", "--in-dir", str(h), "--csv",
                             str(tmp_path / "h.csv")]) == 0
    assert open(tmp_path / "t.csv").read() == \
        open(tmp_path / "h.csv").read()
    assert "A*" in proc.stdout
