"""The port's tools equal hgtpu's.

Every test of tests/test_tools.py that reaches ``tools/codis.py``,
``codis_fetch.py``, ``rbg.py``, ``compare.py``, ``call_variants.py``,
``starallele.py`` or ``legacy.py`` runs here through both packages on the
same inputs: the tables, alignments and calls must be equal and the files
byte-identical.  Typing runs on the CPU (``device="cpu"``), each side on
its own package's gene.
"""
import dataclasses
import random

import pytest

from hgtpu.db import build_gene_ref as jax_build_gene_ref
from hgtpu.pipeline import type_reads as jax_type_reads
from hgtpu.sim import simulate_reads
from hgtpu.tools import (call_variants as jax_cv, codis as jax_codis,
                         codis_fetch as jax_fetch, compare as jax_compare,
                         rbg as jax_rbg, starallele as jax_star)
from hgtpu.typer.engine import TypingOptions as JaxOptions
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.tools import (call_variants, codis, codis_fetch, compare,
                               rbg, starallele)
from hgtpu_torch.typer.engine import TypingOptions
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.test_tools import _flanks, _genbank_record
from tests.torch_threads import _torch_threads  # noqa: F401


def _pairs(reads):
    return [(r.name, r.seq) for r in reads]


def _same_result(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


STRUCTURES = ["[TCTA]3 TCA [TCTG]2", "[AGAA]13 GA [AGAA]1", "[AGAA]10",
              "[TCTA]11[TCTG]11", "TCA"]


def test_parse_structure_equals_hgtpu():
    for s in STRUCTURES:
        assert codis.parse_structure(s) == jax_codis.parse_structure(s)
    assert codis.parse_structure(STRUCTURES[0]) == \
        [("TCTA", 3), ("TCA", 1), ("TCTG", 2)]


def test_codis_end_to_end_equals_hgtpu():
    f5, f3 = _flanks(5)
    table = [("D18S51*10", "[AGAA]10"), ("D18S51*12", "[AGAA]12"),
             ("D18S51*13", "[AGAA]13"),
             ("D18S51*14.2", "[AGAA]13 GA [AGAA]1"),
             ("D18S51*16", "[AGAA]16")]
    names, rows = codis.codis_msa(table, f5, f3)
    assert (names, rows) == jax_codis.codis_msa(table, f5, f3)
    kw = dict(min_var_freq=0.0, collapse=False, leftshift=False)
    want_ref, _ = jax_build_gene_ref("D18S51", names, rows, names[0], **kw)
    ref, _ = build_gene_ref("D18S51", names, rows, names[0], **kw)
    for name, _s in table:
        assert ref.allele_seq(name) == want_ref.allele_seq(name)
    r1, r2, _ = simulate_reads(want_ref, ["D18S51*13"], simulate_interval=2,
                               frag_len=300)
    want = jax_type_reads(want_ref, _pairs(r1), _pairs(r2),
                          JaxOptions(family="codis", simulation=True))
    got = type_reads(ref, _pairs(r1), _pairs(r2),
                     TypingOptions(family="codis", simulation=True),
                     device="cpu")
    _same_result(got, want)
    assert got.prob[0][0] == "D18S51*13"


def test_codis_microvariant_equals_hgtpu():
    """The x.2 microvariant's junction reads (four equal-cost STR
    spellings) type as in hgtpu."""
    f5, f3 = _flanks(7, 350)
    table = [("D18S51*10", "[AGAA]10"), ("D18S51*13", "[AGAA]13"),
             ("D18S51*14.2", "[AGAA]13 GA [AGAA]1"),
             ("D18S51*16", "[AGAA]16")]
    names, rows = codis.codis_msa(table, f5, f3)
    assert (names, rows) == jax_codis.codis_msa(table, f5, f3)
    kw = dict(min_var_freq=0.0, collapse=False, leftshift=False)
    want_ref, _ = jax_build_gene_ref("D18S51", names, rows, names[0], **kw)
    allele = "D18S51*14.2"
    r1, r2, _ = simulate_reads(want_ref, [allele], simulate_interval=2,
                               frag_len=300)
    want = jax_type_reads(want_ref, _pairs(r1), _pairs(r2),
                          JaxOptions(family="codis", simulation=True))
    got = type_reads(carried(want_ref), _pairs(r1), _pairs(r2),
                     TypingOptions(family="codis", simulation=True),
                     device="cpu")
    _same_result(got, want)
    assert got.prob[0][0] == allele


def test_codis_repeat_aware_merge_equals_hgtpu():
    table = [("X*1", "[TCTA]4 [TCTG]3"), ("X*2", "[TCTA]4 TCA [TCTG]5"),
             ("X*3", "[TCTA]2 GTA [TCTG]3")]
    structs = [codis.parse_structure(s) for _, s in table]
    backbone = codis.merge_structures(structs)
    assert backbone == jax_codis.merge_structures(
        [jax_codis.parse_structure(s) for _, s in table])
    assert [sorted(u) for u, _ in backbone] == \
        [["TCTA"], ["GTA", "TCA"], ["TCTG"]]
    assert codis.codis_msa(table) == jax_codis.codis_msa(table)


HTML = """
<html><body><table>
<tr><th>Allele</th><th width="35%">Repeat Structure</th></tr>
<tr><td align="center"><font size="4">9 </font></td>
    <td><font size="2">[AGAA]<sub>9</sub></font> </td></tr>
<tr><td>commentary row with no structure</td><td>see note</td></tr>
<tr><td><font>14.2&nbsp;</font></td>
    <td>[AGAA]<sub>13</sub> GA&nbsp;[AGAA]<sub>1</sub></td></tr>
<tr><td>22&quot;</td><td>[TCTA]<sub>11</sub>[TCTG]<sub>11</sub></td></tr>
</table></body></html>
"""


def test_strbase_html_fetch_equals_hgtpu(tmp_path):
    assert codis_fetch.parse_strbase_html(HTML) == \
        jax_fetch.parse_strbase_html(HTML)
    d = tmp_path / "pages"
    d.mkdir()
    (d / "str_D18S51.htm").write_text(HTML)
    outs = {}
    for side, mod in (("h", jax_fetch), ("t", codis_fetch)):
        out = tmp_path / ("%s.dat" % side)
        n = mod.extract_codis_data(str(out), mod.dir_source(str(d)),
                                   ["D18S51", "FGA"])
        outs[side] = (n, out.read_bytes(), mod.read_codis_dat(str(out)))
    assert outs["t"] == outs["h"]
    assert outs["t"][0] == 3
    table = outs["t"][2]["D18S51"]
    assert codis.codis_msa([("D18S51*" + a, s) for a, s in table],
                           "ACGT", "TTAA") == \
        jax_codis.codis_msa([("D18S51*" + a, s) for a, s in table],
                            "ACGT", "TTAA")


def test_star_allele_conversion_equals_hgtpu():
    rng = random.Random(8)
    refseq = "".join(rng.choice("ACGT") for _ in range(1200))
    specs = {"CYP2D6*1": "",
             "CYP2D6*2": "%d%s>%s" % (100, refseq[100],
                                      "A" if refseq[100] != "A" else "C"),
             "CYP2D6*3": "500del2", "CYP2D6*4": "700insGT"}
    events = {n: starallele.parse_events(s) if s else []
              for n, s in specs.items()}
    assert events == {n: jax_star.parse_events(s) if s else []
                      for n, s in specs.items()}
    got = starallele.msa_from_variant_table(refseq, events)
    assert got == jax_star.msa_from_variant_table(refseq, events)
    assert len({len(r) for r in got[1]}) == 1
    bad = {"X*1": [("S", 10, "A" if refseq[10] != "A" else "C", "G")]}
    for mod in (starallele, jax_star):
        with pytest.raises(AssertionError):
            mod.msa_from_variant_table(refseq, bad)


def test_cyp_offset_sliding_equals_hgtpu(tmp_path):
    rng = random.Random(3)
    refseq = "".join(rng.choice("ACGT") for _ in range(400))
    true_off = 150

    def base(p):
        return refseq[p + (true_off if p > 0 else true_off + 1)]

    rows = [("CYP9Z9*1", ""),
            ("CYP9Z9*2", "10%s>G;-30%s>T" % (base(10), base(-30))),
            ("CYP9Z9*3", "20_22del%s%s%s" % (base(20), base(21), base(22))),
            ("CYP9Z9*4", "40insTTA")]
    events = {n: starallele.parse_cyp_events(s) for n, s in rows}
    assert events == {n: jax_star.parse_cyp_events(s) for n, s in rows}
    found = starallele.find_cyp_offset(refseq, events)
    assert found == jax_star.find_cyp_offset(refseq, events)
    assert found[:2] == (true_off, true_off + 1)
    path = tmp_path / "cyp.tsv"
    path.write_text("".join("%s\t%s\n" % r for r in rows))
    assert starallele.convert_cyp_table(str(path), refseq) == \
        jax_star.convert_cyp_table(str(path), refseq)
    bad_path = tmp_path / "bad.tsv"
    bad_path.write_text("X*2\t10A>G;11A>G;12A>G;13A>G\n")
    if all(refseq[10 + true_off + i] != "A" for i in range(4)):
        for mod in (starallele, jax_star):
            with pytest.raises(ValueError):
                mod.convert_cyp_table(str(bad_path), refseq)


def test_rbg_genbank_ingestion_equals_hgtpu(tmp_path):
    rng = random.Random(9)
    seq = "".join(rng.choice("ACGT") for _ in range(360))
    exons = [(31, 90), (151, 240)]
    alt = "G" if seq[60] != "G" else "T"
    seq2 = seq[:60] + alt + seq[61:200] + seq[202:]
    gb = tmp_path / "gypa.gb"
    gb.write_text(_genbank_record("RBG001", "GYPA", seq, exons) + "\n"
                  + _genbank_record("RBG002", "GYPA", seq2, exons) + "\n")
    text = gb.read_text()
    assert rbg.split_records(text) == jax_rbg.split_records(text)
    recs = [rbg.parse_record(r) for r in rbg.split_records(text)]
    assert recs == [jax_rbg.parse_record(r)
                    for r in jax_rbg.split_records(text)]
    assert recs[0]["genes"]["GYPA"] == (10, 350)
    got = rbg.convert_rbg_genbank([str(gb)], "GYPA")
    assert got == jax_rbg.convert_rbg_genbank([str(gb)], "GYPA")
    assert got[0] == ["GYPA*RBG001", "GYPA*RBG002"]


CALLS = ["s1\tA*01:01:01\t0.6", "s1\tA*02:05\t0.4", "s2\tA*03:01\t0.9",
         "s2\tA*11:01\t0.05", "s3\tA*24:02\t0.5", "s3\tA*29:01\t0.3",
         "s3\tA*26:08\t0.2"]
TRUTH = ["s1\tA*01:01", "s2\tA*03:01", "s2\tA*11:01", "s3\tA*26:08",
         "s3\tA*24:02"]


def test_compare_hla_concordance_equals_hgtpu():
    got = compare.compare_tables(CALLS, TRUTH, levels=(1, 2), genes=("A",))
    want = jax_compare.compare_tables(CALLS, TRUTH, levels=(1, 2),
                                      genes=("A",))
    assert {lv: {g: dataclasses.asdict(c) for g, c in per.items()}
            for lv, per in got.items()} == \
        {lv: {g: dataclasses.asdict(c) for g, c in per.items()}
         for lv, per in want.items()}
    assert got[2]["A"].top2 == [0, 1, 2]
    assert compare.format_report(got) == jax_compare.format_report(want)


def test_compare_level_collapse_equals_hgtpu():
    rows = ["s\tA*01:01:01\t0.30", "s\tA*01:01:02\t0.45", "s\tA*02:01\t0.25"]
    for level in (1, 2, 3):
        assert compare.read_typing_table(rows, level=level) == \
            jax_compare.read_typing_table(rows, level=level)
    assert compare.read_typing_table(rows, level=2)["s"]["A"][0] == \
        ["01:01", 0.75]


def test_variant_caller_equals_hgtpu(tmp_path):
    spec = make_gene_msa(seed=11, n_alleles=16, length=1200)
    want_ref, _ = jax_build_gene_ref("A", spec["names"], spec["rows"],
                                     spec["ref_allele"], min_var_freq=0.0)
    ref = carried(want_ref)
    allele = want_ref.allele_names[5]
    r1, r2, _ = simulate_reads(want_ref, [allele], simulate_interval=4)
    want = jax_type_reads(want_ref, _pairs(r1), _pairs(r2))
    got = type_reads(ref, _pairs(r1), _pairs(r2), device="cpu")
    _same_result(got, want)
    recs = call_variants.call_variants(ref, got)
    assert recs == jax_cv.call_variants(want_ref, want)
    assert len(recs) == len(want_ref.allele_var_indices(allele))
    call_variants.write_vcf(str(tmp_path / "t.vcf"), ref, recs)
    jax_cv.write_vcf(str(tmp_path / "h.vcf"), want_ref, recs)
    data = (tmp_path / "t.vcf").read_bytes()
    assert data == (tmp_path / "h.vcf").read_bytes()
    assert data.startswith(b"##fileformat=VCFv4.2")


def test_legacy_pipeline_equals_hgtpu():
    from hgtpu.db import Catalog as JaxCatalog
    from hgtpu.tools.legacy import perform_genotyping as jax_perform
    from hgtpu_torch.db import Catalog
    from hgtpu_torch.tools.legacy import perform_genotyping

    spec = make_gene_msa(seed=11, n_alleles=12, length=1100)
    want_ref, _ = jax_build_gene_ref("A", spec["names"], spec["rows"],
                                     spec["ref_allele"], min_var_freq=0.0)
    allele = want_ref.allele_names[3]
    r1, r2, _ = simulate_reads(want_ref, [allele], simulate_interval=5)
    want = jax_perform({"hla": JaxCatalog(family="hla",
                                          genes={"A": want_ref})},
                       _pairs(r1), _pairs(r2))
    got = perform_genotyping(
        {"hla": Catalog(family="hla", genes={"A": carried(want_ref)})},
        _pairs(r1), _pairs(r2), device="cpu")
    assert list(got) == list(want) == ["hla"]
    assert list(got["hla"]) == list(want["hla"])
    _same_result(got["hla"]["A"], want["hla"]["A"])
    assert got["hla"]["A"].prob[0][0] == allele
