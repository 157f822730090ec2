"""Edge cases of the typing options, typed by the port and by hgtpu.

As tests/test_torch_edges_fuzz.py: hgtpu_torch.devel.edges' cases on
tests/test_options.py's gene at 900 bp, the port's production result
equal to hgtpu's at hgtpu's mesh size, field for field, and to the port's
host engine under the host contract.  use_alts=False and
error_correction=False take the host engine in both packages (the
device program does not cover them); the rest take the production path.

  use-alts-off, no-error-correction   the two options that route to the
                      host engine
  exclude-allele      test_options.py:61: the truth left out of the
                      panel; the call is a panel member
  snprate             test_options.py:25: germline SNPs at 0.2 % give
                      novel variants, typed to the truth
  primary-exons       test_options.py:44: type_primary_exons=True, a
                      heterozygous pair
"""
import pytest

from hgtpu_torch.parallel.production import device_typing_supported
from hgtpu_torch.typer.engine import TypingOptions
from hgtpu_torch.devel import edges
from tests.test_torch_edges_fuzz import case_of, check_case
from tests.torch_threads import _torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["use-alts-off", "no-error-correction"])
def test_host_engine_options_equal_hgtpu(name):
    opts = case_of(name)[3]
    assert not device_typing_supported(TypingOptions(**opts), True)
    dev, truths, _ = check_case(name)
    assert dev.prob[0][0] == truths[0]


def test_excluded_truth_equals_hgtpu():
    dev, truths, _ = check_case("exclude-allele")
    assert dev.prob and dev.prob[0][0] != truths[0]
    assert truths[0] not in {a for a, _ in dev.prob}


def test_germline_snps_equal_hgtpu():
    dev, truths, _ = check_case("snprate")
    assert dev.prob[0][0] == truths[0] and dev.novel_vars


def test_primary_exons_equal_hgtpu():
    dev, truths, _ = check_case("primary-exons")
    assert dev.primary_exon_cmpt
    assert {a for a, _ in dev.prob[:2]} == set(truths)


def test_cases_cover_the_options():
    """One option set per case, each a TypingOptions field."""
    fields = set(TypingOptions.__dataclass_fields__)
    for _name, gene, _reads, opts in edges.CASES:
        assert gene in edges.specs() and set(opts) <= fields


@pytest.mark.parametrize("name", ["fuzz1", "errors", "exclude-allele",
                                  "snprate", "primary-exons"])
def test_report_lines_do_not_move_with_the_shard_count(name, tmp_path):
    """These cases' classes come out in another order on one shard than
    on eight (in both packages; the port equals hgtpu at each size).  The
    report reads `counts` (per allele) and `prob`, whose ties follow the
    alleles' first appearance in cmpt: the lines stay the same."""
    from hgtpu.sim import simulate_reads

    from hgtpu_torch.parallel.production import type_reads_device
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu_torch.typer.report import ReportWriter
    from tests.test_torch_db import carried
    from tests.test_torch_edges_fuzz import hgtpu_gene

    _, gene_name, reads, opts = case_of(name)
    ref = hgtpu_gene(gene_name)
    R1, R2 = edges.case_reads(simulate_reads, ref, reads)
    gene = carried(edges.panel(ref, reads))
    truths = edges.truths(ref, reads)
    lines = []
    results = []
    for n in (1, 8):
        res = type_reads_device(
            gene, R1, R2,
            TypingOptions(simulation=True, device_typing="on", **opts),
            mesh=make_mesh(n, "cpu"))
        path = str(tmp_path / ("%d.report" % n))
        w = ReportWriter(path)
        w.gene_result(res, simulation=True, true_alleles=truths)
        w.close()
        lines.append(open(path).read().splitlines())
        results.append(res)
    one, eight = results
    levels = ("cmpt", "exon_cmpt", "primary_exon_cmpt")
    assert all(getattr(one, lv) == getattr(eight, lv) for lv in levels)
    assert any(list(getattr(one, lv).items())
               != list(getattr(eight, lv).items()) for lv in levels)
    assert one.counts == eight.counts
    assert [a for a, _ in one.prob] == [a for a, _ in eight.prob]
    assert lines[0] == lines[1] and any("ranked" in x for x in lines[0])


def mesh_probe(n_genes, seed=1, shards=8):
    """The class order against the report across shard counts: random
    genes (test_fuzz.py's _random_msa at 3-12 alleles, 400-900 bp), one
    or two truths, typed on the port's CPU production path over 1 and
    `shards` shards, with and without pruning.  Returns (typings,
    typings whose class order differs at some level, typings whose
    report lines differ)."""
    import random
    import tempfile

    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.parallel.production import type_reads_device
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.typer.report import ReportWriter

    def lines(res, truths, path):
        w = ReportWriter(path)
        w.gene_result(res, simulation=True, true_alleles=truths)
        w.close()
        with open(path) as f:
            return f.read().splitlines()

    levels = ("cmpt", "exon_cmpt", "primary_exon_cmpt")
    rng = random.Random(seed)
    n = n_order = n_report = 0
    with tempfile.TemporaryDirectory() as tmp:
        for t in range(n_genes):
            names, rows = edges.random_msa(rng, rng.randint(3, 12),
                                           rng.randint(400, 900))
            gene, _ = build_gene_ref("F", names, rows, names[0],
                                     min_var_freq=0.0)
            if gene.n_alleles < 2:
                continue
            truths = rng.sample(gene.allele_names, rng.choice([1, 2]))
            r1, r2, _ = simulate_reads(
                gene, truths, simulate_interval=rng.choice([2, 3]), seed=t,
                perbase_errorrate=rng.choice([0.0, 1.0]))
            R1 = [(r.name, r.seq) for r in r1]
            R2 = [(r.name, r.seq) for r in r2]
            for opts in ({}, {"remove_low_abundance_alleles": False}):
                o = TypingOptions(simulation=True, device_typing="on",
                                  **opts)
                one, many = (type_reads_device(
                    gene, R1, R2, o, mesh=make_mesh(k, "cpu"))
                    for k in (1, shards))
                n += 1
                n_order += any(list(getattr(one, lv).items())
                               != list(getattr(many, lv).items())
                               for lv in levels)
                n_report += lines(one, truths, tmp + "/a") \
                    != lines(many, truths, tmp + "/b")
    return n, n_order, n_report


def test_random_genes_report_lines_do_not_move_with_the_shard_count():
    """mesh_probe on a few random genes: no report line moves between 1
    and 8 shards."""
    n, _n_order, n_report = mesh_probe(3, seed=5)
    assert n > 0 and n_report == 0
