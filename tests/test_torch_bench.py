"""hgtpu's measurement tools in the port equal hgtpu's on the CPU, and
the port's TRACE counters add up as hgtpu's do.

  counters   hgtpu and the port type the same reads of a small gene, on
             the host engine (device fold and device verify on, both
             sides) and on the production path: TRACE.counters() have
             the same keys, beyond them only the port's own
             (PORT_ONLY_COUNTERS), and the same values (relative 1e-9).  The DP's FLOPs
             are hgtpu's formula at the entries launched: hgtpu pads E
             to a power of two for XLA's compile cache, the port launches
             E as it is, so hgtpu's count is taken at its real entries.
  bench      hgtpu_torch.devel.bench.run on the CPU at small cells, one
             timed run each: the toy and scale results equal hgtpu's
             type_reads on the same reads (the production contract), the
             JSON has exactly bench.py's keys, and the extraction cell's
             record and routed counts equal hgtpu's scan_fastx and
             GenomeExtractor on the same text and reads.
  emulator   hgtpu_torch.devel.baseline_emu's SAM lines, measure() and
             emulate_typing's prob equal devel/baseline_emu.py's on the
             same gene and seed.
  punts      hgtpu_torch.devel.punts.punt_stats at 1 and 2 CPU shards:
             punt and excl counts, causes and tier-1 mates equal hgtpu's
             ShardedTyper.count_classes on the same gene.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from hgtpu_torch.devel import baseline_emu, bench, punts
from tests.synth import make_gene_msa
from tests.test_torch_db import carried

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HGTPU = {}

# bench.py:274-310, the keys of its JSON line (the extraction pair is
# there when its extraction ran, which the port's always does or raises)
BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "baseline_anchor",
    "toy_e2e_reads_per_s", "vs_baseline_toy", "production_path", "repeats",
    "hla_scale_dt_best", "hla_scale_dt_median", "hla_scale_spread_pct",
    "toy_dt_best", "toy_dt_median", "stage_shares",
    "hla_scale_stage_shares", "device_wall_share",
    "hla_scale_device_wall_share", "mfu_pct", "hla_scale_mfu_pct",
    "bandwidth_pct", "hla_scale_bandwidth_pct",
    "extract_fastx_scan_reads_per_s", "extract_route_reads_per_s"]
ANCHOR_KEYS = ["scale_reads_per_s", "toy_reads_per_s", "source", "host"]

SMALL_TOY = (24, 900)
SMALL_SCALE = (200, 1200)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hgtpu_script(name, path):
    """One of hgtpu's repo-level scripts, loaded once."""
    if name not in _HGTPU:
        spec = importlib.util.spec_from_file_location(
            "hgtpu_" + name, os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _HGTPU[name] = mod
    return _HGTPU[name]


def need_native():
    from hgtpu_torch.native import have_native

    if not have_native():
        pytest.fail("the native library is not built (make -C native)")


@pytest.fixture(scope="module")
def small():
    """hgtpu's small gene and a heterozygous read set of it."""
    from hgtpu.db import build_gene_ref
    from hgtpu.sim import simulate_reads

    spec = make_gene_msa(seed=11, n_alleles=24, length=1800)
    ref, _ = build_gene_ref(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    r1, r2, _ = simulate_reads(ref, ref.allele_names[3:5],
                               simulate_interval=4, seed=2)
    return ref, r1, r2


def assert_contract(got, want):
    """tests/test_production.py's contract: class dicts, counts and read
    and pair counts exact, prob within 1e-9 with the same ranking."""
    assert got.cmpt == want.cmpt
    assert got.exon_cmpt == want.exon_cmpt
    assert got.counts == want.counts
    assert (got.num_reads, got.num_pairs) == (want.num_reads,
                                              want.num_pairs)
    assert [a for a, _ in got.prob] == [a for a, _ in want.prob]
    for (_, p), (_, q) in zip(got.prob, want.prob):
        assert abs(p - q) < 1e-9


# the verify prep's bounded entries, and those bounded on the card
PORT_ONLY_COUNTERS = {"verify.lb.entries", "verify.lb.card"}


@pytest.mark.parametrize("path", ["host", "production"])
def test_trace_counters_equal_hgtpus(small, path, monkeypatch):
    from hgtpu.align import GeneAligner as JaxAligner
    from hgtpu.ops import banded_dp as jax_dp
    from hgtpu.pipeline import type_reads as jax_type_reads
    from hgtpu.typer.engine import TypingOptions as JaxOptions
    from hgtpu.utils.trace import TRACE as JAX_TRACE
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions
    from hgtpu_torch.utils.trace import TRACE

    ref, r1, r2 = small
    gene = carried(ref)
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    kw = (dict(device_counting="on", device_typing="off") if path == "host"
          else dict(device_typing="on"))
    dp_real = []            # hgtpu's DP FLOPs at its unpadded entries

    def costs(self, reads, lens, starts, max_novel=2):
        before = JAX_TRACE.counters().get("flops.device_dp", 0.0)
        out = real_costs(self, reads, lens, starts, max_novel)
        added = JAX_TRACE.counters()["flops.device_dp"] - before
        dp_real.append(added * int((lens > 0).sum()) / reads.shape[0])
        return out

    real_costs = jax_dp.BandedDPTables.costs
    monkeypatch.setattr(jax_dp.BandedDPTables, "costs", costs)
    JAX_TRACE.reset()
    want = jax_type_reads(ref, R1, R2, JaxOptions(simulation=True, **kw),
                          aligner=JaxAligner(ref, device_verify="on"))
    want_c = JAX_TRACE.counters()
    TRACE.reset()
    got = type_reads(gene, R1, R2, TypingOptions(simulation=True, **kw),
                     aligner=GeneAligner(gene, device_verify="on",
                                         device="cpu"))
    got_c = TRACE.counters()
    assert_contract(got, want)
    need = {"flops.placement"} | ({"flops.device_fold"} if path == "host"
                                  else {"flops.device_classes"})
    assert need <= set(got_c), got_c
    if "flops.device_dp" in want_c:
        assert dp_real
        want_c["flops.device_dp"] = sum(dp_real)
    # beyond hgtpu's counters, only the port's own
    assert sorted(set(got_c) - PORT_ONLY_COUNTERS) == sorted(want_c)
    for k, v in want_c.items():
        assert got_c[k] == pytest.approx(v, rel=1e-9), k


@pytest.fixture(scope="module")
def bench_run():
    """The port's bench on the CPU at small cells, one timed run each."""
    need_native()
    return bench.run("cpu", toy=SMALL_TOY, scale=SMALL_SCALE, n_scan=20000,
                     n_route=2000, repeats=1)


def test_bench_json_has_bench_py_keys(bench_run):
    out, _ = bench_run
    assert list(out) == BENCH_KEYS
    assert list(out["baseline_anchor"]) == ANCHOR_KEYS
    assert out["baseline_anchor"]["host"] == "vm"
    assert out["baseline_anchor"]["source"].startswith(
        "BASELINE_MEASURED.json ")
    assert out["production_path"] == "host"
    assert out["repeats"] == 1
    # no card: no peaks, so no device share or roofline number
    for k in ("device_wall_share", "hla_scale_device_wall_share", "mfu_pct",
              "hla_scale_mfu_pct", "bandwidth_pct",
              "hla_scale_bandwidth_pct"):
        assert out[k] is None, k
    assert out["value"] > 0 and out["toy_e2e_reads_per_s"] > 0


@pytest.mark.parametrize("cell", ["toy", "scale"])
def test_bench_typing_equals_hgtpu(bench_run, cell):
    from hgtpu.align import GeneAligner as JaxAligner
    from hgtpu.pipeline import type_reads as jax_type_reads
    from hgtpu.sim import simulate_reads

    jax_bench = hgtpu_script("bench", "bench.py")
    _, runs = bench_run
    if cell == "toy":
        ref = jax_bench._build("A", *SMALL_TOY)
        r1, r2, _ = simulate_reads(ref, ref.allele_names[:4],
                                   simulate_interval=1)
    else:
        ref = jax_bench._build("A", *SMALL_SCALE, scale=True)
        r1, r2, _ = simulate_reads(
            ref, [ref.allele_names[123 % ref.n_alleles],
                  ref.allele_names[2047 % ref.n_alleles]],
            simulate_interval=1, seed=1)
    want = jax_type_reads(ref, [(r.name, r.seq) for r in r1],
                          [(r.name, r.seq) for r in r2],
                          aligner=JaxAligner(ref))
    got, stages, counters = runs[cell]
    assert_contract(got, want)
    assert counters["flops.placement"] > 0 and "place.dispatch" in stages


def test_bench_extraction_equals_hgtpu(bench_run):
    """bench.py:107-186 with hgtpu's modules at the twin's sizes."""
    import tempfile

    from hgtpu.db.build import build_catalog_from_msa
    from hgtpu.db.genome import build_genotype_genome
    from hgtpu.native import scan_fastx
    from hgtpu.pipeline.extract_genome import GenomeExtractor
    from tests.synth import make_family

    _, runs = bench_run
    ext = runs["extract"]
    rng = np.random.default_rng(0)
    text = bench.fastq_text(20000, rng)
    assert text.count(b"\n") == 4 * 20000
    assert ext["n_records"] == len(scan_fastx(text)) == 20000

    fam = make_family(seed=17)
    cat = build_catalog_from_msa(
        "hla",
        {g: dict(names=s["names"], rows=s["rows"],
                 ref_allele=s["ref_allele"], exons=s["exons"],
                 primary_exon_idx=s["primary_exon_idx"])
         for g, s in fam["specs"].items()},
        min_var_freq=0.0)
    for g, (lo, hi) in fam["loci"].items():
        cat.genes[g].chrom = "chrS"
        cat.genes[g].chrom_left = lo
        cat.genes[g].chrom_right = hi
    with tempfile.TemporaryDirectory() as tmp:
        spliced, offsets = build_genotype_genome(
            {"chrS": fam["genome"]}, {"hla": cat}, os.path.join(tmp, "gg"))
    ex = GenomeExtractor(spliced, offsets, {"hla": cat})
    genome = fam["genome"]
    L = 100
    pos = rng.integers(0, len(genome) - 260, 2000)
    starts = pos[:, None] + np.arange(L)[None, :]
    r1s = np.frombuffer(genome.encode(), np.uint8)[starts]
    reads_1 = [("q%d" % i, r1s[i].tobytes().decode()) for i in range(2000)]
    assert ext["reads_1"] == reads_1
    routed = ex.extract(reads_1, None)
    want = sum(len(v[0]) for v in routed.values()) if routed else 0
    assert ext["routed_n"] == want > 0


def test_emulator_equals_hgtpus(small):
    jax_emu = hgtpu_script("baseline_emu", "devel/baseline_emu.py")
    ref, _, _ = small
    gene = carried(ref)
    alleles = list(ref.allele_names[3:5])
    lines_t, n_t = baseline_emu._sam_lines_for(gene, alleles, 4, seed=2,
                                               device="cpu")
    lines_j, n_j = jax_emu._sam_lines_for(ref, alleles, 4, seed=2)
    assert (lines_t, n_t) == (lines_j, n_j)
    ref_allele = ref.backbone_name.split("*")[0] + "*BACKBONE"
    got = baseline_emu.emulate_typing(lines_t, gene.allele_names, ref_allele,
                                      *baseline_emu.reference_tables(gene))
    want = jax_emu.emulate_typing(lines_j, ref.allele_names, ref_allele,
                                  *jax_emu.reference_tables(ref))
    assert got == want and got[0][0][0] in alleles
    m_t = baseline_emu.measure(gene, alleles, 4, seed=2, repeats=1,
                               device="cpu")
    m_j = jax_emu.measure(ref, alleles, 4, seed=2, repeats=1)
    for k in ("reads", "reads_used", "top_call"):
        assert m_t[k] == m_j[k], k


@pytest.mark.parametrize("n", [1, 2])
def test_punts_equal_hgtpus(small, n):
    from hgtpu.parallel import sharded as jax_sharded
    from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
    from hgtpu_torch.parallel.sharded import make_mesh

    ref, r1, r2 = small
    st = JaxTyper(ref, jax_sharded.make_mesh(n))
    out = st.count_classes(st.encode([r.seq for r in r1]),
                           st.encode([r.seq for r in r2]))
    punted = out["punt"]
    causes = [sum(int(((out["winner"][mi]["causes"][punted] >> b) & 1)
                      .sum()) for mi in range(2)) for b in range(4)]
    tier1 = sum(int(out["winner"][mi]["tier1"][punted].sum())
                for mi in range(2))
    got = punts.punt_stats(carried(ref), r1, r2, make_mesh(n, "cpu"))
    assert (got["pairs"], got["punt"], got["excl"]) == (
        len(r1), int(punted.sum()), int(out["excl"].sum()))
    assert got["punt"] > 0
    assert got["causes"] == causes
    assert got["tier1"] == tier1
    assert sum(got["anatomy"].values()) == 2 * got["punt"]
