"""The port's TRACE counters and its punt probe equal hgtpu's on the CPU.

  counters   hgtpu and the port type the same reads of a small gene, on
             the host engine (device fold and device verify on, both
             sides) and on the production path: TRACE.counters() have
             the same keys, beyond them only the port's own
             (PORT_ONLY_COUNTERS), and the same values (relative 1e-9).  The DP's FLOPs
             are hgtpu's formula at the entries launched: hgtpu pads E
             to a power of two for XLA's compile cache, the port launches
             E as it is, so hgtpu's count is taken at its real entries.
  punts      hgtpu_torch.devel.punts.punt_stats at 1 and 2 CPU shards:
             punt and excl counts, causes and tier-1 mates equal hgtpu's
             ShardedTyper.count_classes on the same gene.
"""
import pytest

from hgtpu_torch.devel import punts
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.torch_threads import _torch_threads  # noqa: F401


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


# the verify prep's bounded entries, and those bounded on the card; the
# staged EM's solver stages, and those fed the classes as masks
PORT_ONLY_COUNTERS = {"verify.lb.entries", "verify.lb.card",
                      "em.stages", "em.stages.masks"}


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
