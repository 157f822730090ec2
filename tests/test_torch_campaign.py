"""The port's regression campaign (hgtpu_torch.devel.campaign, the twin of
devel/campaign.py) passes on the CPU and equals hgtpu's runs.

The configurations are hgtpu's, field for field.  Each sweep
configuration runs through the port's simulation_sweep on
device="cpu" on both paths, the host engine ("auto" on the CPU) and the
production path (device_typing="on"); codis-str (the host engine: CODIS
needs it) and family-2gene (type_family types each gene on the host
engine) run once.  The three full-only configurations (large-panel,
long-reads, hetero-errors) run beside the --quick ones.  Each must pass
the campaign's rule, and equal hgtpu's run of the same configuration on the same gene and seeds (hgtpu's
simulation_sweep, and its own codis_config and family_config with their
type_reads / type_family results captured): the same truths, calls and
ranking, prob within 1e-9, and the production path's contract (cmpt,
exon cmpt, ranked counts, read and pair counts exact).  hla-scale-3600
(3,600 alleles, with an assembly call) is marked slow.
"""
import importlib.util
import os

import pytest

from hgtpu_torch.devel import campaign
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX = {}


def hgtpu_campaign():
    if "mod" not in _JAX:
        spec = importlib.util.spec_from_file_location(
            "hgtpu_campaign", os.path.join(ROOT, "devel", "campaign.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX["mod"] = mod
    return _JAX["mod"]


def test_configs_are_hgtpus():
    for quick in (True, False):
        assert campaign.configs(quick) == hgtpu_campaign().configs(quick)


def hgtpu_sweep(name):
    """hgtpu's run of one sweep configuration (devel/campaign.py's main
    loop body), once per module."""
    if name not in _JAX:
        from hgtpu.db import build_gene_ref
        from hgtpu.pipeline import simulation_sweep
        from hgtpu.typer.engine import TypingOptions
        from tests.synth import make_gene_msa

        _, msa_kw, build_kw, sweep_kw = next(
            c for c in campaign.configs(False) if c[0] == name)
        spec = make_gene_msa(**msa_kw)
        ref, _ = build_gene_ref(
            "A", spec["names"], spec["rows"], spec["ref_allele"],
            exons_ref_coords=spec["exons"],
            primary_exon_idx=spec["primary_exon_idx"], **build_kw)
        opts = TypingOptions(simulation=True,
                             allow_discordant=not sweep_kw.get("paired",
                                                               True))
        _JAX[name] = simulation_sweep(ref, opts=opts, **sweep_kw)[1]
    return _JAX[name]


def hgtpu_captured(fn, monkeypatch, entry):
    """hgtpu's codis_config / family_config, with the results of every
    hgtpu.pipeline.`entry` call it makes."""
    import hgtpu.pipeline

    seen = []
    real = getattr(hgtpu.pipeline, entry)

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(hgtpu.pipeline, entry, spy)
    n, want = getattr(hgtpu_campaign(), fn)()
    monkeypatch.undo()
    return n, want, seen


def same_run(got, want):
    """One typing result of the port against hgtpu's."""
    assert [a for a, _ in got.prob] == [a for a, _ in want.prob]
    assert max((abs(p - q) for (_, p), (_, q) in zip(got.prob, want.prob)),
               default=0.0) < 1e-9
    assert got.cmpt == want.cmpt and got.exon_cmpt == want.exon_cmpt
    assert got.counts == want.counts
    assert (got.num_reads, got.num_pairs) == (want.num_reads,
                                               want.num_pairs)


def _sweep_cases():
    return [pytest.param(c[0], path, id="%s-%s" % (c[0], path))
            for c in campaign.configs(False)
            for path in ("host", "production")]


@pytest.mark.parametrize("name,path", _sweep_cases())
def test_sweep_config_passes_and_equals_hgtpu(name, path):
    _, msa_kw, build_kw, sweep_kw = next(
        c for c in campaign.configs(False) if c[0] == name)
    n, want, ok, results = campaign.sweep_config(
        msa_kw, build_kw, sweep_kw, device="cpu",
        device_typing="auto" if path == "host" else "on")
    assert ok and n == want > 0, [(t, r.prob[:2]) for t, r in results]
    ref = hgtpu_sweep(name)
    assert len(results) == len(ref)
    for (truth, res), (jtruth, jres) in zip(results, ref):
        assert truth == jtruth
        same_run(res, jres)


def test_codis_config_passes_and_equals_hgtpu(monkeypatch):
    n, want, results = campaign.codis_config(device="cpu")
    assert n == want == 4
    jn, jwant, seen = hgtpu_captured("codis_config", monkeypatch,
                                     "type_reads")
    assert (jn, jwant) == (n, want) and len(seen) == len(results)
    for (truth, res), jres in zip(results, seen):
        assert res.prob[0][0] == truth[0]
        same_run(res, jres)


def test_family_config_passes_and_equals_hgtpu(monkeypatch):
    n, want, results = campaign.family_config(device="cpu")
    assert n == want == 2
    jn, jwant, seen = hgtpu_captured("family_config", monkeypatch,
                                     "type_family")
    assert (jn, jwant) == (n, want) and len(seen) == len(results)
    for (truth, res), jres in zip(results, seen):
        assert res.prob[0][0] == truth[0]
        same_run(res, jres[res.gene])


@pytest.mark.slow
def test_hla_scale_config_passes_and_equals_hgtpu(monkeypatch):
    n, want, results = campaign.hla_scale_config(device="cpu")
    assert n == want == 4
    jn, jwant, seen = hgtpu_captured("hla_scale_config", monkeypatch,
                                     "type_reads")
    assert (jn, jwant) == (n, want) and len(seen) == len(results)
    for (truth, res), jres in zip(results, seen):
        same_run(res, jres)
    assert results[-1][1].assembly_call == seen[-1].assembly_call
