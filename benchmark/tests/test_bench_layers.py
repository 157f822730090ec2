"""Each per-layer reader on a recorded fixture, the span and profiler
reductions, and discovery of cells, configurations, mixes and metrics by
name from another tree."""
import json
import os

import pytest

import peaks
import run
import spans
import tiny

# spans as spans.Recorder keeps them: (name, start, end, enclosing names)
SPANS = [
    ("device.place", 0.0, 0.010, ()),
    ("device.spell", 0.010, 0.030, ()),
    ("device.countB", 0.030, 0.050, ()),
    ("rescue.prefill", 0.035, 0.045, ("device.countB",)),
    ("device.rescue", 0.050, 0.150, ()),
    ("rescue.align", 0.050, 0.140, ("device.rescue",)),
    ("verify.prep", 0.060, 0.080, ("device.rescue", "rescue.align")),
    ("verify.dp_apply", 0.080, 0.100, ("device.rescue", "rescue.align")),
    ("verify.native", 0.085, 0.095,
     ("device.rescue", "rescue.align", "verify.dp_apply")),
    ("device.merge", 0.150, 0.160, ()),
    ("device.rescue", 0.160, 0.170, ()),
    ("type.em", 0.170, 0.200, ()),
    ("type.pileup", 0.2, 0.25, ()),
    ("type.read_hts", 0.25, 0.3, ()),
    ("type.stats", 0.3, 0.4, ()),
    ("type.stats.classes", 0.31, 0.39, ("type.stats",)),
    ("type.em", 5.0, 5.1, ()),        # after the window: left out
]
K1 = [(7168, 100, 3657), (7168, 100, 3657)]
PEAK = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
PROFILE = dict(window_s=0.5, busy_s=0.1,
               kernels=[("placement_scores_kernel", 0.0, 200.0),
                        ("placement_scores_kernel", 300.0, 500.0),
                        ("Memcpy HtoD", 500.0, 510.0),
                        ("other", 600.0, 700.0)],
               device_ops=[], idle_gaps=[])


def ctx(**kw):
    c = dict(spans=SPANS, samples=2, window=(0.0, 1.0), profile=PROFILE,
             k1=K1, profiled=2, peak=PEAK)
    c.update(kw)
    return c


def reader(name):
    return run.load_module(os.path.join(tiny.BENCH, "layer_metrics",
                                        name + ".py"), "m_" + name)


@pytest.mark.parametrize("name,want", [
    ("rescue_ms_per_sample", 1e3 * (0.100 + 0.010 + 0.010) / 2),
    ("passes_ms_per_sample", 1e3 * 0.050 / 2),
    ("verify_ms_per_sample", 1e3 * (0.020 + 0.020) / 2),
    ("em_ms_per_sample", 1e3 * 0.030 / 2),
    ("device_idle_pct", 80.0),
    ("launches_per_sample", 1.5),
])
def test_reader_on_the_fixture(name, want):
    assert reader(name).read(ctx()) == pytest.approx(want)


def test_k1_roofline_counts_work_from_the_shape():
    ops, nbytes = peaks.k1_work(7168, 100, 3657)
    assert ops == 2.0 * 7168 * 5 * 100 * 3558
    least = 2 * peaks.least_time(ops, nbytes, PEAK)
    got = reader("k1_roofline_pct").read(ctx())
    assert got == pytest.approx(100 * least / 400e-6)
    assert 0 < got <= 100


@pytest.mark.parametrize("name", ["rescue_ms_per_sample",
                                  "k1_roofline_pct", "device_idle_pct",
                                  "launches_per_sample"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = ctx(spans=[], profile=None, k1=[], peak=None)
    assert reader(name).read(empty) is None


def test_top_level_counts_nested_stages_once():
    assert spans.top_level_seconds(SPANS, ("verify.",), 0, 1) == \
        pytest.approx(0.040)
    assert spans.top_level_seconds(
        SPANS, ("type.stats", "type.stats.classes"), 0, 1) == \
        pytest.approx(0.1)


def test_recorder_keeps_nesting_and_k1_shapes():
    import contextlib
    import types

    class Trace:
        @contextlib.contextmanager
        def stage(self, name):
            yield

    trace = Trace()
    mod = types.SimpleNamespace(placement_scores=lambda p, r: "scores")
    rec = spans.Recorder()
    rec.install(trace, mod)
    rec.k1_on = True
    with trace.stage("a"):
        t = trace.stage("b")
        t.__enter__()
        t.__exit__(None, None, None)
    shape = types.SimpleNamespace(shape=(4, 5))
    assert mod.placement_scores(types.SimpleNamespace(shape=(9, 5)),
                                shape) == "scores"
    rec.uninstall()
    assert [(n, o) for n, _, _, o in rec.spans] == [("b", ("a",)),
                                                    ("a", ())]
    assert rec.k1 == [(4, 5, 9)]
    assert mod.placement_scores(None, None) == "scores"


def test_cells_configs_mixes_and_metrics_are_found_by_name(tmp_path):
    path = tiny.make_tree(str(tmp_path))
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append(dict(
        name="pairs_seen", unit="pairs", better="higher",
        source="program_counter", layer="device", moves="samples_per_s"))
    with open(path, "w") as f:
        json.dump(bench, f)
    with open(tmp_path / "benchmark" / "layer_metrics" / "pairs_seen.py",
              "w") as f:
        f.write("def read(ctx):\n    return float(ctx['samples'])\n")
    _, cell, cfg, mix, where = run.load_cell("tiny.t", path)
    assert cell["config"] == "tiny" and cfg["system"] == "gene"
    assert mix == tiny.MIX and where == str(tmp_path / "benchmark")
    import argparse
    out, *_ = run.run(argparse.Namespace(workload="tiny.t", seed=1,
                                         seconds=1.0, trace=1),
                      device="cpu", bench_path=path)
    assert out["metrics"]["pairs_seen"]["value"] == out["attempted"]
    with pytest.raises(run.CellError):
        run.load_cell("nope.t", path)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hgtpu_torch_like", types.ModuleType(
        "hgtpu_torch_like"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hgtpu.db", types.ModuleType("x"))
    assert run.forbidden_modules() == ["hgtpu"]
