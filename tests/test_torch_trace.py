"""The port's TRACE as the program's span recorder: spans with parents
and self time, calls under fresh ids per thread, the window filter, the
bounds on memory, a stage that raises, profiler ranges of the stages'
own names, agreement with the benchmark's outside recorder
(benchmark/spans.py) and the benchmark readers of the program's calls."""
import importlib.util
import os
import sys
import threading
import time

import pytest
import torch

from hgtpu_torch.utils import trace as trace_mod
from hgtpu_torch.utils.trace import TRACE, StageTimer
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def only(calls):
    assert len(calls) == 1, calls
    return calls[0]


def by_name(call):
    """{name: [(start, end, parent name)]} of a call's spans."""
    spans = call["spans"]
    out = {}
    for name, a, b, p in spans:
        out.setdefault(name, []).append((a, b, spans[p][0] if p >= 0
                                         else None))
    return out


def test_spans_keep_parents_and_self_time():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.02)
        with t.stage("b"):
            time.sleep(0.03)
            with t.stage("c"):
                time.sleep(0.01)
        with t.stage("b"):
            time.sleep(0.01)
            with t.stage("b"):          # nested in its own name
                time.sleep(0.01)
    call = only(t.calls())
    names = [n for n, *_ in call["spans"]]
    assert names == ["a", "b", "c", "b", "b"]
    assert [p for *_, p in call["spans"]] == [-1, 0, 1, 0, 3]
    st = call["stages"]
    span = {i: b - a for i, (_n, a, b, _p) in enumerate(call["spans"])}
    assert st["a"]["s"] == pytest.approx(span[0])
    # b's inclusive time counts the inner b once
    assert st["b"]["s"] == pytest.approx(span[1] + span[3])
    assert st["b"]["n"] == 3 and st["a"]["n"] == st["c"]["n"] == 1
    assert st["a"]["self"] == pytest.approx(span[0] - span[1] - span[3])
    assert st["b"]["self"] == pytest.approx(span[1] - span[2] + span[3]
                                            - span[4] + span[4])
    assert st["c"]["self"] == pytest.approx(span[2])
    assert st["a"]["self"] >= 0.02 and st["c"]["s"] >= 0.01
    assert st["b"]["s"] >= 0.05
    assert sum(v["self"] for v in st.values()) == pytest.approx(st["a"]["s"])
    assert call["t0"] == call["spans"][0][1]
    assert call["t1"] == call["spans"][0][2]
    # the flat totals count every span, as they always have, less each
    # span's own bookkeeping
    assert t.summary()["b"]["n"] == 3
    flat = t.summary()["b"]["s"]
    assert flat <= span[1] + span[3] + span[4]
    assert flat == pytest.approx(span[1] + span[3] + span[4], abs=1e-3)


def test_calls_take_fresh_ids_per_call_and_per_thread():
    t = StageTimer()

    def worker():
        with t.stage("w"):
            with t.stage("w.inner"):
                pass

    with t.stage("root"):
        with t.stage("x"):
            th = threading.Thread(target=worker)
            th.start()
            th.join()
    with t.stage("root"):
        pass
    calls = t.calls()
    assert len(calls) == 3
    worker_call, first, second = calls     # oldest finished first
    # the worker's stages opened inside the main thread's open call form
    # a call of their own, at depth 0 on their thread
    assert [(n, p) for n, _a, _b, p in worker_call["spans"]] == \
        [("w", -1), ("w.inner", 0)]
    assert [(n, p) for n, _a, _b, p in first["spans"]] == [("root", -1),
                                                          ("x", 0)]
    assert first["t0"] < worker_call["t0"] < worker_call["t1"] < first["t1"]
    assert len({c["id"] for c in calls}) == 3
    assert first["id"] < worker_call["id"] < second["id"]


def test_calls_keeps_only_the_calls_inside_the_window():
    t = StageTimer()
    marks = []
    for name in ("before", "inside", "after"):
        marks.append(time.perf_counter())
        with t.stage(name):
            time.sleep(0.002)
    marks.append(time.perf_counter())
    got = t.calls(marks[1], marks[2])
    assert [c["spans"][0][0] for c in got] == ["inside"]
    assert [c["spans"][0][0] for c in t.calls(marks[1])] == ["inside",
                                                            "after"]
    assert [c["spans"][0][0] for c in t.calls(None, marks[2])] == \
        ["before", "inside"]
    assert t.calls(marks[3]) == []
    t.reset()
    assert t.calls() == [] and t.summary() == {}


def test_memory_is_bounded_in_calls_and_in_spans_per_call():
    t = StageTimer()
    n = trace_mod.MAX_CALLS + 7
    for _ in range(n):
        with t.stage("s"):
            pass
    calls = t.calls()
    assert len(calls) == trace_mod.MAX_CALLS
    assert [c["id"] for c in calls] == list(range(8, n + 1))
    t.reset()
    extra = 25
    with t.stage("root"):
        for _ in range(trace_mod.MAX_SPANS + extra):
            with t.stage("leaf"):
                with t.stage("under"):
                    pass
    call = only(t.calls())
    assert len(call["spans"]) == trace_mod.MAX_SPANS
    assert call["dropped"] == 2 * (trace_mod.MAX_SPANS + extra) + 1 \
        - trace_mod.MAX_SPANS
    # a dropped span's children hang under the nearest kept ancestor
    assert all(p >= 0 for *_, p in call["spans"][1:])
    assert t.summary()["leaf"]["n"] == trace_mod.MAX_SPANS + extra


def test_counters_add_to_the_open_call_and_to_the_flat_totals():
    t = StageTimer()
    t.count("c", 1.0)                       # no call open: flat only

    def worker():
        with t.stage("w"):
            t.count("c", 10.0)

    with t.stage("root"):
        t.count("c", 2.0)
        with t.stage("inner"):
            t.count("c", 3.0)
            t.count("d", 1.0)
            th = threading.Thread(target=worker)
            th.start()
            th.join()
    with t.stage("next"):
        pass
    worker_call, first, second = t.calls()
    assert first["counters"] == {"c": 5.0, "d": 1.0}
    assert worker_call["counters"] == {"c": 10.0}
    assert second["counters"] == {}
    assert t.counters() == {"c": 16.0, "d": 1.0}


@pytest.mark.parametrize("how", ["raises", "left_open"])
def test_the_call_after_a_broken_one_starts_at_depth_zero(how):
    t = StageTimer()
    if how == "raises":
        with pytest.raises(ValueError):
            with t.stage("outer"):
                with t.stage("inner"):
                    raise ValueError("boom")
    else:
        with t.stage("outer"):
            t.stage("inner").__enter__()     # never left
    with t.stage("next"):
        with t.stage("child"):
            pass
    broken, nxt = t.calls()
    assert nxt["id"] > broken["id"]
    assert [(n, p) for n, _a, _b, p in nxt["spans"]] == [("next", -1),
                                                         ("child", 0)]
    assert "outer" in broken["stages"]
    if how == "raises":
        assert broken["stages"]["inner"]["n"] == 1
    else:
        assert "inner" not in broken["stages"]      # still open


# ---- the program: a tiny hla gene typed on the production path ---- #

@pytest.fixture(scope="module")
def sample():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_gene_msa
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads

    spec = make_gene_msa(seed=3)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"],
                            exons_ref_coords=spec["exons"],
                            min_var_freq=0.1)
    r1, r2, _ = simulate_reads(ref, [ref.allele_names[7],
                                     ref.allele_names[3]],
                               simulate_interval=4)
    sample = (ref, [(r.name, r.seq) for r in r1],
              [(r.name, r.seq) for r in r2])
    type_once(sample)                       # tables built outside the tests
    return sample


def type_once(sample):
    """One typing call on the production path; its TRACE call."""
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions

    ref, r1, r2 = sample
    t0 = time.perf_counter()
    res = type_reads(ref, r1, r2, TypingOptions(device_typing="on"),
                     device="cpu")
    call = only(TRACE.calls(t0, time.perf_counter()))
    return res, call


def test_a_typing_call_is_one_call_under_its_root_stage(sample):
    res, call = type_once(sample)
    assert res.prob
    spans = call["spans"]
    assert spans[0][0] == "call.type_reads" and spans[0][3] == -1
    assert all(p >= 0 for *_, p in spans[1:])
    names = by_name(call)
    for stage in ("device.spell", "device.countB", "device.rescue",
                  "device.merge", "type.em", "em.build", "em.solve",
                  "pass.dispatch", "sync.fetch"):
        assert stage in names, stage
    assert {p for *_, p in names["em.solve"]} == {"type.em"}
    assert {p for *_, p in names["pass.dispatch"]} <= {
        "device.place", "device.spell", "device.countB"}
    st = call["stages"]
    assert st["em.build"]["s"] + st["em.solve"]["s"] <= st["type.em"]["s"]
    assert st["call.type_reads"]["s"] == pytest.approx(call["t1"]
                                                       - call["t0"])


def test_profiler_ranges_are_the_stages_nested_as_the_spans(sample):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, call = type_once(sample)
    names = {n for n, *_ in call["spans"]}
    ranges = []
    for e in prof.events():
        if e.name not in names:
            continue
        up = e.cpu_parent
        while up is not None and up.name not in names:
            up = up.cpu_parent
        ranges.append((e.name, up.name if up is not None else None))
    spans = [(n, p) for n, (_a, _b, p) in
             ((n, v) for n, vs in by_name(call).items() for v in vs)]
    assert sorted(ranges) == sorted(spans)


def test_no_range_is_opened_without_a_profiler(sample, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    _, call = type_once(sample)
    assert len(call["spans"]) > 10
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _, call = type_once(sample)
    assert sorted(entered) == sorted(n for n, *_ in call["spans"])


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_program_calls_equal_the_benchmark_recorder(sample, fused,
                                                    monkeypatch):
    """The benchmark's Recorder wraps TRACE.stage from outside; per call
    the program's inclusive seconds of the stages its readers read agree
    with its spans within 1 % (with the fused spell pass and without it,
    where the place pass runs on its own)."""
    import gc

    import hgtpu_torch.ops.placement as placement

    monkeypatch.setenv("HGTPU_FUSED_SPELL", fused)
    spans = load(os.path.join(BENCH, "spans.py"), "bench_spans")
    rec = spans.Recorder()
    rec.install(TRACE, placement)
    # as the benchmark's window, with no full collection inside a call
    gc.collect()
    gc.disable()
    try:
        type_once(sample)
        _, call = type_once(sample)
    finally:
        gc.enable()
        rec.uninstall()
    assert TRACE.stage.__func__ is StageTimer.stage
    assert ("device.place" in call["stages"]) == (fused == "off")
    for stage in ("device.place", "device.spell", "device.countB",
                  "device.rescue", "device.merge", "type.em"):
        want = spans.top_level_seconds(rec.spans, (stage,), call["t0"],
                                       call["t1"])
        got = call["stages"].get(stage, {"s": 0.0})["s"]
        assert got == pytest.approx(want, rel=0.01), stage


@pytest.mark.parametrize("metric,stage", [
    ("em_build_ms_per_sample", "em.build"),
    ("em_solve_ms_per_sample", "em.solve"),
    ("pass_dispatch_ms_per_sample", "pass.dispatch"),
    ("fetch_wait_ms_per_sample", "sync.fetch"),
])
def test_benchmark_reader_of_the_program_calls(sample, metric, stage):
    reader = load(os.path.join(BENCH, "layer_metrics", metric + ".py"),
                  "bench_metric_" + metric)
    t0 = time.perf_counter()
    calls = [type_once(sample)[1] for _ in range(2)]
    window = (t0, time.perf_counter())
    want = 1e3 * sum(c["stages"][stage]["s"] for c in calls) / 2
    assert want > 0
    got = reader.read(dict(window=window, samples=2, spans=[]))
    assert got == pytest.approx(want)
    # nothing ran in an empty window
    t = time.perf_counter()
    assert reader.read(dict(window=(t, t), samples=2, spans=[])) is None


def test_benchmark_reader_of_the_bound_on_the_card(sample):
    """verify_lb_card_pct: 100 * verify.lb.card / verify.lb.entries over
    the window's calls: 0 where the aligner bound its entries on the CPU,
    100 with a card run's counters, None where no call counted entries
    (as at a program without the counters)."""
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.sim import simulate_reads

    reader = load(os.path.join(BENCH, "layer_metrics",
                               "verify_lb_card_pct.py"),
                  "bench_metric_verify_lb_card_pct")

    def window(body):
        t0 = time.perf_counter()
        with TRACE.stage("call.type_reads"):
            body()
        return reader.read(dict(window=(t0, time.perf_counter()),
                                samples=1, spans=[]))

    assert window(lambda: None) is None
    ref = sample[0]
    r1, _r2, _ = simulate_reads(ref, [ref.allele_names[7]],
                                simulate_interval=20, perbase_errorrate=3.0,
                                seed=4)
    ga = GeneAligner(ref, device="cpu")
    assert window(lambda: ga.align_batch([r.name for r in r1],
                                         [r.seq for r in r1], "L")) == 0.0

    def card_run():
        TRACE.count("verify.lb.entries", 4000)
        TRACE.count("verify.lb.card", 4000)
    assert window(card_run) == 100.0


def test_benchmark_reader_of_the_mask_fed_em_stages(sample):
    """em_mask_stage_pct: 100 * em.stages.masks / em.stages over the
    window's calls: None where no call ran a solver stage (as at a
    program without the counters), 100 over a typing call."""
    reader = load(os.path.join(BENCH, "layer_metrics",
                               "em_mask_stage_pct.py"),
                  "bench_metric_em_mask_stage_pct")
    t = time.perf_counter()
    assert reader.read(dict(window=(t, t), samples=1, spans=[])) is None
    t0 = time.perf_counter()
    _res, call = type_once(sample)
    assert call["counters"]["em.stages"] >= 1
    assert reader.read(dict(window=(t0, time.perf_counter()), samples=1,
                            spans=[])) == 100.0


def test_benchmark_reader_of_the_pass_graph_hit_share(sample, monkeypatch):
    """pass_graph_hit_pct: 100 (1 - captures / dispatches) over the
    window's calls, with a stub capturer standing in for CUDA graphs on
    the CPU: the first call captures every pass, the second replays."""
    from hgtpu_torch.parallel.graphs import Card, PassGraphs
    from hgtpu_torch.parallel.production import _shared_sharded_typer
    from hgtpu_torch.parallel.sharded import Mesh
    from hgtpu_torch.typer import TypingOptions
    from test_torch_pass_graphs import Stub

    reader = load(os.path.join(BENCH, "layer_metrics",
                               "pass_graph_hit_pct.py"),
                  "bench_metric_pass_graph_hit_pct")
    st = _shared_sharded_typer(sample[0], TypingOptions(device_typing="on"),
                               Mesh([torch.device("cpu")]), 100)
    assert st._graphs is None
    # the eager passes: dispatches and no capture
    t0 = time.perf_counter()
    type_once(sample)
    assert reader.read(dict(window=(t0, time.perf_counter()), samples=1,
                            spans=[])) == 100.0
    st._graphs = PassGraphs(Card(10 ** 9, Stub()))
    try:
        t0 = time.perf_counter()
        calls = [type_once(sample)[1] for _ in range(2)]
        window = (t0, time.perf_counter())
    finally:
        st._graphs = None
    disp = sum(c["stages"]["pass.dispatch"]["n"] for c in calls)
    caps = calls[0]["stages"]["pass.capture"]["n"]
    assert caps == calls[0]["stages"]["pass.dispatch"]["n"]
    assert "pass.capture" not in calls[1]["stages"]
    got = reader.read(dict(window=window, samples=2, spans=[]))
    assert got == pytest.approx(100.0 * (1 - caps / disp)) == 50.0
    t = time.perf_counter()
    assert reader.read(dict(window=(t, t), samples=2, spans=[])) is None
    # a program without pass graphs has no share to read
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "hgtpu_torch.parallel.graphs"
                        else real(name, *a))
    assert reader.read(dict(window=window, samples=2, spans=[])) is None
