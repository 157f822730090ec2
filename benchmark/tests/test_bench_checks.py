"""What decides `correct`: a run with the timed path broken underneath
reads false, the control fails the limits, and the last line keeps its
contract.  The harness's look for a card is skipped (device="cpu")."""
import argparse
import json
import os
import subprocess
import sys

import pytest

import check
import control
import run
import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


def once(tree, cell="tiny.t", trace=0, fault=None, seconds=2.0, seed=3):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.run(args, device="cpu", bench_path=tree, fault=fault)


def test_sound_run_is_correct_and_its_line_has_the_contract_keys(tree):
    out, readings, info, limits = once(tree)
    assert out["correct"] is True
    assert list(out) == ["correct", "attempted", "failed", "first_failure",
                         "metrics", "device", "compared"]
    assert out["first_failure"] is None
    assert set(out["metrics"]) == {"samples_per_s", "setup_s",
                                   "sample_p90_s"}
    assert out["attempted"] == info["samples"] > 0 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["compared"]) == set(limits)
    json.dumps(out)


def test_traced_run_reports_layers_and_a_breakdown(tree):
    out, *_ = once(tree, trace=1)
    assert list(out) == ["correct", "attempted", "failed", "first_failure",
                         "metrics", "device", "breakdown", "compared"]
    assert {"verify_ms_per_sample", "em_ms_per_sample"} <= \
        set(out["metrics"])
    assert "samples_per_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def stale(typer):
    """A step that returns its state unchanged: every call does its
    work and answers with the first call's result."""
    first = []

    def call(r1, r2):
        res = typer(r1, r2)
        if not first:
            first.append(res)
        return first[0]
    return call


def half(typer):
    """Half of the batch left out: every other pair is typed."""
    return lambda r1, r2: typer(r1[::2], r2[::2])


def altered(typer):
    """An answer altered where it is produced: the best allele's
    abundance goes to another allele."""
    def call(r1, r2):
        res = typer(r1, r2)
        for r in res.values():
            called = {a for a, _ in r.prob}
            other = next(a for cls in r.exon_cmpt for a in cls.split("-")
                         if a not in called)
            if r.prob:
                r.prob[0][0] = other
        return res
    return call


@pytest.mark.parametrize("fault", [stale, half, altered])
def test_a_broken_timed_path_reads_not_correct(tree, fault):
    out, readings, _, limits = once(tree, fault=fault, seconds=1.5)
    assert out["correct"] is False
    assert not check.verdict(readings, limits)


def test_the_first_failed_samples_error_is_kept(tree):
    calls = []

    def failing(typer):
        def call(r1, r2):
            calls.append(1)
            if len(calls) in (4, 5):     # two warm-ups, then the window
                raise ValueError("call %d: %s" % (len(calls), "x" * 300))
            return typer(r1, r2)
        return call
    out, *_ = once(tree, fault=failing, seconds=2.0)
    assert out["correct"] is False and out["failed"] == 2
    assert out["first_failure"] == \
        ("ValueError: call 4: " + "x" * 300)[:200]
    json.dumps(out)


def test_the_catalog_cache_key_covers_the_generator(tree, monkeypatch):
    keyed = []
    key = run.cache_key

    def spy(cfg, *files):
        keyed.append(files)
        return key(cfg, *files)
    monkeypatch.setattr(run, "cache_key", spy)
    once(tree, seconds=0.5)
    program = [f for f in keyed if any("systems" in p for p in f)]
    assert program and os.path.join(tiny.BENCH, "gen.py") in program[0]


def test_the_control_fails_every_compared_number(tree):
    _, _, cfg, mix, _ = run.load_cell("tiny.t", tree)
    got = control.readings(cfg, mix, 11, 2)
    for k, limit in cfg["limits"].items():
        assert got[k] > limit, (k, got[k], limit)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload",
         "hla-a.wgs30", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
