"""The family cell on the CPU at a tiny size: the port's router types a
paralog's pairs as its exhaustive path does, at several seeds, and a
tiny hla6-style cell runs through systems/family.py and the four family
readers (route, per-gene alignment, host engine, genes a read)."""
import argparse
import json
import os

import pytest

import check
import run
import tiny
from test_bench_panel import typed

FAMILY_METRICS = ("route_ms_per_sample", "family_align_ms_per_sample",
                  "engine_ms_per_sample", "route_genes_per_read")


@pytest.mark.parametrize("seed", [77, 101, 2147483655])
def test_paralogs_typed_through_the_router_within_the_limits_at_seed(seed):
    """Router on, every sample within the tiny limits against the
    reference, and each gene's typed pairs within one of router off."""
    on = typed(0.15, "auto", seed=seed)
    off = typed(0.15, "off", seed=seed)
    for (got, want, nums, _), (got_off, *_rest) in zip(on, off):
        assert check.verdict(nums, tiny.LIMITS), (got, want, nums)
        assert all(abs(got[g] - got_off[g]) <= 1 for g in got_off), \
            (got, got_off)


def family_tree(root):
    """tiny.make_tree's tree plus the cell tiny.p: the three-gene panel
    of tiny.panel_config through systems/family.py, the family metrics
    listing it as the repository's list hla6.wgs30."""
    path = tiny.make_tree(root)
    with open(os.path.join(root, "benchmark", "configs", "tinyp.json"),
              "w") as f:
        json.dump(tiny.panel_config(), f)
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tinyp", source="tiny",
                                 file="benchmark/configs/tinyp.json",
                                 reduced=[], why="tiny panel"))
    bench["workloads"].append(dict(name="tiny.p", config="tinyp",
                                   traffic="t", chips=1, why="p"))
    for m in bench["per_layer"]:
        if m["name"] in FAMILY_METRICS:
            m["workloads"] = ["tiny.p"]
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def test_a_family_cell_runs_through_the_family_system_and_readers(
        tmp_path):
    path = family_tree(str(tmp_path))
    out, readings, info, limits = run.run(
        argparse.Namespace(workload="tiny.p", seed=2147483655, seconds=1.0,
                           trace=1), device="cpu", bench_path=path)
    assert out["correct"] and out["failed"] == 0, (out, readings)
    assert out["first_failure"] is None and info["samples"] >= 1
    got = out["metrics"]
    for name in FAMILY_METRICS:
        assert got[name]["value"] > 0, (name, got)
    assert 1.0 <= got["route_genes_per_read"]["value"] <= 3.0
    assert got["route_genes_per_read"]["unit"] == "genes/read"
    # the per-gene alignment holds verify; the engine holds the EM
    assert got["family_align_ms_per_sample"]["value"] >= \
        got["verify_ms_per_sample"]["value"]
    assert got["engine_ms_per_sample"]["value"] >= \
        got["em_ms_per_sample"]["value"]


def test_the_family_readers_read_nothing_where_nothing_was_recorded():
    """As on a program without the family stages and per-call counters:
    no spans in the window, no calls in it."""
    ctx = dict(spans=[("type.em", 5.0, 5.1, ())], samples=2,
               window=(0.0, 1.0), profile=None, k1=[], profiled=0,
               peak=None)
    for name in FAMILY_METRICS:
        reader = run.load_module(os.path.join(tiny.BENCH, "layer_metrics",
                                              name + ".py"), "f_" + name)
        assert reader.read(ctx) is None, name


def test_a_program_with_a_one_round_router_cannot_run_the_family_cell(
        tmp_path, monkeypatch, capsys):
    """The parent's router has one round and drops paralogs' indel reads:
    the family system stops the run at once, with exit code 1, before
    the catalogue is built."""
    from hgtpu_torch.align.family import FamilyAligner

    path = family_tree(str(tmp_path))
    monkeypatch.delattr(FamilyAligner, "ROUNDS")
    monkeypatch.setattr(run, "cached", lambda *a: pytest.fail("built"))
    with pytest.raises(SystemExit) as e:
        run.run(argparse.Namespace(workload="tiny.p", seed=2147483655,
                                   seconds=1.0, trace=0),
                device="cpu", bench_path=path)
    assert "one round" in str(e.value.code)
    # a bare message as the code: the interpreter prints it, exit code 1
    assert isinstance(e.value.code, str)
