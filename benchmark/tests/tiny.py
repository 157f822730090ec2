"""A tree laid out as the repository's (BENCHMARK.json beside a
benchmark/ folder) with tiny cells, for tests that drive the harness on
the CPU."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

LIMITS = dict(full_gap=0.02, exon_gap=0.12, counts_gap=0.02,
              abundance_gap=0.08)


def config(n_alleles=60):
    """One small gene laid out as hla-a-imgt.json lays HLA-A out."""
    return dict(source="tiny", system="gene", family="hla",
                genes=[dict(name="A", seed=4)], length=1500,
                exons=[[120, 180], [300, 440], [560, 700], [900, 1000],
                       [1200, 1250]],
                primary_exons=[1, 2], groups=[1, 2, 3, 11, 23],
                n_alleles=n_alleles, full_frac=0.4, partial_exons=[1, 2],
                n_snp=250, n_del=25, n_ins=12, lineage_frac=0.5,
                private_mean=3, min_var_freq=0.0, limits=LIMITS,
                reduced=[])


def panel_config(divergence=0.15):
    """Three small genes, so that the program's router is on: A as
    config() lays it out, B a paralog of A at `divergence` with layout
    keys of its own, C a gene of its own with a class II-like layout."""
    cfg = config()
    cfg["system"] = "family"
    cfg["genes"] = [
        dict(name="A", seed=4),
        dict(name="B", seed=5, paralog_of="A", divergence=divergence,
             length=1400, n_alleles=50),
        dict(name="C", seed=6, length=1300,
             exons=[[100, 200], [400, 600], [800, 900]], primary_exons=[1],
             partial_exons=[1], n_alleles=40)]
    return cfg


MIX = dict(interval=20, read_len=100, frag_len=350, profile_samples=2,
           check_samples=2)


def make_tree(root):
    """BENCHMARK.json with the cell tiny.t (one small gene), the
    repository's systems/ and layer_metrics/."""
    b = os.path.join(root, "benchmark")
    os.makedirs(os.path.join(b, "configs"))
    os.makedirs(os.path.join(b, "mixes"))
    for d in ("systems", "layer_metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(b, d))
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(config(), f)
    with open(os.path.join(b, "mixes", "t.json"), "w") as f:
        json.dump(MIX, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [
        dict(name="tiny", source="tiny", file="benchmark/configs/tiny.json",
             reduced=[], why="tiny")]
    bench["workloads"] = [
        dict(name="tiny.t", config="tiny", traffic="t", chips=1, why="t")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path
