"""The plain reference against the port at a tiny size on the CPU, and
the reference's independence from the port."""
import os
import subprocess
import sys

import pytest
import torch

import check
import gen
import reference
import tiny


@pytest.fixture(scope="module")
def gene_cell():
    cfg = tiny.config()
    specs = gen.catalog_specs(cfg)
    genes = [reference.RefGene(g, s) for g, s in specs.items()]
    return cfg, specs, genes, reference.Placer(genes)


@pytest.mark.parametrize("device_typing", ["off", "on"])
def test_reference_agrees_with_the_port_on_one_gene(gene_cell,
                                                    device_typing):
    from hgtpu_torch.align import GeneAligner
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions

    import systems_gene
    cfg, specs, genes, placer = gene_cell
    ref = systems_gene.catalog(cfg, specs)
    al = GeneAligner(ref, device=torch.device("cpu"))
    opts = TypingOptions(device_typing=device_typing)
    for i in range(3):
        _, r1, r2 = gen.draw_sample(specs, tiny.MIX, 77, i)
        got = {"A": check.as_dict(type_reads(ref, r1, r2, opts,
                                             aligner=al))}
        want = reference.type_sample(genes, placer, r1, r2)
        assert got["A"]["num_pairs"] == want["A"]["num_pairs"] == len(r1)
        nums = check.numbers(got, want)
        assert check.verdict(nums, cfg["limits"]), nums


def test_exon_clipping_follows_the_deletion_edge_rules():
    ops = [("S", 5, 5), ("D", 9, 11), ("S", 20, 20)]
    assert reference.clip_to_exon(0, 30, ops, 40, 50) is None
    assert reference.clip_to_exon(0, 30, ops, 3, 25) == (3, 25)
    # a deletion over the exon's left edge moves the edge past it
    assert reference.clip_to_exon(0, 30, ops, 10, 25) == (12, 25)
    # ... and over its right edge, before it
    assert reference.clip_to_exon(0, 30, ops, 0, 10) == (0, 8)


def test_em_splits_shared_classes_and_prunes():
    prob = dict(reference.single_abundance(
        {"X": 30, "Y": 10, "X-Y": 40, "X-Y-Z": 1}, True))
    assert set(prob) == {"X", "Y"}
    assert prob["X"] == pytest.approx(0.75, abs=1e-3)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import gen, reference, "
            "check, tiny; sp = gen.catalog_specs(tiny.config()); "
            "g = [reference.RefGene(k, v) for k, v in sp.items()]; "
            "_, a, b = gen.draw_sample(sp, tiny.MIX, 1, 0); "
            "reference.type_sample(g, reference.Placer(g), a, b); "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'hgtpu_torch', 'hgtpu', 'jax', 'jaxlib', 'flax', 'torch'}; "
            "print(sorted(bad))" % tiny.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(__file__),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
