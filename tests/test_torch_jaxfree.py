"""hgtpu_torch runs where jax cannot be imported: a subprocess with jax
blocked imports every module of the port and types a tiny gene on the
host-engine path and on the production path, and no source file of the
port imports jax."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import torch
torch.set_num_threads(2)
import hgtpu_torch
for m in pkgutil.walk_packages(hgtpu_torch.__path__, "hgtpu_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, "tests")
from synth import make_gene_msa
from hgtpu.db import build_gene_ref
from hgtpu.sim import simulate_reads
from hgtpu_torch.pipeline import type_reads
from hgtpu_torch.typer import TypingOptions
spec = make_gene_msa(seed=3, n_alleles=12, length=900)
gene, _ = build_gene_ref("A", spec["names"], spec["rows"],
                         spec["ref_allele"], min_var_freq=0.0)
truth = gene.allele_names[7]
r1, r2, _ = simulate_reads(gene, [truth], simulate_interval=8, seed=2)
for kw in (dict(device_counting="off"), dict(device_counting="on"),
           dict(device_typing="on")):
    res = type_reads(gene, [(r.name, r.seq) for r in r1],
                     [(r.name, r.seq) for r in r2],
                     TypingOptions(simulation=True, **kw), device="cpu")
    assert res.prob[0][0] == truth, res.prob[:3]
assert sys.modules["jax"] is None
print("TYPED", truth)
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TYPED" in proc.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    pkg = os.path.join(ROOT, "hgtpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for name in _imports(path):
                assert name.split(".")[0] != "jax", (path, name)
                # only hgtpu's jax-free packages may be borrowed
                if name.split(".")[0] == "hgtpu":
                    assert name.split(".")[1] in (
                        "db", "sim", "utils", "native", "validate"), \
                        (path, name)
