"""hgtpu_torch stands alone: a subprocess with jax and hgtpu blocked
imports every module of the port, builds and simulates a tiny gene with
the port's own db and sim, and types it on the host-engine path and on
the production path (one shard, two shards, and a one-rank gloo world
through parallel.multihost), assembles and phases it (assembly=True),
types a
3-gene family, searches an FM index, extracts reads against a genotype
genome, runs the command line's simulation on a text database the port
wrote and the toolkit's compare, and the golden run hg_test1 (its
`python -m hgtpu_torch` child blocked too); and no source file of the
port (hgtpu_torch.devel included), nor chip_smoke.py or measure_gpu.py,
imports jax or hgtpu.  Every port test file takes the one thread policy
of tests/torch_threads.py and defines no thread fixture of its own."""
import ast
import os
import subprocess
import sys

from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["hgtpu"] = None        # and any import of the JAX package
import torch
import hgtpu_torch
walked = set()
for m in pkgutil.walk_packages(hgtpu_torch.__path__, "hgtpu_torch."):
    importlib.import_module(m.name)
    walked.add(m.name)
assert {"hgtpu_torch.devel." + m for m in
        ("testdb", "golden", "campaign", "scaling", "punts", "edges")
        } <= walked, walked
sys.path.insert(0, "tests")
from synth import make_gene_msa
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.sim import simulate_reads
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
# guided assembly and phasing
res = type_reads(gene, [(r.name, r.seq) for r in r1],
                 [(r.name, r.seq) for r in r2],
                 TypingOptions(simulation=True, assembly=True), device="cpu")
assert res.assembly_call is not None and res.contigs, res.assembly_call
assert res.assembly_call[0] == [truth, truth], res.assembly_call
# device verify (the DP's plain version) and the pure-device programs
from hgtpu_torch.align import GeneAligner
from hgtpu_torch.align.native_verify import native_available
from hgtpu_torch.entry import dryrun_multichip
from hgtpu_torch.parallel.e2e import ShardedTyper
if native_available():
    res = type_reads(gene, [(r.name, r.seq) for r in r1],
                     [(r.name, r.seq) for r in r2],
                     TypingOptions(simulation=True), device="cpu",
                     aligner=GeneAligner(gene, device_verify="on",
                                         device="cpu"))
    assert res.prob[0][0] == truth, res.prob[:3]
st = ShardedTyper(gene, "cpu", em_iters=50)
prob = st.call_pairs(st.encode([r.seq for r in r1]),
                     st.encode([r.seq for r in r2]))[0]
assert gene.allele_names[int(prob.argmax())] == truth
dryrun_multichip(1, device="cpu")
# many devices: a 2-shard mesh, and a one-rank gloo world typing through
# the multi-process merges
import socket
from hgtpu_torch.parallel import multihost, sharded
dryrun_multichip(2, device="cpu")
sock = socket.socket()
sock.bind(("localhost", 0))
port = sock.getsockname()[1]
sock.close()
assert multihost.init_distributed("localhost:%d" % port, 1, 0,
                                  device="cpu") == (0, 1)
res = multihost.type_reads_device_distributed(
    gene, [(r.name, r.seq) for r in r1], [(r.name, r.seq) for r in r2],
    TypingOptions(simulation=True, device_typing="on"),
    mesh=sharded.make_mesh(2, "cpu"))
assert res.prob[0][0] == truth, res.prob[:3]
torch.distributed.destroy_process_group()
# family typing through the router, an FM search, genome extraction
import tempfile
from synth import make_family
from hgtpu_torch.db import build_catalog_from_msa, build_genotype_genome
from hgtpu_torch.ops.fm import FMIndex, pack_queries
from hgtpu_torch.pipeline import GenomeExtractor, type_family
from hgtpu_torch.utils.dna import encode_seq
fam = make_family(genes=("A", "B", "C"), n_alleles=8, length=900, seed=5)
cat = build_catalog_from_msa("hla", {
    g: dict(names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"])
    for g, s in fam["specs"].items()}, min_var_freq=0.0)
truths = {g: cat.genes[g].allele_names[3] for g in cat.genes}
f1, f2 = [], []
for g, a in truths.items():
    r1, r2, _ = simulate_reads(cat.genes[g], [a], simulate_interval=10,
                               seed=4)
    f1 += [(g + r.name, r.seq) for r in r1]
    f2 += [(g + r.name, r.seq) for r in r2]
res = type_family(cat, f1, f2, device="cpu")
assert {g: r.prob[0][0] for g, r in res.items()} == truths
genome = fam["genome"]
fm = FMIndex(encode_seq(genome), checkpoint=True, device="cpu")
lo, hi = fm.search_batch(pack_queries([genome[500:530]], 30))
assert hi[0] - lo[0] == 1 and fm.sa[lo[0]] == 500
for g, (l, r) in fam["loci"].items():
    cat.genes[g].chrom, cat.genes[g].chrom_left, cat.genes[g].chrom_right = \
        "chrS", l, r
with tempfile.TemporaryDirectory() as tmp:
    spliced, offsets = build_genotype_genome({"chrS": genome}, {"hla": cat},
                                             tmp + "/gg")
routed = GenomeExtractor(spliced, offsets, {"hla": cat},
                         device="cpu").extract(f1, f2)
assert len(routed["hla"][0]) >= 0.9 * len(f1)
# the command line: a simulation on a text database the port wrote
from hgtpu_torch.cli.main import main
from hgtpu_torch.db import Catalog
from hgtpu_torch.db.catalog import export_text
with tempfile.TemporaryDirectory() as tmp:
    export_text(Catalog(family="hla", genes={"A": gene}), tmp + "/hla")
    rc = main(["--base", "hla", "--ix-dir", tmp, "--locus-list", "A",
               "--debug", "basic,test_size:1,set_seed:3",
               "--simulate-interval", "8", "--out-dir", tmp + "/out"],
              device="cpu")
    assert rc == 0
    assert os.listdir(tmp + "/out") == ["assembly_graph-hla.test-1.report"]
    from hgtpu_torch.cli import toolkit
    with open(tmp + "/calls.tsv", "w") as f:
        f.write("s1\tA*01:01:01\t0.6\ns1\tA*02:05\t0.4\n")
    with open(tmp + "/truth.tsv", "w") as f:
        f.write("s1\tA*01:01\ns1\tA*02:05\n")
    assert toolkit.main(["compare", tmp + "/calls.tsv", tmp + "/truth.tsv",
                         "--genes", "A"], device="cpu") == 0
# the golden command-line run hg_test1, its `python -m hgtpu_torch`
# child blocked too (sitecustomize; HGTPU_TORCH_DEVICE=cpu)
from hgtpu_torch.devel import golden
with tempfile.TemporaryDirectory() as tmp:
    assert golden.main(["--only", "hg_test1", "--db", tmp + "/db",
                        "--out-dir", tmp + "/out"]) == 0
assert sys.modules["jax"] is None and sys.modules["hgtpu"] is None
assert type(gene).__module__ == "hgtpu_torch.db.catalog"
print("TYPED", truth)
"""


_BLOCK = """import sys
sys.modules["jax"] = None
sys.modules["hgtpu"] = None
"""


def test_port_runs_with_jax_blocked(tmp_path):
    # a sitecustomize blocks jax and hgtpu in the script and in every
    # python process it starts (the golden run's command line)
    (tmp_path / "sitecustomize.py").write_text(_BLOCK)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]),
               HGTPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TYPED" in proc.stdout
    assert "[OK] expected hg_test1.test-2.report" in proc.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    pkg = os.path.join(ROOT, "hgtpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "measure_gpu.py")


def test_no_source_imports_jax():
    paths = list(_sources())
    assert len(paths) > 30
    devel = os.path.join(ROOT, "hgtpu_torch", "devel")
    assert {os.path.join(devel, m + ".py") for m in
            ("__init__", "testdb", "golden", "campaign", "scaling", "punts",
             "edges")} <= set(paths)
    for path in paths:
        for name in _imports(path):
            # hgtpu_torch is the port itself; jax and hgtpu are refused
            assert name.split(".")[0] not in ("jax", "hgtpu"), (path, name)


def test_every_port_test_file_takes_the_shared_thread_policy():
    files = sorted(f for f in os.listdir(os.path.join(ROOT, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(files) > 40
    for f in files:
        tree = ast.parse(open(os.path.join(ROOT, "tests", f)).read(), f)
        # the card's test files import it from tests/ on sys.path, as
        # they import synth: an installed package named tests shadows ours
        assert any(isinstance(node, ast.ImportFrom)
                   and node.module in ("tests.torch_threads", "torch_threads")
                   and "_torch_threads" in [a.name for a in node.names]
                   for node in tree.body), f
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and any(
                    "fixture" in ast.unparse(d) for d in fn.decorator_list):
                assert not any(
                    isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute)
                    and c.func.attr == "set_num_threads"
                    for c in ast.walk(fn)), (f, fn.name)
