"""The port's multi-process typing over torch.distributed equals one
process, and hgtpu.

Two ranks on the CPU, each its own ``sys.executable`` process joined by
gloo (``init_distributed(..., device="cpu")``); every worker asserts that
neither jax nor hgtpu was imported.  The counterparts of
tests/test_multihost.py:

  distributed_call   2 ranks x 4 CPU shards (``global_mesh``) run the
                     pure-device EM on their halves of the padded codes;
                     both ranks print the same call, equal to one
                     process's ``call_allele`` on an 8-shard mesh: the
                     same allele, prob within 1e-6 (float32 sums taken in
                     another order), n_used exact.
  lossless typing    ``type_reads_device_distributed`` on
                     make_gene_msa(seed=3, n_alleles=40) at 3 % per-base
                     error, each rank typing its half of the pairs on a
                     local mesh of 2 CPU shards: both ranks return the
                     same result, equal exactly (cmpt, exon cmpt, prob,
                     num_reads, num_pairs, novel variants) to the port's
                     single-process ``type_reads_device`` and to hgtpu's.
  novel variants     each rank's half of the pairs carries an
                     out-of-catalog SNP of its own (planted_pairs), with
                     the simulator's read names and with names that sort
                     the second half first: both variants are
                     registered, and the result equals one process's and
                     hgtpu's, novel ids included (one process numbers
                     them in sorted read-id order, not in rank order).
  host merges        _gather_parts over ranks whose arrays differ in
                     rows and width (zero rows included), _allsum, and
                     the merge of the ranks' novel-variant registries:
                     variants are numbered by the read id that first
                     registered them, so one id given to two variants on
                     two ranks becomes two ids, in read-id order.

Each worker has a time limit; when one fails, every rank is killed.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, %r)
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    pid, port = int(sys.argv[1]), sys.argv[2]
    from hgtpu_torch.parallel.multihost import init_distributed
    assert init_distributed("localhost:" + port, 2, pid,
                            device="cpu") == (pid, 2)

    def done():
        # leave the group together: a gloo group torn down at exit while
        # its peer still talks can abort the process
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        assert "jax" not in sys.modules and "hgtpu" not in sys.modules
        print("CLEAN", flush=True)
""" % (ROOT, os.path.join(ROOT, "tests")))

_CALL = _PRELUDE + textwrap.dedent("""
    from hgtpu_torch.entry import _tiny_gene
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.multihost import (distributed_call,
                                                global_mesh, pad_reads,
                                                process_read_shard)

    gene = _tiny_gene()
    mesh = global_mesh(["cpu"] * 4)
    assert mesh.size == 8
    typer = ShardedTyper(gene, read_len=64, em_iters=100, mesh=mesh)
    seq = gene.allele_seq(gene.allele_names[23])
    reads = [seq[i:i + 64] for i in range(0, len(seq) - 63, 3)]
    codes = pad_reads(typer.encode(reads), 8)
    start, stop = process_read_shard(codes.shape[0])
    prob, totals, n_used, punt_local = distributed_call(
        typer, codes[start:stop])
    # the punt mask is returned per process, covering its rows exactly
    assert punt_local.shape[0] == stop - start, punt_local.shape
    top = int(np.argmax(prob))
    print("RESULT " + json.dumps([gene.allele_names[top], float(prob[top]),
                                  float(n_used),
                                  np.asarray(totals).tolist()]), flush=True)
    done()
""")

_PROD = _PRELUDE + textwrap.dedent("""
    from synth import make_gene_msa
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.db.catalog import VT_DELETION, VT_INSERTION
    from hgtpu_torch.parallel.multihost import type_reads_device_distributed
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.typer.engine import TypingOptions

    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=8.0)
    d = ref.var_type == VT_DELETION
    ins = ref.var_type == VT_INSERTION
    t_indel = next(n for a, n in enumerate(ref.allele_names)
                   if ref.links[d, a].any() and ref.links[ins, a].any())
    r1, r2, _ = simulate_reads(ref, [t_indel], simulate_interval=3,
                               read_len=100, frag_len=250, seed=11,
                               perbase_errorrate=0.03)
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    n = len(R1)
    lo, hi = (0, n // 2) if pid == 0 else (n // 2, n)
    res = type_reads_device_distributed(
        ref, R1[lo:hi], R2[lo:hi],
        TypingOptions(simulation=True, device_typing="on"),
        global_start=lo, n_global=n, mesh=make_mesh(2, "cpu"))
    print("RESULT " + json.dumps([
        list(res.cmpt.items()), list(res.exon_cmpt.items()), res.prob,
        res.num_reads, res.num_pairs, list(res.novel_vars.items())]),
        flush=True)
    done()
""")

_NOVEL = _PRELUDE + textwrap.dedent("""
    from tests.test_torch_multihost import planted_pairs
    from hgtpu_torch.parallel.multihost import type_reads_device_distributed
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu_torch.typer.engine import TypingOptions

    ref, R1, R2 = planted_pairs(sys.argv[3] == "reversed")
    n = len(R1)
    lo, hi = (0, n // 2) if pid == 0 else (n // 2, n)
    res = type_reads_device_distributed(
        ref, R1[lo:hi], R2[lo:hi],
        TypingOptions(simulation=True, device_typing="on"),
        global_start=lo, n_global=n, mesh=make_mesh(1, "cpu"))
    print("RESULT " + json.dumps([
        list(res.cmpt.items()), list(res.exon_cmpt.items()), res.prob,
        res.num_reads, res.num_pairs, list(res.novel_vars.items())]),
        flush=True)
    done()
""")

_MERGES = _PRELUDE + textwrap.dedent("""
    from hgtpu_torch.parallel.multihost import (_allsum, _gather_parts,
                                                _merge_novel_meta)

    # shapes differ by rank, zero rows and a ragged width included
    mine = [np.arange(6, dtype=np.uint32).reshape(2, 3),
            np.zeros((0, 5), np.uint32)][pid]
    got = _gather_parts(mine)
    assert [g.shape for g in got] == [(2, 3), (0, 5)], got
    assert all(g.dtype == np.uint32 for g in got)
    assert np.array_equal(got[0], np.arange(6).reshape(2, 3))
    assert _allsum(np.array([pid + 1], np.int64)).tolist() == [3]

    # one variant on both ranks keeps its first place: rank 0 read "3"
    # registers it before rank 1's "7"; each rank's own variant follows
    # in read-id order
    shared = {"nv0": ("mismatch", 120, "A")}
    own = {"nv1": ("deletion", 300 + pid, "2")}
    merged = _merge_novel_meta({**shared, **own},
                               {"nv0": "37"[pid], "nv1": "48"[pid]})
    assert list(merged.items()) == [
        ("nv0", ("mismatch", 120, "A")), ("nv1", ("deletion", 300, "2")),
        ("nv2", ("deletion", 301, "2"))], merged
    # one id, two variants: two ids, numbered by read id, so rank 1's
    # variant (read "10") precedes rank 0's (read "9")
    clash = {"nv0": ("mismatch", 120, "ACGT"[pid])}
    merged = _merge_novel_meta(clash, {"nv0": ["9", "10"][pid]})
    assert list(merged.items()) == [("nv0", ("mismatch", 120, "C")),
                                    ("nv1", ("mismatch", 120, "A"))], merged
    # within one read, the rank's registration order
    both = {"nv0": ("single", 5, "T"), "nv1": ("single", 2, "G")}
    merged = _merge_novel_meta(both if pid == 0 else {},
                               {"nv0": "4", "nv1": "4"})
    assert list(merged.values()) == list(both.values()), merged
    print("RESULT " + json.dumps("merged"), flush=True)
    done()
""")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def planted_pairs(reversed_names=False):
    """The port's make_gene_msa(seed=3, n_alleles=40) gene and pairs of
    one of its alleles in which every read of the first half of the
    pairs that covers allele position L/4 carries an out-of-catalog SNP,
    and every read of the second half that covers 3L/4 another one.
    With `reversed_names` the fragments are renamed so that the second
    half's ids sort before the first half's."""
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads
    from hgtpu_torch.utils.dna import revcomp
    from tests.synth import make_gene_msa

    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=8.0)
    seq = ref.allele_seq(ref.allele_names[5])
    r1, r2, _ = simulate_reads(ref, [ref.allele_names[5]],
                               simulate_interval=3, seed=11)

    def plant(read, q, forward):
        fwd = read if forward else revcomp(read)
        o = seq.find(fwd)
        if o < 0 or not o <= q < o + len(fwd):
            return read
        base = "ACGT"["ACGT".index(fwd[q - o]) ^ 2]
        fwd = fwd[:q - o] + base + fwd[q - o + 1:]
        return fwd if forward else revcomp(fwd)

    half = len(r1) // 2
    R1, R2 = [], []
    for i, (a, b) in enumerate(zip(r1, r2)):
        q = len(seq) // 4 if i < half else 3 * len(seq) // 4
        name_1, name_2 = a.name, b.name
        if reversed_names:
            tag = "%s%05d" % ("ba"[i >= half], i)
            name_1 = tag + a.name[a.name.index("|"):]
            name_2 = tag + b.name[b.name.index("|"):]
        R1.append((name_1, plant(a.seq, q, True)))
        R2.append((name_2, plant(b.seq, q, False)))
    return ref, R1, R2


def run_ranks(worker, timeout, *args):
    """Both ranks' RESULT values; every rank is killed if one fails or
    runs past `timeout` seconds."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), port, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT) for i in range(2)]
    results = {}
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            lines = out.splitlines()
            assert "CLEAN" in lines, out[-2000:]
            results[i] = [json.loads(line[len("RESULT "):])
                          for line in lines if line.startswith("RESULT ")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert set(results) == {0, 1} and all(len(r) == 1 for r in
                                         results.values()), results
    return results[0][0], results[1][0]


def test_distributed_call_equals_one_process():
    import numpy as np

    from hgtpu_torch.entry import _tiny_gene
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.multihost import pad_reads
    from hgtpu_torch.parallel.sharded import make_mesh

    r0, r1 = run_ranks(_CALL, 300)
    # identical replicated results on both ranks
    assert r0 == r1
    name, prob, n_used, totals = r0
    assert name == "T*23" and prob > 0.99

    gene = _tiny_gene()
    typer = ShardedTyper(gene, read_len=64, em_iters=100,
                         mesh=make_mesh(8, "cpu"))
    seq = gene.allele_seq("T*23")
    reads = [seq[i:i + 64] for i in range(0, len(seq) - 63, 3)]
    sp_name, sp_prob, sp_totals, sp_used = typer.call_allele(
        pad_reads(typer.encode(reads), 8))
    assert sp_name == name
    assert abs(sp_prob - prob) < 1e-6
    assert sp_used == n_used
    assert np.array_equal(np.asarray(sp_totals), np.asarray(totals))


def test_production_typing_lossless_equals_one_process_and_hgtpu():
    from hgtpu.db import build_gene_ref as jax_build
    from hgtpu.db.catalog import VT_DELETION, VT_INSERTION
    from hgtpu.parallel.production import type_reads_device as jax_device
    from hgtpu.parallel.sharded import make_mesh as jax_mesh
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import TypingOptions as JaxOptions
    from hgtpu_torch.parallel.production import type_reads_device
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu_torch.typer.engine import TypingOptions
    from tests.synth import make_gene_msa
    from tests.test_torch_db import carried

    r0, r1 = run_ranks(_PROD, 600)
    assert r0 == r1
    cmpt, exon_cmpt, prob, num_reads, num_pairs, novel = r0

    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = jax_build("A", spec["names"], spec["rows"], spec["ref_allele"],
                       min_var_freq=8.0)
    d = ref.var_type == VT_DELETION
    ins = ref.var_type == VT_INSERTION
    t_indel = next(n for a, n in enumerate(ref.allele_names)
                   if ref.links[d, a].any() and ref.links[ins, a].any())
    s1, s2, _ = simulate_reads(ref, [t_indel], simulate_interval=3,
                               read_len=100, frag_len=250, seed=11,
                               perbase_errorrate=0.03)
    R1 = [(r.name, r.seq) for r in s1]
    R2 = [(r.name, r.seq) for r in s2]
    single = type_reads_device(
        carried(ref), R1, R2,
        TypingOptions(simulation=True, device_typing="on"),
        mesh=make_mesh(2, "cpu"))
    want = jax_device(ref, R1, R2,
                      JaxOptions(simulation=True, device_typing="on"),
                      mesh=jax_mesh(2))
    for res in (single, want):
        assert [list(x) for x in res.cmpt.items()] == cmpt
        assert [list(x) for x in res.exon_cmpt.items()] == exon_cmpt
        assert [list(x) for x in res.prob] == prob
        assert (res.num_reads, res.num_pairs) == (num_reads, num_pairs)
        assert [[k, list(v)] for k, v in res.novel_vars.items()] == novel
    # no pair is lost to the distribution
    assert num_pairs >= 0.99 * len(R1)


@pytest.mark.parametrize("names", ["simulated", "reversed"])
def test_novel_variants_on_two_ranks_equal_one_process_and_hgtpu(names):
    from hgtpu.parallel.production import type_reads_device as jax_device
    from hgtpu.parallel.sharded import make_mesh as jax_mesh
    from hgtpu.typer.engine import TypingOptions as JaxOptions
    from hgtpu_torch.parallel.production import type_reads_device
    from hgtpu_torch.parallel.sharded import make_mesh
    from hgtpu.db import build_gene_ref as jax_build
    from hgtpu_torch.typer.engine import TypingOptions
    from tests.synth import make_gene_msa

    r0, r1 = run_ranks(_NOVEL, 600, names)
    assert r0 == r1
    cmpt, exon_cmpt, prob, num_reads, num_pairs, novel = r0
    # both planted SNPs registered: the first half's (at L/4) first when
    # the read ids follow the halves, the second half's first when they
    # sort the other way
    assert [k for _, (k, _p, _d) in novel] == ["single", "single"], novel
    (_, (_, p0, _)), (_, (_, p1, _)) = novel
    assert (p0 < p1) == (names == "simulated"), novel
    ref, R1, R2 = planted_pairs(names == "reversed")
    spec = make_gene_msa(seed=3, n_alleles=40)
    jref, _ = jax_build("A", spec["names"], spec["rows"], spec["ref_allele"],
                        min_var_freq=8.0)
    single = type_reads_device(
        ref, R1, R2, TypingOptions(simulation=True, device_typing="on"),
        mesh=make_mesh(1, "cpu"))
    want = jax_device(jref, R1, R2,
                      JaxOptions(simulation=True, device_typing="on"),
                      mesh=jax_mesh(1))
    for res in (single, want):
        assert [list(x) for x in res.cmpt.items()] == cmpt
        assert [list(x) for x in res.exon_cmpt.items()] == exon_cmpt
        assert [list(x) for x in res.prob] == prob
        assert (res.num_reads, res.num_pairs) == (num_reads, num_pairs)
        assert [[k, list(v)] for k, v in res.novel_vars.items()] == novel


def test_host_merges_and_checked_novel_merge():
    assert run_ranks(_MERGES, 120) == ("merged", "merged")
