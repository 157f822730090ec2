# Port of __graft_entry__.py: the same two entry points, on torch
# devices, with the port's own copies of the tiny gene and reads.
"""Entry points.

entry(): the single-device forward step of the flagship compute path —
diagonal placement over the variant-aware backbone PWM (kernel K1 and
the diagonal top-k), the replacement for HISAT2's graph alignment inner
loop.  Returns (fn, args) with the args on the default device.

dryrun_multichip(n): the connected end-to-end typing program over a
mesh of n shards (parallel.sharded.make_mesh: n shards on `device`, or
the visible cards in turn): reads from a known truth allele are placed,
spelled, counted and rescued through the production path
(type_reads_device), then typed again by the pure-device EM program
(ShardedTyper.call_allele); both must call the truth.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _synthetic_reads(n_reads=256, read_len=100, backbone_len=3072, seed=0):
    rng = np.random.default_rng(seed)
    pwm = np.zeros((backbone_len, 5), np.float32)
    pwm[np.arange(backbone_len), rng.integers(0, 4, backbone_len)] = 1.0
    pwm_ext = np.concatenate([pwm, np.zeros((read_len, 5), np.float32)])
    reads = rng.integers(0, 4, (n_reads, read_len)).astype(np.int8)
    return pwm_ext, reads


def _tiny_gene(backbone_len=768, n_snp=30, n_del=6, n_ins=4,
               n_alleles=64, seed=0):
    """Coherent mixed-variant GeneRef (SNPs + catalog deletions +
    insertions, the full variant model of typing_common.py:339-368):
    alleles are distinct variant subsets, so every allele's sequence is
    reconstructible and identifiable.  Variants sit >=8 bp apart so no
    allele stacks two events on the same base."""
    from .db.catalog import GeneRef, VT_DELETION, VT_INSERTION, VT_SINGLE

    rng = np.random.default_rng(seed)
    bb = "".join("ACGT"[i] for i in rng.integers(0, 4, backbone_len))
    n_vars = n_snp + n_del + n_ins
    pos = np.sort(rng.choice(np.arange(1, (backbone_len - 16) // 8, 1),
                             n_vars, replace=False) * 8).astype(np.int32)
    kinds = np.array([VT_SINGLE] * n_snp + [VT_DELETION] * n_del
                     + [VT_INSERTION] * n_ins, np.int8)
    rng.shuffle(kinds)
    var_data, var_len = [], np.ones(n_vars, np.int32)
    for i, p in enumerate(pos):
        if kinds[i] == VT_SINGLE:
            var_data.append("ACGT"[("ACGT".index(bb[p]) + 1) % 4])
        elif kinds[i] == VT_DELETION:
            var_len[i] = int(rng.integers(1, 5))
            var_data.append(str(var_len[i]))
        else:
            var_len[i] = int(rng.integers(1, 4))
            var_data.append("".join(
                "ACGT"[b] for b in rng.integers(0, 4, var_len[i])))
    while True:
        links = rng.random((n_vars, n_alleles)) < 0.3
        links[:, 0] = False                       # clean reference allele
        if len({tuple(links[:, a]) for a in range(n_alleles)}) == n_alleles:
            break
    return GeneRef(
        gene="T", backbone_name="T*BACKBONE", backbone=bb,
        allele_names=["T*%02d" % i for i in range(n_alleles)],
        var_ids=["hv%d" % i for i in range(n_vars)],
        var_type=kinds,
        var_pos=pos,
        var_len=var_len,
        var_data=var_data,
        var_freq=np.full(n_vars, 50.0, np.float32),
        links=links,
        exons=[(0, backbone_len - 1)],
        primary_exons=[(0, backbone_len - 1)],
        haplotypes=[],
    )


def entry(device=None):
    from .ops.placement import place_batch

    dev = resolve_device(device)
    pwm_ext, reads = _synthetic_reads()

    def fn(pwm_ext, reads):
        return place_batch(pwm_ext, reads, top_k=4)

    return fn, (torch.from_numpy(pwm_ext).to(dev),
                torch.from_numpy(reads).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the PRODUCTION typing path over an n-shard mesh: the
    pileup-gated class program with the host engine rescuing exactly the
    punt mask — no read is ever dropped (the reference never drops
    in-budget reads, typing_core.py:800-1543) — then the pure-device EM
    program on the same mesh."""
    from .db.catalog import VT_DELETION, VT_INSERTION
    from .parallel.e2e import ShardedTyper
    from .parallel.production import type_reads_device
    from .parallel.sharded import make_mesh
    from .typer import TypingOptions

    mesh = make_mesh(n_devices, device)
    gene = _tiny_gene()

    # truth carries BOTH a catalog deletion and an insertion, so the
    # program's split-diagonal spelling is on the line
    truth = next(
        a for i, a in enumerate(gene.allele_names)
        if gene.links[gene.var_type == VT_DELETION, i].any()
        and gene.links[gene.var_type == VT_INSERTION, i].any())
    seq = gene.allele_seq(truth)
    reads = [seq[i:i + 64] for i in range(0, len(seq) - 63, 3)]
    # mix in reverse-complement reads to exercise orientation selection
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    reads = [r if i % 2 == 0 else "".join(rc[c] for c in reversed(r))
             for i, r in enumerate(reads)]
    named = [("r%d" % i, r) for i, r in enumerate(reads)]

    opts = TypingOptions(simulation=True, allow_discordant=True,
                         device_typing="on")
    res = type_reads_device(gene, named, None, opts, mesh=mesh)
    name, prob_top = res.prob[0]
    assert name == truth, "called %s, truth %s" % (name, truth)
    assert prob_top > 0.9999, "truth abundance %.6f" % prob_top
    # the punt->host rescue merge makes the path lossless: every read
    # counts (device-resolved or rescued)
    assert res.num_pairs == len(reads), \
        "dropped %d/%d reads" % (len(reads) - res.num_pairs, len(reads))
    assert res.num_reads == len(reads)

    # the pure-device EM program must also run on this mesh
    typer = ShardedTyper(gene, read_len=64, em_iters=100, mesh=mesh)
    codes = typer.encode(reads)
    dname, dprob, totals, n_used = typer.call_allele(codes)
    assert dname == truth
    assert totals.shape == (gene.n_alleles,)
