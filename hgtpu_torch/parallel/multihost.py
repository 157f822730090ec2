# Port of hgtpu/parallel/multihost.py: jax.distributed and its host
# collectives as torch.distributed; the lossless merge is a copy, with the
# novel variants numbered as one process numbers them.
"""Multi-process scaffolding: `torch.distributed` init and the read-shard
distribution.

The reference scales across hosts by running independent processes over
manually-striped sample lists (`--job-range`, hisatgenotype_args.py:235)
and merging text output.  The device equivalent: every process (rank)
joins one `torch.distributed` group, loads only its contiguous shard of
the global read set (reads never cross ranks), and either

- runs the pure-device EM program over a mesh that spans the ranks
  (``global_mesh``, ``distributed_call``): the per-allele evidence and
  the EM numerators ride the group through ``Mesh.psum``'s
  ``all_reduce``, or
- types its shard with the production program on a mesh local to the
  rank and merges three small host-level results over the group
  (``type_reads_device_distributed``): lossless, equal to one process
  typing the concatenated reads.

Backends.  On a card the default is ``"cpu:gloo,cuda:nccl"``: tensors on
the card reduce over NCCL, the host merges' CPU tensors over gloo.  NCCL
refuses two ranks on one card, so ranks that share a card ask for
``backend="gloo"``, whose ``all_reduce`` also takes CUDA tensors.  The
host merges always gather CPU tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import default_device, resolve_device
from .sharded import Mesh


def _rank_card() -> torch.device:
    """The card this rank set with torch.cuda.set_device (raises without
    a card)."""
    default_device()
    return torch.device("cuda", torch.cuda.current_device())


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None):
    """Join (or start) the distributed job; returns (rank, world size).

    Arguments fall back to HGTPU_COORDINATOR (host:port),
    HGTPU_NUM_PROCESSES and HGTPU_PROCESS_ID, then to torchrun's
    MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK.  `device` None
    means this rank's card (LOCAL_RANK's, else the process id's, modulo
    the cards), set as the current card before the group starts; pass
    "cpu" to run on the CPU.  `backend` None means "cpu:gloo,cuda:nccl"
    on a card and "gloo" on the CPU."""
    import torch.distributed as dist

    env = os.environ
    addr = coordinator_address or env.get("HGTPU_COORDINATOR")
    if addr is None and "MASTER_ADDR" in env:
        addr = "%s:%s" % (env["MASTER_ADDR"], env.get("MASTER_PORT", "29500"))
    if num_processes is None:
        n = env.get("HGTPU_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if n is None else int(n)
    if process_id is None:
        r = env.get("HGTPU_PROCESS_ID", env.get("RANK"))
        process_id = None if r is None else int(r)
    if addr is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id (arguments, HGTPU_COORDINATOR / "
            "HGTPU_NUM_PROCESSES / HGTPU_PROCESS_ID, or torchrun's "
            "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK)")
    if device is None:
        default_device()                       # raises without a card
        local = int(env.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else "tcp://" + addr,
        world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(devices=None) -> Mesh:
    """hgtpu's 1-D mesh over every device of every process: this rank's
    shard devices (default: its card; a device or a list of them, the same
    length on every rank) joined by the default process group."""
    import torch.distributed as dist

    if devices is None:
        devices = [_rank_card()]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    return Mesh(devices, group=dist.group.WORLD)


def process_read_shard(n_total: int, process_index=None,
                       process_count=None):
    """[start, stop) of this process's contiguous block of the global
    read set.  n_total must divide evenly (pad first: the typing weights
    zero out pad reads)."""
    import torch.distributed as dist

    pi = dist.get_rank() if process_index is None else process_index
    pc = dist.get_world_size() if process_count is None else process_count
    if n_total % pc:
        raise ValueError("pad the global read count to a multiple of %d"
                         % pc)
    per = n_total // pc
    return pi * per, (pi + 1) * per


def pad_reads(codes: np.ndarray, multiple: int):
    """Pad read codes with all-N rows up to `multiple` (pad reads carry
    zero weight through the verify gate)."""
    n = codes.shape[0]
    extra = (-n) % multiple
    if extra:
        codes = np.concatenate(
            [codes, np.full((extra, codes.shape[1]), 4, np.int8)])
    return codes


def distributed_call(typer, local_codes: np.ndarray):
    """Run a `ShardedTyper` device-EM step whose mesh spans the ranks
    (``global_mesh``), this process contributing only its local read
    shard; returns the replicated (prob, totals, n_used) and punt_local.
    punt_local is THIS process's slice of the punt mask — the caller must
    rescue those reads (the production path
    `type_reads_device_distributed` does all of this, losslessly; this
    entry is the bare device-EM building block)."""
    return typer.count_em_global(np.ascontiguousarray(local_codes))


# ------------------------------------------------------------------------- #
# host collectives (CPU tensors over the default group)
# ------------------------------------------------------------------------- #
def _gather_parts(arr):
    """Allgather an array whose shape may differ by rank: returns one
    array per rank, trimmed to its own shape.  all_gather needs equal
    sizes, so the shapes travel first and every dimension pads to the
    largest; the rows travel as bytes."""
    import torch.distributed as dist

    arr = np.ascontiguousarray(arr)
    world = dist.get_world_size()
    shape = torch.tensor(arr.shape, dtype=torch.int64)
    shapes = [torch.empty_like(shape) for _ in range(world)]
    dist.all_gather(shapes, shape)
    shapes = [tuple(int(x) for x in s) for s in shapes]
    top = np.max(np.array(shapes, np.int64).reshape(world, arr.ndim), 0)
    top[0] = max(int(top[0]), 1)
    buf = np.zeros(tuple(int(x) for x in top), arr.dtype)
    buf[tuple(slice(0, n) for n in arr.shape)] = arr
    raw = torch.from_numpy(buf.reshape(-1).view(np.uint8))
    outs = [torch.empty_like(raw) for _ in range(world)]
    dist.all_gather(outs, raw)
    return [o.numpy().view(arr.dtype).reshape(buf.shape)[
        tuple(slice(0, n) for n in s)] for o, s in zip(outs, shapes)]


def _allreduce(arr, op=None):
    import torch.distributed as dist

    t = torch.from_numpy(np.array(arr, copy=True))
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return t.numpy()


def _allsum(arr):
    return _allreduce(arr)


def _merge_novel_meta(meta, first_read):
    """Every rank's novel-variant registry merged and numbered as one
    process numbers it.  One process registers in the rescue's sorted
    fragment-read-id order, so each variant is placed at the least read id
    (`first_read`: id -> the read id of its registration) under which any
    rank registered it, a rank's own order breaking ties within a read,
    and the ids are given anew in that order.  The ranks' ids name
    nothing else in the result (class rows and cmpt names carry allele
    sets), so nothing else is renamed.  hgtpu merges by id instead, and
    where two ranks gave one id to two variants it keeps the last."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size()
    dist.all_gather_object(
        parts, [(what, first_read[vid]) for vid, what in meta.items()])
    first = {}
    for rank, part in enumerate(parts):
        for i, (what, read) in enumerate(part):
            at = (read, rank, i)
            if what not in first or at < first[what]:
                first[what] = at
    return {"nv%d" % i: what
            for i, what in enumerate(sorted(first, key=first.get))}


def type_reads_device_distributed(gene, reads_1, reads_2=None, opts=None,
                                  global_start: int = 0,
                                  n_global: int = None, mesh=None,
                                  device=None):
    """Lossless multi-process production typing (the reference's merge
    semantics, hisatgenotype:613-665, with device programs).

    Each process passes ONLY its local shard of the global read set
    (`reads_*`; `global_start` = the shard's offset, `n_global` = total
    reads across processes).  The process types its shard on its LOCAL
    mesh (`mesh`, default one shard on `device`, default this rank's
    card) — placement, tiered spelling, gate, counting — and three small
    host-level merges ride the process group:

      1. the device pileups sum across processes, and each process's
         excluded pairs' host alignments merge in, so EVERY gate
         decision on every process uses the same host-full pileup;
      2. the packed class rows + totals allgather and accumulate in
         global first-seen read order;
      3. each process rescues ITS punt mask (never dropped) and exports
         per-fragment count rows, merged in global sorted-read-id
         order.

    Every process therefore computes a result identical to a
    single-process `type_reads_device` over the concatenated reads —
    including num_reads / num_pairs and the cmpt dicts — and the staged
    EM runs replicated on the merged classes.  Every rank joins every
    collective, whatever its counts (zero punts or novels included)."""
    import torch.distributed as dist

    from ..typer.counting import StatAccumulator
    from ..typer.engine import (GeneTypingResult, TypingOptions,
                                _concordant)
    from ..typer.mpileup import Mpileup
    from ..typer.staging import class_levels, staged_abundance
    from ..utils.trace import TRACE
    from .production import (_align_punts, _prepare_rescue,
                             _rescued_fragment_rows, _shared_sharded_typer)

    opts = opts or TypingOptions()
    if mesh is None:
        # the device programs run on THIS process's shards; the
        # cross-process merges ride the host-level collectives above
        mesh = Mesh([_rank_card() if device is None
                     else resolve_device(device)])
    if mesh.world > 1:
        raise ValueError("type_reads_device_distributed types each rank's "
                         "reads on a mesh local to the rank; %r spans ranks"
                         % mesh)
    device = mesh.devices[0] if device is None else resolve_device(device)

    seqs_1 = [s for _, s in reads_1]
    seqs_2 = [s for _, s in (reads_2 or [])]
    max_len = max((len(s) for s in seqs_1 + seqs_2), default=100)
    # every process must run the same read_len program
    max_len = int(_allreduce(np.array([max_len], np.int64),
                             dist.ReduceOp.MAX)[0])
    read_len = max(100, ((max_len + 9) // 10) * 10)
    st = _shared_sharded_typer(gene, opts, mesh, read_len)
    c1 = st.encode(seqs_1)
    c2 = st.encode(seqs_2) if reads_2 is not None else None

    holder = {}

    def _merge_cb(pile_dev_local, excl_mask, winner):
        # 1. global device pileup
        with TRACE.stage("dist.pileup"):
            gp = _allsum(pile_dev_local.astype(np.int64))
        # 2. local excluded pairs' host alignments -> local delta
        idx = np.flatnonzero(excl_mask)
        bp = _align_punts(gene, opts, reads_1, reads_2, idx, winner,
                          None, device)
        mp0 = Mpileup(gene)
        bulk = []
        for i in idx:
            alns = bp.get(int(i))
            if alns:
                conc = _concordant(alns, opts)
                if conc is not None:
                    bulk.extend(conc)
        mp0.add_alignments_bulk(bulk)
        with TRACE.stage("dist.pileup"):
            delta = _allsum(mp0.counts.astype(np.int64))
        final = (gp + delta).astype(np.int32)
        mp = Mpileup(gene)
        mp.counts = np.ascontiguousarray(final)
        mp.finalize()
        holder["by_pair"] = bp
        holder["mpileup"] = mp
        holder["excl_idx"] = idx
        return final

    def _overlap_cb():
        # process-local rescue prep (GeneTyper build + fast-path memo
        # prefill over the excl pairs) runs while the count pass
        # executes on the device — same overlap as the single-process path
        holder["pre"] = _prepare_rescue(
            gene, opts, reads_1, holder["by_pair"],
            holder["excl_idx"], holder["mpileup"], device)

    out = st.count_classes(c1, c2, merge_pileup=_merge_cb,
                           overlap=_overlap_cb)
    by_pair = holder["by_pair"]
    mpileup = holder["mpileup"]

    # 2. merge packed class rows in global first-seen read order
    with TRACE.stage("dist.classes"):
        full_stats = StatAccumulator(gene.allele_names)
        exon_stats = None
        primary_stats = None
        accs = {"full": full_stats}
        if "exon" in out["levels"]:
            exon_stats = StatAccumulator(gene.allele_names, st._rep_mask_np)
            accs["exon"] = exon_stats
        if "primary" in out["levels"]:
            primary_stats = StatAccumulator(gene.allele_names,
                                            st._primary_mask_np)
            accs["primary"] = primary_stats
        for name, acc in accs.items():
            rows, uws, totals = out["levels"][name]
            keys = out["order"][name] + global_start
            rows_all = _gather_parts(rows.astype(np.uint32))
            uws_all = _gather_parts(uws.astype(np.int64))
            keys_all = _gather_parts(keys.astype(np.int64))
            rows_g = np.concatenate(rows_all)
            uws_g = np.concatenate(uws_all)
            keys_g = np.concatenate(keys_all)
            order = np.argsort(keys_g, kind="stable")
            totals_g = _allsum(np.asarray(totals, np.int64))
            acc.add_packed_batch(rows_g[order], uws_g[order], totals_g)

        n_reads = int(_allsum(np.array([out["n_reads"]], np.int64))[0])
        n_pairs = int(_allsum(np.array([out["n_pairs"]], np.int64))[0])

    # 3. local punt rescue -> per-fragment rows -> global merge
    punt_idx = np.flatnonzero(out["punt"])
    extra = punt_idx[~out["excl"][punt_idx]]
    if len(extra):
        by_pair.update(_align_punts(gene, opts, reads_1, reads_2,
                                    extra, out["winner"], None, device))
    keys, rf, re_, rp, r_reads, novel = _rescued_fragment_rows(
        gene, opts, reads_1, by_pair, punt_idx, mpileup,
        pre=holder.get("pre"), device=device)
    with TRACE.stage("dist.rescue"):
        kw = _gather_parts(keys.astype(np.uint8))
        kl = max(k.shape[1] if k.size else 0 for k in kw)
        kpad = [np.pad(k, ((0, 0), (0, kl - k.shape[1])))
                if k.size else np.zeros((len(k), kl), np.uint8) for k in kw]
        keys_g = np.concatenate(kpad) if kl else np.zeros((0, 0), np.uint8)
        rf_g = np.concatenate(_gather_parts(rf))
        re_g = np.concatenate(_gather_parts(re_))
        rp_g = np.concatenate(_gather_parts(rp))
        n_reads += int(_allsum(np.array([r_reads], np.int64))[0])
        n_pairs += len(keys_g)
        # merge novel-variant provenance across processes (report parity)
        novel_meta = _merge_novel_meta(novel.meta, novel.first_read)
    if len(keys_g):
        with TRACE.stage("rescue.fold"):
            order = np.lexsort(keys_g.T[::-1])
            w1 = np.ones(len(order), np.int64)
            full_stats.add_reads_batch(rf_g[order], w1)
            if exon_stats is not None:
                exon_stats.add_reads_batch(re_g[order], w1)
            if primary_stats is not None:
                primary_stats.add_reads_batch(rp_g[order], w1)

    levels, (full_cmpt, exon_cmpt, primary_cmpt) = class_levels(
        full_stats, exon_stats, primary_stats)
    prob = staged_abundance(gene, opts, *levels,
                            getattr(st, "_rep_groups", {}),
                            getattr(st, "_primary_groups", {}),
                            gene.allele_lengths())
    return GeneTypingResult(
        gene=gene.gene,
        num_reads=int(n_reads),
        num_pairs=int(n_pairs),
        counts=full_stats.ranked_counts(),
        prob=prob,
        cmpt=full_cmpt,
        exon_cmpt=exon_cmpt,
        primary_exon_cmpt=primary_cmpt,
        novel_vars=novel_meta,
    )
