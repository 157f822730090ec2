# Port of hgtpu/parallel/sharded.py: jax.sharding.Mesh, shard_map and
# psum as a list of shard devices and torch.distributed; the step
# functions call the port's kernels on each shard.
"""Multi-device sharding of the typing pipeline.

The reference parallelizes with multiprocessing.Pool over samples and
`hisat2 -p N` threads; the device equivalent is data parallelism over
reads and haplotypes on a mesh of shards:

- reads are split over the shards in contiguous blocks (hgtpu's
  ``P(axis)``), each shard placing its block against the replicated
  backbone PWM,
- haplotype batches are split likewise; each shard computes its
  compatibility masks against the replicated link tables and the
  per-allele evidence is merged with ``Mesh.psum``,
- the EM abundance solver runs replicated on the reduced counts.

A ``Mesh`` is the shard devices local to this process, in order and with
repeats allowed (``["cpu"] * 8`` in the tests, ``["cuda:0"] * 2`` on one
card, one entry per card on a multi-card host), and optionally a
``torch.distributed`` process group: its size is the local shards times
the group's ranks.  ``Mesh.shard_map`` runs a per-shard body once per
local shard, on that shard's device and rows; a body that is a generator
yields a tensor where hgtpu's program calls ``psum`` and receives the
sum over every shard of every rank.  A mesh of one shard and no group
runs the body as it is: no copy, no collective.
"""
from __future__ import annotations

import inspect

import torch

from .. import default_device, resolve_device

# in and out specs of shard_map: a replicated value (hgtpu's P()) or a
# tensor split over the shards in contiguous row blocks (P(axis))
REP = "rep"
SHARD = "shard"


class Sharded:
    """A global tensor held as contiguous row blocks, one per local
    shard, each on its shard's device: the form a sharded jax.Array takes
    here.  ``cpu()`` joins the blocks in shard order."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self):
        p0 = self.parts[0]
        return torch.Size((sum(p.shape[0] for p in self.parts),)
                          + tuple(p0.shape[1:]))

    def cpu(self):
        return torch.cat([p.cpu() for p in self.parts])


class Replicated:
    """One value already placed on every local shard's device, in shard
    order (a typer's tables, copied once)."""

    def __init__(self, parts):
        self.parts = list(parts)


class Mesh:
    """Shard devices of this process (in order, repeats allowed) and an
    optional process group whose ranks each hold a mesh of the same
    length."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard device")
        self.group = group
        self.n_local = len(self.devices)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.size = self.n_local * self.world

    def __repr__(self):
        return "Mesh(%s, rank %d of %d)" % (
            [str(d) for d in self.devices], self.rank, self.world)

    # ---- moving values onto the shards ---- #
    def shard(self, x):
        """Per-shard row blocks of a global tensor (or a Sharded of this
        mesh's length, whose blocks already sit on their shards)."""
        if isinstance(x, Sharded):
            if len(x.parts) != self.n_local:
                raise ValueError("a Sharded of %d blocks on a mesh of %d "
                                 "shards" % (len(x.parts), self.n_local))
            return x.parts
        if self.n_local == 1:
            return [x]
        n = x.shape[0]
        if n % self.n_local:
            raise ValueError("%d rows do not split over %d shards; pad to a "
                             "multiple first" % (n, self.n_local))
        b = n // self.n_local
        return [x[s * b:(s + 1) * b].to(d)
                for s, d in enumerate(self.devices)]

    def replicate(self, x):
        """x on every shard's device."""
        if isinstance(x, Replicated):
            return x.parts
        if self.n_local == 1:
            return [x]
        return [x.to(d) for d in self.devices]

    def join(self, parts):
        """The global value of per-shard row blocks: the block itself on
        a one-shard mesh, else a Sharded."""
        return parts[0] if self.n_local == 1 else Sharded(parts)

    # ---- the collective ---- #
    def psum(self, parts):
        """hgtpu's lax.psum over the mesh: the local shards' tensors
        summed in shard order, then all-reduced over the group's ranks,
        and the sum handed back on each shard's device."""
        if len(parts) != self.n_local:
            raise ValueError("psum over %d values on a mesh of %d shards"
                             % (len(parts), self.n_local))
        if self.n_local == 1 and self.world == 1:
            return list(parts)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        if self.world > 1:
            import torch.distributed as dist

            if self.n_local == 1:
                acc = acc.clone()     # all_reduce writes in place
            dist.all_reduce(acc, group=self.group)
        return [acc if p.device == acc.device else acc.to(p.device)
                for p in parts]

    def run(self, results):
        """Drive the shards' bodies in lockstep.  A body that returned a
        generator yields a tensor at each psum and is sent the sum; every
        shard must reach the same psums in the same order."""
        if not any(inspect.isgenerator(r) for r in results):
            return list(results)
        sends = [None] * len(results)
        while True:
            asked, done = [], []
            for g, v in zip(results, sends):
                try:
                    asked.append(g.send(v))
                except StopIteration as stop:
                    done.append(stop.value)
            if done:
                if asked:
                    raise RuntimeError("the shards left their program at "
                                       "different psums")
                return done
            sends = self.psum(asked)

    def shard_map(self, bodies, in_specs, out_specs):
        """hgtpu's shard_map: ``bodies(device)`` is the per-shard
        function for shards on that device (its constants live there);
        each in spec is REP or SHARD (None: every argument SHARD), the
        out specs a tuple of them or one.  SHARD outputs come back joined
        (``join``), REP outputs as shard 0's value."""
        def run(*args):
            specs = (SHARD,) * len(args) if in_specs is None else in_specs
            if len(specs) != len(args):
                raise TypeError("%d arguments for %d in specs"
                                % (len(args), len(specs)))
            per = [[] for _ in self.devices]
            for a, spec in zip(args, specs):
                for s, p in enumerate(self.shard(a) if spec == SHARD
                                      else self.replicate(a)):
                    per[s].append(p)
            outs = self.run([bodies(d)(*per[s])
                             for s, d in enumerate(self.devices)])
            if isinstance(out_specs, str):
                return self._out(out_specs, outs)
            return tuple(self._out(spec, [o[k] for o in outs])
                         for k, spec in enumerate(out_specs))
        return run

    def _out(self, spec, parts):
        return self.join(parts) if spec == SHARD else parts[0]


def make_mesh(n_devices=None, device=None):
    """A mesh of `n_devices` shards with no group: all on `device` when
    one is given, else the visible cards in turn (shard s on card
    s % count; n_devices None: one shard per card).  Without a card and
    without `device` it raises, as every entry of the port does."""
    if device is not None:
        return Mesh([resolve_device(device)] * (n_devices or 1))
    default_device()                          # raises without a card
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    return Mesh([torch.device("cuda", s % count) for s in range(n)])


# ------------------------------------------------------------------------- #
# hgtpu's stand-alone step functions, over a Mesh
# ------------------------------------------------------------------------- #
def _em_iterations(M, counts, iters=100):
    Mf = M.to(torch.float32)
    p = Mf.T @ (counts / Mf.sum(1).clamp(min=1.0))
    p = p / p.sum().clamp(min=1e-30)
    for _ in range(iters):
        denom = Mf @ p
        w = torch.where(denom > 0, counts / denom.clamp(min=1e-30),
                        torch.zeros_like(denom))
        p = (Mf.T @ w) * p
        p = p / p.sum().clamp(min=1e-30)
    return p


def _same(body):
    """bodies(device) for a body with no per-device constants."""
    return lambda device: body


def sharded_place(mesh: Mesh, top_k: int = 4):
    """Data-parallel placement: reads sharded, PWM replicated.
    step(pwm_ext, reads) -> (scores, positions) [N, top_k], sharded."""
    from ..ops.placement import correlate_scores, _top_diagonals

    def step(pwm_ext, reads):
        s, p = _top_diagonals(correlate_scores(pwm_ext, reads), top_k)
        return s.to(torch.float32), p.to(torch.int32)

    return mesh.shard_map(_same(step), (REP, SHARD), (SHARD, SHARD))


def sharded_verify_filter(mesh: Mesh, lb_pad: int = 4):
    """Data-parallel verify-stage proposal filter (the device twin of
    GeneAligner._lb_keep): per (read, start) proposal, count read bases
    that match neither backbone nor a catalog SNP on any diagonal within
    the novel-indel budget, a lower bound on the proposal's novel-edit
    cost.  Proposals sharded over the mesh; the dilated match table
    replicated.

    step(tbl_dil [R, 6] bool, reads [E, W] int8 (pad code 5),
         starts [E] int32, w_eff [E] int32) -> lb [E] int32, sharded."""
    def step(tbl_dil, reads, starts, w_eff):
        W = reads.shape[1]
        j = torch.arange(W, dtype=torch.int64, device=reads.device)
        idx = starts.long()[:, None] + j[None, :] + lb_pad
        ok = tbl_dil[idx, reads.long()]
        in_win = j[None, :] < w_eff.long()[:, None]
        return (in_win & ~ok).sum(1, dtype=torch.int32)

    return mesh.shard_map(_same(step), (REP, SHARD, SHARD, SHARD), SHARD)


def sharded_banded_dp(mesh: Mesh, max_novel: int = 2):
    """Data-parallel banded variant-aware DP (ops.banded_dp, the DP
    kernel on CUDA): proposals sharded over the mesh, gene tables
    replicated.  Each shard computes the exact novel-edit costs of its
    proposals.

    make(backbone_len, del_lens, ins_lens) -> step(tables, reads [E, W]
    int8, lens [E] int32, starts [E] int32) -> (cost [E] int32,
    overflow [E] bool), sharded; ``tables`` is a BandedDPTables'
    (table, planes)."""
    from ..ops.banded_dp import banded_costs

    def make(backbone_len, del_lens=(), ins_lens=()):
        def step(table, planes, reads, lens, starts):
            return banded_costs(table, reads, lens, starts, backbone_len,
                                max_novel, del_lens, ins_lens,
                                planes=planes)

        run = mesh.shard_map(_same(step), (REP, REP, SHARD, SHARD, SHARD),
                             (SHARD, SHARD))
        return lambda tables, reads, lens, starts: run(
            *tables, reads, lens, starts)

    return make


def sharded_count(mesh: Mesh):
    """Data-parallel compatibility counting (kernel K2 inside
    ``_compat``) and the mesh-reduced allele totals.

    step(links_packed [V+1, W] repl, nd_pos [Vnd] repl,
         nd_prefix [Vnd+1, A] repl, del_pos/del_right [D] repl,
         del_links [D, A] repl, var_pos/var_right [V+1] repl,
         lefts/rights [H] sharded, vars [H, K] sharded,
         class_mask [C, A] repl, class_counts [C] repl)
    -> (masks [H, A] sharded, allele_totals [A] psum-reduced, prob [A])"""
    from ..typer.device_count import _compat

    def step(links_packed, nd_pos, nd_prefix, del_pos, del_right, del_links,
             var_pos, var_right, lefts, rights, vars_, class_mask,
             class_counts):
        masks = _compat(links_packed, nd_pos, nd_prefix, del_pos, del_right,
                        del_links, var_pos, var_right, lefts, rights, vars_)
        totals = yield masks.to(torch.int32).sum(0, dtype=torch.int32)
        prob = _em_iterations(class_mask, class_counts)     # replicated
        return masks, totals, prob

    return mesh.shard_map(_same(step), (REP,) * 8 + (SHARD,) * 3
                          + (REP, REP), (SHARD, REP, REP))


def sharded_typing_step(mesh: Mesh):
    """Combined demo step for the multi-device dry run: placement, the
    verify filter, counting and EM, each stage a shard_map program."""
    place = sharded_place(mesh)
    filt = sharded_verify_filter(mesh)
    count = sharded_count(mesh)

    def step(pwm_ext, reads, tbl_dil, starts, w_eff, dc_tables, lefts,
             rights, vars_, class_mask, class_counts):
        _top_scores, top_pos = place(pwm_ext, reads)
        lb = filt(tbl_dil, reads, starts, w_eff)
        _masks, totals, prob = count(*dc_tables, lefts, rights, vars_,
                                     class_mask, class_counts)
        return top_pos, lb, totals, prob

    return step


def device_tables(dc):
    """Pack a DeviceCounter's tables for sharded_count."""
    return (dc.links_packed, dc.nd_pos, dc.nd_prefix, dc.del_pos,
            dc.del_right, dc.del_links, dc.var_pos_d, dc.var_right_d)
