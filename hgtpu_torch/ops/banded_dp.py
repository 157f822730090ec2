# Port of hgtpu/ops/banded_dp.py: the tables are a copy; the DP is a
# hand-written CUDA kernel (csrc/banded_dp.cu) with a plain torch version.
"""Banded variant-aware extension DP — the device verify stage.

Computes, on the device, the exact minimum novel-edit cost of aligning a
read at a proposed backbone start through the variant graph — the same
quantity the host DFS (align.verify.GeneVerifier / native/verifier.cpp)
minimizes, replacing HISAT2's extension stage.

State space: (read chars consumed i, diagonal offset d) with backbone
position pos = start + i + d.  Catalog deletions shift d by +len at their
position for free; catalog insertions consume len read chars at fixed pos
for free (sequence-matched); novel edits follow the DFS rules exactly —
mismatch +1 at non-free chars, novel del/ins of length 1-2 at +length,
indels only after the first consumed char.  The band covers
d in [-DNEG, +DPOS]; paths needing more drift, positions with more
catalog indel alternatives than the packed slots, or deletion chains
longer than the closure depth raise the per-proposal `overflow` flag and
the caller falls back to the host DFS for those entries.

The DP is exact *modulo the haplotype-window constraint* (which is
path-dependent): its cost can only be lower than the constrained DFS's,
so callers that enable the constraint must confirm the winning proposal
with the DFS and fall back when costs disagree.

hgtpu writes the DP as a ``lax.scan`` over the W + 1 read positions of
masked mins over static diagonal shifts, one fused XLA program.  Eager
torch would launch ~10^4 small kernels per call, so the port runs it as
one CUDA kernel (``csrc/banded_dp.cu``), of two kinds that ``dp_plan``
picks from the edit budget alone:

    bits  budgets 0-7: one thread per proposal, every plane held as
          budget + 1 threshold masks (bit d of level k set when the cost
          at diagonal d is <= k), every transition word logic
    warp  larger budgets: one warp per proposal, lanes over diagonals

``banded_costs_plain`` is the same recurrence as torch slice-mins, a
line-for-line transliteration of hgtpu's scan body.

The warp kernel and the plain version read one packed table of four
int32 words per row (``pack_rows``):

    word 0  bits 0-7   free[r, b]: base code b is free at the row
            bit 8      over[r]: catalog indels past the packed slots
            bits 9-11  ins_len[r, 0];  bits 12-14  ins_len[r, 1]
    word 1  bit k      del_has[r, k]: a catalog deletion of del_lens[k]
    word 2  ins_seq[r, 0, 0..3], one byte each (7 never matches)
    word 3  ins_seq[r, 1, 0..3]

and the gene's distinct deletion and insertion lengths as tuples (hgtpu's
static arguments); the kernels take them as bit masks (bit L set for
length L: deletions <= DPOS, insertions <= IL, so one int32 each).  The
bit kernel reads the same flags as bit planes over the rows
(``bit_planes``: row r at bit r + PLANE_PAD of its plane, 64-bit words),
and the packed table only at the rare rows with a catalog insertion.
"""
from __future__ import annotations

import numpy as np
import torch

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION
from .. import resolve_device
from . import count_launch, cuda_lib

DNEG = 8          # max leftward drift (catalog/novel insertions)
DPOS = 24         # max rightward drift (catalog/novel deletions)
D = DNEG + DPOS + 1
NI = 2            # catalog insertion slots per position
IL = 4            # max catalog insertion length handled on device
NITER = 4         # intra-layer closure depth (catalog/novel del chains)
OFF = DNEG + 2    # gather offset so pos + OFF >= 0 inside the band
INF = 1 << 20
BITS_MAX_NOVEL = 7   # the bit kernel's budgets: 0..7 (1..8 threshold masks)

# bit planes (bit_planes): base codes 0-7 free, then these, then one plane
# per catalog deletion length
PL_OVER, PL_INS, PL_DEL_ANY, PL_DEL = 8, 9, 10, 11
PLANE_PAD = 64       # zero bits before row 0: a band's window never starts
                     # below bit 0


class BandedDPTables:
    """Per-gene tables for the banded DP: hgtpu's five numpy arrays
    (``arrays``: free, del_has, ins_len, ins_seq, over), packed once into
    ``table`` [rows, 4] int32 and ``planes`` [11 + len(del_lens), words]
    int64 (``bit_planes``) on `device`."""

    def __init__(self, gene: GeneRef, device=None):
        self.gene = gene
        self.device = resolve_device(device)
        P = len(gene.backbone)
        self.P = P
        rows = P + OFF + DPOS + 4096   # tail headroom for start+i+d
        free = np.zeros((rows, 8), dtype=bool)
        free[OFF + np.arange(P), gene.backbone_enc] = True
        over = np.zeros(rows, dtype=bool)
        # distinct catalog deletion lengths representable in the band
        # become shift amounts; one boolean plane per length
        dlens = sorted({int(gene.var_len[vi])
                        for vi in range(gene.n_vars)
                        if int(gene.var_type[vi]) == VT_DELETION
                        and int(gene.var_len[vi]) <= DPOS})
        self.del_lens = tuple(dlens)
        dl_slot = {l: k for k, l in enumerate(dlens)}
        del_has = np.zeros((rows, max(1, len(dlens))), dtype=bool)
        ins_len = np.zeros((rows, NI), dtype=np.int32)
        ins_seq = np.full((rows, NI, IL), 7, dtype=np.int8)  # never matches
        ilens = set()
        i_fill = {}
        for vi in range(gene.n_vars):
            vt = int(gene.var_type[vi])
            pos = int(gene.var_pos[vi])
            r = OFF + pos
            if vt == VT_SINGLE:
                free[r, "ACGT".index(gene.var_data[vi])] = True
            elif vt == VT_DELETION:
                dlen = int(gene.var_len[vi])
                if dlen > DPOS:
                    over[r] = True
                else:
                    del_has[r, dl_slot[dlen]] = True
            else:
                k = i_fill.get(pos, 0)
                seq = gene.var_data[vi]
                if k >= NI or len(seq) > min(IL, DNEG):
                    over[r] = True
                else:
                    ins_len[r, k] = len(seq)
                    for j, ch in enumerate(seq):
                        ins_seq[r, k, j] = "ACGT".index(ch)
                    i_fill[pos] = k + 1
                    ilens.add(len(seq))
        self.ins_lens = tuple(sorted(ilens))
        self.arrays = (free, del_has, ins_len, ins_seq, over)
        self.table = torch.from_numpy(pack_rows(*self.arrays)).to(
            self.device)
        self.planes = torch.from_numpy(bit_planes(
            free, del_has, ins_len, over, len(dlens), P)).to(self.device)

    def costs(self, reads: np.ndarray, lens: np.ndarray,
              starts: np.ndarray, max_novel: int = 2):
        """reads [E, W] int8 (pad anything), lens [E], starts [E] ->
        device tensors (cost [E] int32, overflow [E] bool).  cost >= INF
        means no alignment exists within `max_novel` novel edits inside
        the band (costs above the budget saturate — they can never win,
        and saturation is what lets the deletion-chain closure
        converge)."""
        from ..utils.trace import TRACE
        E, W = reads.shape
        # per layer: ~(3 + len(del_lens)*NITER + NI) masked-min relaxations
        # over the [E, D] plane
        relax = 3 + len(self.del_lens) * 4 + 2
        TRACE.count("flops.device_dp", float(E) * W * D * relax)

        def dev(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(
                self.device)

        return banded_costs(self.table, dev(reads, np.int8),
                            dev(lens, np.int32), dev(starts, np.int32),
                            self.P, max_novel, self.del_lens, self.ins_lens,
                            planes=self.planes)


def pack_rows(free, del_has, ins_len, ins_seq, over) -> np.ndarray:
    """hgtpu's five row tables as one [rows, 4] int32 array (the layout
    in the module docstring)."""
    rows = free.shape[0]
    w = np.zeros((rows, 4), np.uint32)
    w[:, 0] = (free.astype(np.uint32) << np.arange(8, dtype=np.uint32)).sum(1)
    w[:, 0] |= over.astype(np.uint32) << 8
    w[:, 0] |= ins_len[:, 0].astype(np.uint32) << 9
    w[:, 0] |= ins_len[:, 1].astype(np.uint32) << 12
    nk = del_has.shape[1]
    w[:, 1] = (del_has.astype(np.uint32)
               << np.arange(nk, dtype=np.uint32)).sum(1)
    seq = ins_seq.astype(np.uint8).astype(np.uint32)
    for s in range(NI):
        w[:, 2 + s] = (seq[:, s, :] << (8 * np.arange(IL, dtype=np.uint32))
                       ).sum(1)
    return w.view(np.int32)


def plane_words(P: int) -> int:
    """64-bit words a plane holds: every row a diagonal inside the
    backbone reads (rows < OFF + P), past PLANE_PAD, plus the word after
    the last window's, rounded up to an even count (16-byte planes)."""
    n = (OFF + P + 63) // 64 + 2
    return n + (n & 1)


def bit_planes(free, del_has, ins_len, over, n_del, P) -> np.ndarray:
    """hgtpu's row tables as bit planes [11 + n_del, plane_words(P)]
    int64: bit PLANE_PAD + r of a plane is row r's flag.  Planes 0-7:
    free[:, b]; PL_OVER: over; PL_INS: a catalog insertion in either
    slot; PL_DEL_ANY: any catalog deletion; PL_DEL + k: del_has[:, k].
    Rows past the last word hold no flag (every flag row is < OFF + P)."""
    words = plane_words(P)
    n = min(free.shape[0], words * 64 - PLANE_PAD)
    bits = np.zeros((PL_DEL + n_del, words * 64), bool)
    at = slice(PLANE_PAD, PLANE_PAD + n)
    bits[:8, at] = free[:n].T
    bits[PL_OVER, at] = over[:n]
    bits[PL_INS, at] = (ins_len[:n] > 0).any(1)
    bits[PL_DEL_ANY, at] = del_has[:n, :n_del].any(1)
    bits[PL_DEL:, at] = del_has[:n, :n_del].T
    return np.packbits(bits, axis=1, bitorder="little").view("<u8") \
        .view(np.int64)


def length_mask(lens) -> int:
    """Bit L set for each length L in `lens` (all in 1..30)."""
    m = 0
    for L in lens:
        if not 1 <= L <= 30:
            raise ValueError("length %d outside the band's masks" % L)
        m |= 1 << L
    return m


def _check(table, reads, lens, starts):
    dev = reads.device
    for name, t, dt in (("table", table, torch.int32),
                        ("reads", reads, torch.int8),
                        ("lens", lens, torch.int32),
                        ("starts", starts, torch.int32)):
        if t.device != dev:
            raise ValueError("%s on %s, reads on %s" % (name, t.device, dev))
        if t.dtype != dt:
            raise TypeError("want %s %s, got %s" % (dt, name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if table.dim() != 2 or table.shape[1] != 4 or reads.dim() != 2 \
            or reads.shape[1] == 0:
        raise ValueError("want table [rows, 4] and reads [E, W > 0], got "
                         "%s, %s" % (tuple(table.shape), tuple(reads.shape)))
    E = reads.shape[0]
    if lens.shape != (E,) or starts.shape != (E,):
        raise ValueError("want lens and starts [%d]" % E)


def _shift_min(dst, src, mask, shift, add=0):
    """min(dst, (src + add) shifted `shift` diagonals right where mask) —
    hgtpu's scatter-free transition.  shift > 0 moves mass toward larger
    d (deletions); shift < 0 toward smaller d (insertions)."""
    vals = torch.where(mask, src + add, torch.full_like(src, INF))
    out = dst.clone()
    if shift > 0:
        out[:, shift:] = torch.minimum(dst[:, shift:], vals[:, :D - shift])
    elif shift < 0:
        out[:, :D + shift] = torch.minimum(dst[:, :D + shift],
                                           vals[:, -shift:])
    else:
        out = torch.minimum(dst, vals)
    return out


def banded_costs_plain(table, reads, lens, starts, P, max_novel,
                       del_lens=(), ins_lens=()):
    """The DP in plain torch: hgtpu's ``_banded_costs`` scan body as a
    Python loop over the W + 1 read positions, every transition a
    slice-min over the [E, D] diagonal plane, the row tables unpacked
    from the packed words.  Returns (cost [E] int32, over [E] bool)."""
    E, W = reads.shape
    dev = reads.device
    rows = table.shape[0]
    i32 = torch.int32
    inf = torch.full((E, D), INF, dtype=i32, device=dev)

    def sat(x):
        return torch.where(x > max_novel, torch.full_like(x, INF), x)

    d_val = torch.arange(D, dtype=i32, device=dev) - DNEG
    reads32 = reads.to(i32)
    lens = lens.to(i32)
    win_src = torch.cat([reads32, torch.full((E, IL), 6, dtype=i32,
                                             device=dev)], 1)
    kk = torch.arange(IL, dtype=i32, device=dev)

    cur = inf.clone()
    cur[:, DNEG] = 0
    pend = [inf.clone() for _ in range(IL)]
    final = torch.full((E,), INF, dtype=i32, device=dev)
    over = torch.zeros(E, dtype=torch.bool, device=dev)

    for i in range(W + 1):
        cur = torch.minimum(cur, pend[0])
        pend = pend[1:] + [inf.clone()]
        final = torch.where(lens == i, torch.minimum(final, cur.min(1).values),
                            final)
        live = i < lens                                     # [E]
        pos = starts[:, None] + i + d_val[None, :]          # [E, D]
        pidx = (pos + OFF).clamp(0, rows - 1).long()
        row = table[pidx]                                   # [E, D, 4]
        w0, w1 = row[..., 0], row[..., 1]
        ch = reads32[:, min(i, W - 1)].clamp(0, 7)          # [E]
        free = ((w0 >> ch[:, None]) & 1) == 1               # [E, D]
        pos_ok = (pos >= 0) & (pos < P)
        finite = cur < INF
        indels_on = live if i > 0 else torch.zeros_like(live)
        # positions whose catalog indels exceed the packed slots poison
        # any finite state that touches them
        over = over | (finite & pos_ok & (((w0 >> 8) & 1) == 1)
                       & indels_on[:, None]).any(1)

        # ---- intra-layer closure: catalog + novel deletions ---- #
        over_acc = []

        def relax(c):
            new = c
            gate = (c < INF) & pos_ok & indels_on[:, None]
            for k, L in enumerate(del_lens):                # catalog, free
                has = gate & (((w1 >> k) & 1) == 1)
                new = _shift_min(new, c, has, L)
                over_acc.append(has[:, D - L:].any(1))
            ngate = gate & ~free          # novel deletions cost their len
            for L in (1, 2):
                new = _shift_min(new, c, ngate, L, add=L)
                over_acc.append((ngate[:, D - L:]
                                 & (c[:, D - L:] < INF)).any(1))
            return sat(new)

        c = cur
        for _ in range(NITER):
            c = relax(c)
        c_extra = relax(c)
        # closure did not converge -> chains deeper than NITER
        over = over | (c_extra < c).any(1)
        for ob in over_acc:
            over = over | ob
        cur = c

        # ---- catalog insertions (free, consume il chars at fixed pos) #
        win = win_src[:, i:i + IL]                          # [E, IL]
        gate_i = (cur < INF) & pos_ok & indels_on[:, None]
        for slot in range(NI):
            il = (w0 >> (9 + 3 * slot)) & 7                 # [E, D]
            seq = (row[..., 2 + slot][..., None] >> (8 * kk)) & 0xFF
            match = torch.where(kk[None, None, :] < il[:, :, None],
                                win[:, None, :] == seq,
                                torch.ones_like(seq, dtype=torch.bool)
                                ).all(2)
            for L in ins_lens:
                has = (gate_i & (il == L) & match
                       & (i + L <= lens[:, None]))
                pend[L - 1] = _shift_min(pend[L - 1], cur, has, -L)
                over = over | has[:, :L].any(1)

        # ---- consume char i ---- #
        step = torch.where(free & pos_ok, torch.zeros_like(cur),
                           torch.where(pos_ok, torch.ones_like(cur),
                                       torch.full_like(cur, INF)))
        nxt = sat(torch.clamp(cur + step, max=INF))
        # novel insertions (consume 1-2 chars at fixed pos, +length)
        ngate = (cur < INF) & pos_ok & ~free & indels_on[:, None]
        for L in (1, 2):
            has = ngate & (i + L <= lens)[:, None]
            pend[L - 1] = sat(_shift_min(pend[L - 1], cur, has, -L, add=L))
            over = over | (has[:, :L] & (cur[:, :L] < INF)).any(1)
        cur = torch.where(live[:, None], nxt, cur)
    return final, over


def dp_plan(max_novel: int) -> str:
    """The DP kernel for an edit budget: "bits" (threshold masks in
    registers, one per cost level) for 0..BITS_MAX_NOVEL, else "warp"."""
    return "bits" if 0 <= max_novel <= BITS_MAX_NOVEL else "warp"


def _check_planes(planes, reads, P, del_lens):
    if planes is None:
        raise ValueError("the bit kernel needs the bit planes "
                         "(BandedDPTables.planes)")
    if planes.device != reads.device or planes.dtype != torch.int64 \
            or not planes.is_contiguous():
        raise ValueError("want contiguous int64 planes on %s" % reads.device)
    want = (PL_DEL + len(del_lens), plane_words(P))
    if tuple(planes.shape) != want:
        raise ValueError("want planes %s, got %s"
                         % (want, tuple(planes.shape)))


def _launch(fn, name, reads, *args):
    """Allocate (cost, over) for `reads`' E entries and launch `name` from
    the kernel library with `args`, the outputs and the stream; count the
    launch on `fn` and on banded_costs.  E = 0 launches nothing."""
    E = reads.shape[0]
    cost = torch.empty(E, dtype=torch.int32, device=reads.device)
    over = torch.empty(E, dtype=torch.bool, device=reads.device)
    if E == 0:
        return cost, over
    lib = cuda_lib.load()
    with torch.cuda.device(reads.device):
        err = getattr(lib, name)(
            *args, cost.data_ptr(), over.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, name)
    count_launch(fn)
    count_launch(banded_costs)
    return cost, over


def banded_costs_bits(table, planes, reads, lens, starts, P, max_novel,
                      del_lens=(), ins_lens=()):
    """The bit kernel (budgets 0..BITS_MAX_NOVEL); the plain version for
    CPU tensors."""
    _check(table, reads, lens, starts)
    if reads.device.type == "cpu":
        return banded_costs_plain(table, reads, lens, starts, P, max_novel,
                                  del_lens, ins_lens)
    if reads.device.type != "cuda" or dp_plan(max_novel) != "bits":
        raise RuntimeError("no bit DP kernel for budget %d on %s"
                           % (max_novel, reads.device))
    _check_planes(planes, reads, P, del_lens)
    E, W = reads.shape
    return _launch(banded_costs_bits, "hgtpu_torch_banded_dp_bits", reads,
                   planes.data_ptr(), planes.shape[0], planes.shape[1],
                   table.data_ptr(), table.shape[0], reads.data_ptr(), E, W,
                   lens.data_ptr(), starts.data_ptr(), P, int(max_novel),
                   length_mask(del_lens), length_mask(ins_lens))


def banded_costs_warp(table, reads, lens, starts, P, max_novel,
                      del_lens=(), ins_lens=()):
    """The warp kernel (any budget); the plain version for CPU
    tensors."""
    _check(table, reads, lens, starts)
    if reads.device.type == "cpu":
        return banded_costs_plain(table, reads, lens, starts, P, max_novel,
                                  del_lens, ins_lens)
    if reads.device.type != "cuda":
        raise RuntimeError("no banded DP kernel for device %s"
                           % reads.device)
    E, W = reads.shape
    return _launch(banded_costs_warp, "hgtpu_torch_banded_dp_warp", reads,
                   table.data_ptr(), table.shape[0], reads.data_ptr(), E, W,
                   lens.data_ptr(), starts.data_ptr(), P, int(max_novel),
                   length_mask(del_lens), length_mask(ins_lens))


def banded_costs(table, reads, lens, starts, P, max_novel,
                 del_lens=(), ins_lens=(), planes=None):
    """table [rows, 4] int32 (``pack_rows``), reads [E, W] int8, lens and
    starts [E] int32, all on one device (and ``planes``, the bit kernel's
    ``bit_planes``, beside them) -> (cost [E] int32, over [E] bool).  The
    plain version for CPU tensors; for CUDA tensors the kernel dp_plan
    picks, or an error."""
    if dp_plan(max_novel) == "bits":
        return banded_costs_bits(table, planes, reads, lens, starts, P,
                                 max_novel, del_lens, ins_lens)
    return banded_costs_warp(table, reads, lens, starts, P, max_novel,
                             del_lens, ins_lens)


# launches of each kernel; banded_costs.launches is their total
banded_costs.launches = 0
banded_costs_bits.launches = 0
banded_costs_warp.launches = 0
