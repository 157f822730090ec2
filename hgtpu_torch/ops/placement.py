"""Diagonal placement of read batches on the backbone (port of
hgtpu/ops/placement.py).

Scores every start diagonal of every read against the variant-aware
backbone PWM (1 where a base matches the backbone or a known SNP) and
keeps the top diagonals per read.  The all-diagonal scores come from
kernel K1 (``ops.placement_kernel.placement_scores``); top-k, the scan
planes and the packing are plain torch.

``lax.top_k`` returns the lowest index first among equal values and
``torch.topk`` promises no order, so the diagonal top-k runs on a unique
int64 key, score * 2**21 + (2**21 - 1 - p): exact for integer scores and
P1 < 2**21.
"""
from __future__ import annotations

import numpy as np
import torch

from ..db.catalog import GeneRef, VT_SINGLE
from .placement_kernel import placement_scores

_POS_BITS = 21


def backbone_pwm(gene: GeneRef) -> np.ndarray:
    """[P, 5] float: 1 where base matches backbone or a known single-nt
    variant at that position; N (code 4) scores 0 everywhere."""
    P = len(gene.backbone)
    pwm = np.zeros((P, 5), dtype=np.float32)
    pwm[np.arange(P), gene.backbone_enc] = 1.0
    singles = gene.var_type == VT_SINGLE
    for vi in np.flatnonzero(singles):
        base = "ACGT".index(gene.var_data[vi])
        pwm[int(gene.var_pos[vi]), base] = 1.0
    pwm[:, 4] = 0.0
    return pwm


def encode_reads(seqs, read_len: int) -> np.ndarray:
    """Pad/truncate reads to read_len; returns int8 [N, read_len] codes
    (pad code 4 = N, which scores 0).

    One table lookup over the joined byte buffer plus one fancy scatter —
    no per-read Python."""
    from ..utils.dna import _ENC

    n = len(seqs)
    out = np.full((n, read_len), 4, dtype=np.int8)
    if n == 0:
        return out
    clipped = [s[:read_len] for s in seqs]
    lens = np.fromiter((len(s) for s in clipped), np.int64, n)
    flat = _ENC[np.frombuffer("".join(clipped).encode("ascii"), np.uint8)]
    L0 = int(lens[0])
    if int(lens.min()) == L0 == int(lens.max()):
        # uniform-length batch (the common case): one reshape instead
        # of the ragged fancy scatter
        out[:, :L0] = flat.reshape(n, L0)
        return out
    tot = int(lens.sum())
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = np.arange(tot, dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    out[rows, cols] = flat
    return out


def correlate_scores(pwm_ext: torch.Tensor, reads: torch.Tensor):
    """All-diagonal placement scores [N, P+1] (kernel K1)."""
    return placement_scores(pwm_ext, reads)


def _top_diagonals(scores: torch.Tensor, k: int):
    """(top scores [N, k], positions [N, k]), descending by score, lowest
    position first among ties — lax.top_k's order."""
    P1 = scores.shape[1]
    if P1 >= 1 << _POS_BITS:
        raise ValueError("backbone too long for the top-k key: P1=%d" % P1)
    pos = torch.arange(P1, dtype=torch.int64, device=scores.device)
    key = (scores.to(torch.int64) << _POS_BITS) \
        | ((1 << _POS_BITS) - 1 - pos)
    top = torch.topk(key, k, dim=1).values
    return top >> _POS_BITS, (1 << _POS_BITS) - 1 - (top & ((1 << _POS_BITS) - 1))


def place_batch(pwm_ext: torch.Tensor, reads: torch.Tensor,
                top_k: int = 4):
    """Score every start diagonal for every read.

    pwm_ext: [P + m, 5] backbone PWM padded with m zero rows.
    reads:   [N, m] int8 codes.
    Returns (scores [N, top_k] float32, positions [N, top_k] int32), as
    hgtpu's lax.top_k returns them."""
    top_scores, top_pos = _top_diagonals(correlate_scores(pwm_ext, reads),
                                         top_k)
    return top_scores.to(torch.float32), top_pos.to(torch.int32)


def _fetch_dtype(pwm_ext, m):
    """int16 when every packed value (scores <= m, window indices < P1,
    read offsets <= m) fits; int32 for very long backbones."""
    P1 = pwm_ext.shape[0] - m + 1
    return torch.int16 if max(P1, m) + 2 < 32767 else torch.int32


def place_batch_packed(pwm_ext: torch.Tensor, reads: torch.Tensor,
                       top_k: int = 4) -> torch.Tensor:
    """(scores, positions) of the top_k diagonals packed into ONE integer
    array [N, 2*top_k], so the host fetches a single buffer."""
    n, m = reads.shape
    top_scores, top_pos = _top_diagonals(correlate_scores(pwm_ext, reads),
                                         top_k)
    dt = _fetch_dtype(pwm_ext, m)
    return torch.cat([top_scores.to(dt), top_pos.to(dt)], dim=1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none): jnp.argmax of a
    bool row.  torch refuses bool argmax and returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def place_scan_batch(pwm_ext: torch.Tensor, match_flat: torch.Tensor,
                     bb_pad: torch.Tensor, reads: torch.Tensor,
                     lens: torch.Tensor, top_k: int, shifts: tuple,
                     k_mm: int, lb_pad: int) -> torch.Tensor:
    """Placement + the fast-path scan planes in one pass.

    On top of the diagonal scores this computes, per row, on the row's
    TOP-1 diagonal:
      * first/last novel-mismatch read index per shifted diagonal
        (`shifts`, the gene's catalog indel lengths) — the planes
        GeneAligner._fast_indel_batch would otherwise build on the host;
      * the first `k_mm` mismatch-vs-backbone read positions and the
        total count on the plain diagonal.

    match_flat: flattened [T * 6] bool free-base table (row-major
      match_ok6: backbone match or catalog SNP), T = P + 2*lb_pad + tail.
    bb_pad:     [T] int8 backbone codes padded like match_ok6 (sentinel 6).
    lens:       [N] int32 real read lengths.

    Returns ONE packed integer array [N, X] (int16 when the backbone
    fits, see _fetch_dtype) with columns
      [scores(top_k) | top_pos(top_k) | first(S) | last(S)
       | mm_pos(k_mm) | mm_cnt]
    """
    n, m = reads.shape
    dev = reads.device
    top_scores, top_pos = _top_diagonals(correlate_scores(pwm_ext, reads),
                                         top_k)

    T = bb_pad.shape[0]
    start = top_pos[:, 0] - m                          # window -> read start
    j = torch.arange(m, dtype=torch.int64, device=dev)
    base = (start[:, None] + lb_pad) + j[None, :]      # [N, m]
    lens = lens.to(torch.int64)
    in_len = j[None, :] < lens[:, None]
    codes = reads.to(torch.int64)

    firsts, lasts = [], []
    for d in shifts:
        idx = torch.clamp(base + d, 0, T - 1)
        ok = match_flat[idx * 6 + codes]
        mis = ~ok & in_len
        any_ = mis.any(dim=1)
        firsts.append(torch.where(any_, _first_true(mis), lens))
        lasts.append(torch.where(any_, m - 1 - _first_true(mis.flip(1)),
                                 torch.full_like(lens, -1)))
    first = torch.stack(firsts, dim=1)                 # [N, S]
    last = torch.stack(lasts, dim=1)                   # [N, S]

    idx0 = torch.clamp(base, 0, T - 1)
    mm = (codes != bb_pad[idx0].to(torch.int64)) & in_len
    sentinel = -(m + 1)
    vals = torch.where(mm, -j[None, :], torch.full_like(base, sentinel))
    # ascending j order; ties only among sentinels, which all map to -1
    negpos = torch.topk(vals, k_mm, dim=1).values
    mm_pos = torch.where(negpos == sentinel, torch.full_like(negpos, -1),
                         -negpos)
    mm_cnt = mm.sum(dim=1)

    dt = _fetch_dtype(pwm_ext, m)
    # mm_cnt can reach m (< 32767) and every other column is a score,
    # window index, or read offset — all within the packed dtype
    return torch.cat(
        [top_scores.to(dt), top_pos.to(dt), first.to(dt), last.to(dt),
         mm_pos.to(dt), mm_cnt[:, None].to(dt)], dim=1)


def place_with_orientation(pwm, fwd: np.ndarray, rc: np.ndarray,
                           top_k: int = 4, block: bool = True,
                           ext_cache=None, device=None):
    """Place both orientations.

    With block=True returns (scores_f, pos_f, scores_r, pos_r) each
    [N, top_k] plus use_rc [N].  With block=False returns the device
    (scores, positions) tensors without waiting for them — resolve later
    with `resolve_placement` so host work overlaps the device queue.
    `ext_cache` (owned by the caller, keyed by read length) holds the
    zero-padded device PWM — the cache must be per-PWM, never global.
    """
    from .. import resolve_device
    from ..utils.trace import TRACE

    dev = resolve_device(device)
    m = fwd.shape[1]
    _ext_cache = ext_cache if ext_cache is not None else {}
    pwm_ext = _ext_cache.get(m)
    if pwm_ext is None:
        # zero padding on BOTH sides: window index p corresponds to read
        # start p - m, so overhanging (soft-clippable) placements at both
        # backbone ends score their overlapping parts
        pwm_ext = torch.from_numpy(
            np.concatenate([np.zeros((m, 5), np.float32), pwm,
                            np.zeros((m, 5), np.float32)], axis=0)).to(dev)
        if len(_ext_cache) > 64:
            _ext_cache.clear()
        _ext_cache[m] = pwm_ext
    both = np.concatenate([fwd, rc], axis=0)
    # launched K1 work: [2N, m*5] x [P1, m*5]^T
    P1 = pwm_ext.shape[0] - m + 1
    TRACE.count("flops.placement", 2.0 * both.shape[0] * (m * 5) * P1)
    handles = place_batch(pwm_ext, torch.from_numpy(
        np.ascontiguousarray(both, np.int8)).to(pwm_ext.device), top_k=top_k)
    if not block:
        return handles
    return resolve_placement(handles, fwd.shape[0], m)


def resolve_placement(handles, n, m):
    s, p = handles
    s = s.cpu().numpy()
    p = p.cpu().numpy() - m   # window index -> read start (may be negative)
    use_rc = s[n:, 0] > s[:n, 0]
    return s[:n], p[:n], s[n:], p[n:], use_rc
