# Port of hgtpu/align/aligner.py: the host logic is a copy; placement,
# the scan tables and the single fetch run on torch.
"""Batch read alignment against one gene's variant graph.

Replaces the reference's `hisat2` subprocess + SAM parsing
(typing_common.py:985-1056 -> typing_core.py:800-1124) with a two-stage
pipeline: diagonal placement over a variant-aware backbone PWM on the
device (hgtpu_torch.ops.placement, kernel K1) followed by variant-graph
verification on the host that emits cmp lists directly (align.verify,
or the native C++ verifier when it is built).
"""
from __future__ import annotations

import numpy as np
import torch

from ..db.catalog import GeneRef
from ..utils.dna import decode_seq
from ..utils.trace import TRACE, to_host
from .. import resolve_device
from ..ops.placement import (backbone_pwm, encode_reads,
                             place_batch_packed, place_scan_batch)
from ..ops.proposal_bound import pack_entries, pack_mask, proposal_bound
from .types import ReadAln, _UID as _aln_uid
from .verify import GeneVerifier


def _pad_codes_2d(code_list, n_rows, width, fill):
    """Stack variable-length int8 code arrays into [n_rows, width] with
    `fill` padding (rows beyond len(code_list) stay all-fill; codes longer
    than `width` are clipped) — one concatenate + one fancy scatter."""
    out = np.full((n_rows, width), fill, dtype=np.int8)
    if not code_list:
        return out
    clipped = [np.asarray(r[:width], np.int8) for r in code_list]
    lens = np.fromiter((len(r) for r in clipped), np.int64, len(clipped))
    rows = np.repeat(np.arange(len(clipped), dtype=np.int64), lens)
    cols = np.arange(int(lens.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(lens) - lens, lens)
    out[rows, cols] = np.concatenate(clipped) if clipped else []
    return out


def _first_min(group, *keys):
    """Positions of each group's first entry at the least `keys`
    (compared in order), ascending: the per-read first-minimal pick."""
    order = np.lexsort((np.arange(len(group)),) + keys[::-1] + (group,))
    g = group[order]
    head = np.ones(len(g), bool)
    head[1:] = g[1:] != g[:-1]
    return np.sort(order[head])


class _Entries:
    """One orientation rank's proposal entries as arrays, in order read,
    candidate, proposal (so each read's entries are contiguous): chunk
    row, orientation, backbone start, front clip, length and the capped
    novel-cost lower bound.  `codes(idx)` slices the subreads of the
    requested entries only: the staged verifier touches each read's first
    entry plus the rare lower-bound survivors."""

    __slots__ = ("rows", "rc", "starts", "clip", "lens", "lbs", "_fwd",
                 "_rcc")

    def __init__(self, st, rows, rc, starts, clip, lens, lbs):
        self.rows, self.rc, self.starts = rows, rc, starts
        self.clip, self.lens, self.lbs = clip, lens, lbs
        self._fwd, self._rcc = st["fwd_codes"], st["rc_codes"]

    def __len__(self):
        return len(self.rows)

    def codes(self, idx):
        fwd, rcc = self._fwd, self._rcc
        return [(rcc[i] if o else fwd[i])[c:c + n] for i, o, c, n in zip(
            self.rows[idx].tolist(), self.rc[idx].tolist(),
            self.clip[idx].tolist(), self.lens[idx].tolist())]

    def record(self, k, cost, ops):
        """Entry k's result tuple (cost, ops, start, clip_front, sub_len)."""
        return (int(cost), ops, int(self.starts[k]), int(self.clip[k]),
                int(self.lens[k]))


class GeneAligner:
    def __init__(self, gene: GeneRef, num_editdist: int = 2,
                 top_k: int = 8, min_seed_frac: float = 0.3,
                 device_batch: int = 4096, pad_len: int = 128,
                 use_native: str = "auto", leftmost: bool = False,
                 haplotype_paths: bool = True, device_verify: str = "auto",
                 place_scan: str = "auto", device=None):
        # leftmost=True prefers the smallest-start spelling among
        # equal-cost alignments — required for STR (CODIS) loci where
        # repeat periodicity makes right-shifted plain spellings cost-0
        # (the reference runs a dedicated aligner mode there:
        # --enable-codis, typing_common.py:1012-1016)
        self.gene = gene
        self.device = resolve_device(device)
        self.pwm = backbone_pwm(gene)
        self.verifier = GeneVerifier(gene, max_novel=num_editdist,
                                     haplotype_paths=haplotype_paths)
        self.num_editdist = num_editdist
        self.top_k = top_k
        self.min_seed_frac = min_seed_frac
        self.device_batch = device_batch
        self.pad_len = pad_len
        self._ext_cache = {}  # padded device PWM per read length
        self._start_tabs = {}  # read len -> _start_rows' table
        self._lb_mask = None   # the dilated match table on the device
        self.leftmost = leftmost
        # match table for the proposal lower-bound filter: tbl[p+PAD, b]
        # is True when base b at backbone pos p is free (backbone match or
        # catalog SNP).  Padded with PAD always-False rows per side so
        # shifted-diagonal gathers never need clamping.
        self._LB_PAD = max(4, num_editdist + 2)
        # 2048 always-False tail rows let batched gathers index
        # start + read_offset without clamping (reads are far shorter)
        self._LB_TAIL = 2048
        P = len(gene.backbone)
        tbl = np.zeros((P + 2 * self._LB_PAD + self._LB_TAIL, 6),
                       dtype=bool)
        bb = self.verifier.bb
        tbl[self._LB_PAD + np.arange(P), bb] = True
        for (pos, base) in self.verifier.single_at:
            tbl[self._LB_PAD + pos, base] = True
        self._match_ok6 = tbl
        # backbone codes padded the same way (sentinel 6 never matches)
        bb_pad = np.full(len(tbl), 6, dtype=np.int8)
        bb_pad[self._LB_PAD:self._LB_PAD + P] = bb
        self._bb_pad = bb_pad
        # +-num_editdist dilation along positions: one gather answers
        # "free on ANY shifted diagonal" for the lower-bound filter
        dil = tbl.copy()
        for d in range(1, num_editdist + 1):
            dil[d:] |= tbl[:-d]
            dil[:-d] |= tbl[d:]
        self._match_ok6_dil = dil
        # fused placement+scan program (ops.placement.place_scan_batch):
        # the fast-path planes (per-shift first/last novel mismatch, plain
        # -diagonal mismatch positions) ride the placement dispatch and
        # its bundled fetch instead of host [R, L] gathers.  "auto" takes
        # it on CUDA and on the CPU (hgtpu's rule off a TPU: the fetch is
        # local and cheap).  Off in leftmost (STR) mode, where the batch
        # fast paths are disabled.
        if place_scan not in ("auto", "on", "off"):
            raise ValueError("place_scan must be auto, on or off")
        self._use_scan = place_scan != "off" and not leftmost
        self._SCAN_KMM = 16
        self._scan_dev = None   # lazy (match_flat, bb_pad) device tables
        self.native = None
        if use_native in ("auto", "on"):
            from .native_verify import NativeVerifier, native_available
            if native_available():
                self.native = NativeVerifier(gene, max_novel=num_editdist,
                                             haplotype_paths=haplotype_paths)
            elif use_native == "on":
                raise RuntimeError("native verifier requested but "
                                   "native/libhgtpu_native.so is missing")
        # optional device verify backend: the banded variant-aware DP
        # (ops.banded_dp, a CUDA kernel on the card) scores every rank-0
        # proposal on the device; the native DFS then extracts the edit
        # script for each read's winning proposal only.  Entries the band
        # can't represent (overflow flag) and winners whose DFS cost
        # diverges (haplotype-window constraint) fall back to the full
        # host path, so results are bit-identical to device_verify="off".
        # hgtpu's "auto" takes it on a locally attached device (dispatch
        # round trip under 2 ms), which a CUDA card on its own bus is:
        # "auto" is on for CUDA beside the native verifier and off on the
        # CPU, as hgtpu's rule is off a TPU.  As in hgtpu, "on" builds the
        # tables whatever else holds, the DP runs only beside the native
        # verifier and not in leftmost mode (align_batches), and any other
        # value is "off".
        if device_verify == "auto":
            device_verify = "on" if (self.device.type == "cuda"
                                     and self.native is not None) else "off"
        self._dp_tables = None
        if device_verify == "on":
            from ..ops.banded_dp import BandedDPTables
            self._dp_tables = BandedDPTables(gene, self.device)

    def align_batch(self, read_ids, seqs, mate: str):
        """Align reads; returns list[ReadAln | None].

        mate: 'L' reads are used as-is-forward-preferred, 'R' reads are
        expected reverse-complemented (both orientations are always
        scored; the better one wins, ref SAM flag 0x10 equivalent).
        """
        return self.align_batches([(read_ids, seqs, mate)])[0]

    def align_batches(self, groups):
        """Align several read groups ([(read_ids, seqs, mate)], e.g. both
        mates) with ALL device placement launched up front and ONE bulk
        device->host fetch.  Device work runs in fixed power-of-two chunks
        (<= device_batch) padded to a multiple of `pad_len` bases.

        Returns one result list per group.
        """
        # identical sequences align identically (placement, verify, and
        # edit script are deterministic functions of the sequence), so
        # only distinct reads go through the device + verify path; tiled
        # simulations and PCR duplicates fan back out afterwards with a
        # shallow per-read record copy
        with TRACE.stage("place.uniq"):
            uniq_groups = []
            fanout = []
            for read_ids, seqs, mate in groups:
                first = {}
                inv = np.empty(len(seqs), dtype=np.int64)
                u_ids, u_seqs = [], []
                for i, s in enumerate(seqs):
                    j = first.get(s)
                    if j is None:
                        j = len(u_ids)
                        first[s] = j
                        u_ids.append(read_ids[i])
                        u_seqs.append(s)
                    inv[i] = j
                uniq_groups.append((u_ids, u_seqs, mate))
                fanout.append(inv)
            need_fanout = any(len(u[1]) < len(g[1])
                              for u, g in zip(uniq_groups, groups))
        if need_fanout:
            uniq_out = self._align_batches_impl(uniq_groups)
            with TRACE.stage("place.uniq"):
                out = []
                for (read_ids, _seqs, _mate), inv, u_res in zip(
                        groups, fanout, uniq_out):
                    res = []
                    for i, j in enumerate(inv.tolist()):
                        aln = u_res[j]
                        if aln is not None and aln.read_id != read_ids[i]:
                            # manual shallow clone: ~10x cheaper than
                            # copy.copy / dataclasses.replace on a dataclass.
                            # Relies on ReadAln being a plain (non-slots,
                            # no __post_init__) dataclass — guarded by
                            # tests/test_aligner.py::test_fanout_clone_equiv
                            clone = object.__new__(ReadAln)
                            clone.__dict__ = dict(aln.__dict__)
                            clone.read_id = read_ids[i]
                            aln = clone
                        res.append(aln)
                    out.append(res)
            return out
        return self._align_batches_impl(groups)

    def _align_batches_impl(self, groups):
        chunks_placed = []
        for gi, (read_ids, seqs, _mate) in enumerate(groups):
            # smallest power-of-two chunk that fits the group, capped at
            # device_batch: fewest dispatches without over-padding
            B = 512
            while B < min(len(seqs), self.device_batch):
                B *= 2
            B = min(B, self.device_batch)
            for i in range(0, len(seqs), B):
                chunk_ids = list(read_ids[i:i + B])
                chunk = list(seqs[i:i + B])
                pad = B - len(chunk)
                if pad:
                    chunk += ["A" * 32] * pad
                    chunk_ids += ["__pad__"] * pad
                with TRACE.stage("place.dispatch"):
                    chunks_placed.append((gi, chunk_ids, chunk, pad,
                                          self._place_chunk(chunk)))
        # one device->host fetch of exactly ONE packed array: the
        # per-chunk buffers are concatenated on the device first, so the
        # host waits for one copy (and int16 packing halves the bytes)
        handles = [entry[4][2] for entry in chunks_placed]
        with TRACE.stage("place.fetch"):
            h0 = handles[0]
            if len(handles) > 1 and all(
                    h.shape[1] == h0.shape[1] and h.dtype == h0.dtype
                    for h in handles):
                buf = to_host(torch.cat(handles, dim=0))
                sizes = np.cumsum([0] + [h.shape[0] for h in handles])
                fetched = [buf[sizes[i]:sizes[i + 1]]
                           for i in range(len(handles))]
            else:
                fetched = [to_host(h) for h in handles]
        states = []
        with TRACE.stage("place.resolve"):
            for (gi, chunk_ids, chunk, pad, placed), host_out in zip(
                    chunks_placed, fetched):
                placed = placed[:2] + (host_out,) + placed[3:]
                states.append((gi, pad, self._chunk_state(
                    chunk_ids, chunk, groups[gi][2], placed)))

        # batched device verify: ONE banded-DP launch covering the rank-0
        # proposals of every chunk of every group, one fetch of its result
        start_rank = 0
        if (self._dp_tables is not None and not self.leftmost
                and self.native is not None):
            per_chunk = [self._rank_entries(st, 0) for _g, _p, st in states]
            sizes = [0 if e is None else len(e) for e in per_chunk]
            if sum(sizes):
                got = [e for e in per_chunk if e is not None]
                with TRACE.stage("verify.dp_codes"):
                    codes = [r for e in got for r in e.codes(slice(None))]
                cost, over = self._dp_costs(
                    codes, np.concatenate([e.starts for e in got]))
                at = 0
                for e, n, (_gi, _pad, st) in zip(per_chunk, sizes, states):
                    if not n:
                        continue
                    with TRACE.stage("verify.dp_apply"):
                        self._apply_dp(st, e, cost[at:at + n],
                                       over[at:at + n])
                    at += n
            start_rank = 1  # rank-0 handled; leftovers retry natively

        out = [[] for _ in groups]
        for gi, pad, st in states:
            self._verify_pending(st, start_rank)
            res = self._chunk_output(st)
            out[gi].extend(res[: len(res) - pad] if pad else res)
        return out

    _COMP = np.array([3, 2, 1, 0, 4, 5], dtype=np.int8)

    @property
    def _scan_shifts(self):
        """Sorted distinct diagonal shifts (0 and +-each catalog indel
        length) — shared by the device scan program and the host
        fallback so plane columns always line up."""
        cached = self.__dict__.get("_scan_shifts_t")
        if cached is None:
            pos, ln, _is_ins, _ivar, _iright, _ic, _ms, _MAXI = \
                self._indel_fast_tables()
            D = len(pos) - 1
            cached = tuple(sorted({0} | {int(d) for d in ln[:D] if d}
                                  | {-int(d) for d in ln[:D] if d}))
            self._scan_shifts_t = cached
        return cached

    def _scan_tables(self):
        if self._scan_dev is None:
            self._scan_dev = (
                torch.from_numpy(self._match_ok6.reshape(-1)).to(self.device),
                torch.from_numpy(self._bb_pad).to(self.device))
        return self._scan_dev

    def _pwm_ext(self, m):
        """Zero-padded device PWM for read length m: zero rows on BOTH
        sides, so window index p is read start p - m and overhanging
        (soft-clippable) placements at either backbone end score their
        overlapping parts."""
        pwm_ext = self._ext_cache.get(m)
        if pwm_ext is None:
            pwm_ext = torch.from_numpy(
                np.concatenate([np.zeros((m, 5), np.float32), self.pwm,
                                np.zeros((m, 5), np.float32)],
                               axis=0)).to(self.device)
            if len(self._ext_cache) > 64:
                self._ext_cache.clear()
            self._ext_cache[m] = pwm_ext
        return pwm_ext

    def _place_chunk(self, seqs):
        max_len = max(len(s) for s in seqs)
        max_len = ((max_len + self.pad_len - 1) // self.pad_len) * self.pad_len
        n = len(seqs)
        fwd = encode_reads(seqs, max_len)               # [n, L] pad 4
        lens = np.fromiter((min(len(s), max_len) for s in seqs),
                           np.int64, n)
        # vectorized reverse complement of every row: the reversed row
        # carries read i at [L-m, L); shift it left by L-m via one gather
        j = np.arange(max_len)
        rev = fwd[:, ::-1]
        idx = np.minimum(j[None, :] + (max_len - lens)[:, None],
                         max_len - 1)
        rc = self._COMP[rev[np.arange(n)[:, None], idx]]
        rc[j[None, :] >= lens[:, None]] = 4
        fwd_codes = [fwd[i, : lens[i]] for i in range(n)]
        rc_codes = [rc[i, : lens[i]] for i in range(n)]
        both = torch.from_numpy(
            np.concatenate([fwd, rc], axis=0)).to(self.device)
        pwm_ext = self._pwm_ext(max_len)
        # launched K1 work, either branch: [2n, m*5] x [P1, m*5]^T
        P1 = pwm_ext.shape[0] - max_len + 1
        TRACE.count("flops.placement",
                    2.0 * both.shape[0] * (max_len * 5) * P1)
        if self._use_scan:
            match_flat, bb_dev = self._scan_tables()
            lens2 = torch.from_numpy(
                np.concatenate([lens, lens]).astype(np.int32)).to(self.device)
            device_out = place_scan_batch(
                pwm_ext, match_flat, bb_dev, both, lens2, top_k=self.top_k,
                shifts=self._scan_shifts, k_mm=self._SCAN_KMM,
                lb_pad=self._LB_PAD)
        else:
            device_out = place_batch_packed(pwm_ext, both, top_k=self.top_k)
        return fwd_codes, rc_codes, device_out, max_len, fwd, rc, lens, both

    def _resolve_scan(self, device_out, n, m):
        """Unpack the fetched place_scan_batch buffer into
        (sf, pf, sr, pr, use_rc, planes); planes =
        (first [2n, S], last [2n, S], mm_pos [2n, K], mm_cnt [2n])."""
        buf = np.asarray(device_out).astype(np.int32, copy=False)
        k = self.top_k
        S = len(self._scan_shifts)
        K = self._SCAN_KMM
        s = buf[:, :k]
        p = buf[:, k:2 * k] - m
        at = 2 * k
        first = buf[:, at:at + S]
        last = buf[:, at + S:at + 2 * S]
        at += 2 * S
        mm_pos = buf[:, at:at + K]
        mm_cnt = buf[:, at + K]
        use_rc = s[n:, 0] > s[:n, 0]
        return (s[:n], p[:n], s[n:], p[n:], use_rc,
                (first, last, mm_pos, mm_cnt))

    def _resolve_packed(self, device_out, n, m):
        """Unpack the place_batch_packed buffer into
        (sf, pf, sr, pr, use_rc)."""
        buf = np.asarray(device_out).astype(np.int32, copy=False)
        k = self.top_k
        s = buf[:, :k]
        p = buf[:, k:2 * k] - m
        use_rc = s[n:, 0] > s[:n, 0]
        return s[:n], p[:n], s[n:], p[n:], use_rc

    def _chunk_state(self, read_ids, seqs, mate: str, placed):
        """Pass 1 (host): resolve the fetched placement, run the
        exact-diagonal fast path, and stage the remaining reads for the
        verify backends."""
        n = len(seqs)
        (fwd_codes, rc_codes, device_out, max_len, fwd_pad, rc_pad, lens,
         both) = placed
        if self._use_scan:
            sf, pf, sr, pr, use_rc, planes = self._resolve_scan(
                device_out, n, max_len)
        else:
            sf, pf, sr, pr, use_rc = self._resolve_packed(device_out, n,
                                                          max_len)
            planes = None

        # batched exact-diagonal fast path: a full placement score means
        # every base matches the backbone or a known SNP on the plain
        # diagonal; one chunk-wide gather resolves those reads outright
        # (the spelling the DFS would prefer)
        fast_ops = self._fast_exact_batch(
            fwd_pad, rc_pad, lens, sf, pf, sr, pr, use_rc, planes) \
            if not self.leftmost else {}
        if not self.leftmost:
            rest = [i for i in range(n)
                    if i not in fast_ops and read_ids[i] != "__pad__"]
            fast_ops.update(self._fast_indel_batch(
                fwd_pad, rc_pad, lens, sf, pf, sr, pr, use_rc, rest,
                planes))

        results = [None] * n   # (cost, ops, start, clip_front, sub_len, is_rc)
        pending = []           # rows left to the native verifier
        for i in range(n):
            if read_ids[i] == "__pad__":
                continue
            is_rc = bool(use_rc[i])
            fast = fast_ops.get(i)
            if fast is not None:
                results[i] = (fast, [], is_rc)
                continue
            if self.native is not None:
                pending.append(i)
                continue
            m = len(fwd_codes[i])
            order = [(True, rc_codes[i], pr[i], sr[i]),
                     (False, fwd_codes[i], pf[i], sf[i])]
            if not use_rc[i]:
                order.reverse()
            for o_rc, codes, cand_p, cand_s in order:
                aln = self._verify_candidates(codes, cand_p, cand_s, m)
                if aln is not None:
                    if len(aln) == 6:
                        results[i] = (aln[:5], aln[5], o_rc)
                    else:
                        results[i] = (aln, [], o_rc)
                    break
        # "both" is the placement's [2n, L] codes where they are (row i
        # forward, n + i reverse); "cand" the [n, top_k] candidates
        return {"n": n, "read_ids": read_ids, "mate": mate,
                "fwd_codes": fwd_codes, "rc_codes": rc_codes,
                "lens": lens, "both": both, "cand": (sf, pf, sr, pr, use_rc),
                "results": results,
                "pending": np.asarray(pending, np.int64)}

    def _rank_entries(self, st, rank):
        with TRACE.stage("verify.prep"):
            return self._rank_entries_impl(st, rank)

    def _rank_entries_impl(self, st, rank):
        """The _Entries of the given orientation rank (0: the placement's
        preferred orientation) for the still-unresolved reads, lower-bound
        filtered; None when nothing survives."""
        with TRACE.stage("verify.prep.proposals"):
            at, rc, starts, clip, lens = self._expand(st, rank)
        if not len(at):
            return None
        rows = st["pending"][at]
        with TRACE.stage("verify.prep.bound"):
            lbs = self._lb_entries(st, rows + np.where(rc, st["n"], 0),
                                   starts, clip, lens)
        with TRACE.stage("verify.prep.filter"):
            keep = np.flatnonzero(lbs <= self.num_editdist)
        if not len(keep):
            return None
        return _Entries(st, rows[keep], rc[keep], starts[keep], clip[keep],
                        lens[keep], lbs[keep])

    def _expand(self, st, rank):
        """Every pending read's ordered proposal entries for one rank, as
        arrays (index into st["pending"], orientation, start, clip_front,
        sub_len) in order read, candidate, proposal (_expand_rows)."""
        pend = st["pending"]
        sf, pf, sr, pr, use_rc = st["cand"]
        rc = use_rc[pend] != bool(rank)
        at, s, clip, ln = self._expand_rows(
            np.where(rc[:, None], pr[pend], pf[pend]),
            np.where(rc[:, None], sr[pend], sf[pend]), st["lens"][pend])
        return at, rc[at], s, clip, ln

    def _expand_rows(self, cand_p, cand_s, m_all, max_clip_frac=0.35):
        """The ordered proposal entries of reads with candidate anchors
        cand_p [R, K], their scores cand_s [R, K] and lengths m_all [R],
        as arrays (read, start, clip_front, sub_len) in order read,
        candidate, proposal.

        Per read: the candidates up to the first one scoring below
        m * min_seed_frac, each candidate's start proposals
        (_start_rows), those clipped at a backbone end soft-clipped to the
        overlapping part (as the reference trims hisat2 soft clips,
        typing_core.py:1097-1107) unless a clip passes max_clip_frac of
        the read, and a start already proposed by an earlier candidate
        dropped (a start fixes its clip and length)."""
        cand_p = np.asarray(cand_p, np.int64)
        P = len(self.gene.backbone)
        parts = []
        for m in np.unique(m_all).tolist():
            sel = np.flatnonzero(m_all == m)
            valid = np.logical_and.accumulate(
                cand_s[sel] >= m * self.min_seed_frac, axis=1)
            r, k = np.nonzero(valid)                 # read, then candidate
            if not len(r):
                continue
            tab, count = self._start_rows(m, cand_p[sel[r], k])
            t = tab[np.arange(tab.shape[1])[None, :] < count[:, None]] \
                .astype(np.int64)
            at = np.repeat(sel[r], count)
            max_clip = int(m * max_clip_frac)
            clip = np.maximum(-t, 0)
            s = np.maximum(t, 0)
            over = s + (m - clip) - P
            ln = m - clip - np.maximum(over, 0)
            ok = np.flatnonzero((clip <= max_clip) & (over <= max_clip)
                                & (ln >= m - max_clip))
            _, first = np.unique((at[ok] << 32) + (t[ok] + (1 << 31)),
                                 return_index=True)
            ok = ok[np.sort(first)]
            parts.append((at[ok], s[ok], clip[ok], ln[ok]))
        if not parts:
            return tuple(np.zeros(0, np.int64) for _ in range(4))
        at, s, clip, ln = (np.concatenate(x) for x in zip(*parts))
        if len(parts) > 1:
            order = np.argsort(at, kind="stable")
            at, s, clip, ln = at[order], s[order], clip[order], ln[order]
        return at, s, clip, ln

    def _start_rows(self, m, anchors):
        """(starts [N, cap], counts [N]): _start_closure(p, m) of each
        anchor p, from a table per read length whose row for an anchor is
        filled the first time the anchor is seen (count 0: not yet).  The
        table covers the anchors [-m, P] at first, and grows to any
        anchor outside."""
        lo_need, hi_need = int(anchors.min()), int(anchors.max())
        tab = self._start_tabs.get(m)
        if tab is None or lo_need < tab[0] \
                or hi_need >= tab[0] + len(tab[2]):
            lo, hi = min(lo_need, -m), max(hi_need, len(self.gene.backbone))
            if tab is not None:
                lo, hi = min(lo, tab[0]), max(hi, tab[0] + len(tab[2]) - 1)
            rows = hi + 1 - lo
            new = (lo, np.zeros((rows, self._START_CAP), np.int32),
                   np.zeros(rows, np.int32))
            if tab is not None:
                at = tab[0] - lo
                new[1][at:at + len(tab[2])] = tab[1]
                new[2][at:at + len(tab[2])] = tab[2]
            tab = self._start_tabs[m] = new
        lo, starts, counts = tab
        idx = anchors - lo
        for q in np.unique(idx[counts[idx] == 0]).tolist():
            row = self._start_closure(q + lo, m)
            starts[q, :len(row)] = row
            counts[q] = len(row)
        return starts[idx], counts[idx]

    def _lb_entries(self, st, rows2, starts, clip, lens):
        """Each entry's novel-cost lower bound, capped (_lb_core): entry e
        reads row rows2[e] of the chunk's [2n, L] codes from column
        clip[e].  On a CUDA aligner the hand kernel bounds them where the
        codes already are (ops.proposal_bound); on the CPU, _lb_core."""
        E = len(starts)
        TRACE.count("verify.lb.entries", E)
        w_eff, W = self._lb_window(starts, lens)
        both = st["both"]
        if self.device.type == "cuda":
            if self._lb_mask is None:
                self._lb_mask = torch.from_numpy(
                    pack_mask(self._match_ok6_dil)).to(self.device)
            ent = torch.from_numpy(pack_entries(
                rows2, starts + self._LB_PAD, clip,
                np.minimum(w_eff, W))).to(self.device)
            lb = to_host(proposal_bound(both, self._lb_mask, ent,
                                        self.num_editdist + 1))
            TRACE.count("verify.lb.card", E)
            return lb
        # every _LB_BLOCK-column run of the chunk's codes, row after row,
        # as a view: an entry's block is one run (columns past its length
        # lie past its window and never count, whatever they hold)
        CH = self._LB_BLOCK
        runs = np.lib.stride_tricks.sliding_window_view(np.concatenate(
            [both.numpy().reshape(-1), np.zeros(CH, np.int8)]), CH)
        at0 = rows2 * both.shape[1] + clip

        def fetch(active, at, w):
            # gather one block for the still-active entries only: most
            # wrong proposals die in the first block, so the full [E, W]
            # gather is never materialized
            return runs[at0[active] + at, :w]

        return self._lb_core(fetch, E, starts, w_eff, W)

    def _lb_window(self, starts, lens):
        """(w_eff, W): per-entry scan window before the first catalog
        indel, and the matrix width that covers every window."""
        v = self.verifier
        B = self.num_editdist
        E = len(starts)
        sentinel = np.int64(len(v.bb) + 4096)
        if len(v.indel_pos):
            qi = np.searchsorted(v.indel_pos, starts, side="right")
            q = np.where(qi < len(v.indel_pos),
                         v.indel_pos[np.minimum(qi, len(v.indel_pos) - 1)],
                         sentinel)
        else:
            q = np.full(E, sentinel, dtype=np.int64)
        w_eff = np.minimum(lens, np.maximum(q - starts - B, 0))
        W = int(min(lens.max(), max(1, w_eff.max()), self._LB_TAIL))
        return w_eff, W

    _LB_BLOCK = 64    # columns a step of the host bound scan

    def _lb_core(self, fetch, E, starts, w_eff, W):
        """Per-entry novel-cost lower bound, CAPPED at num_editdist + 1
        (every caller only compares against costs <= the budget, so the
        cap loses nothing).  Scans in 64-column blocks and drops entries
        once they hit the cap — wrong-placement proposals accumulate
        mismatches within the first block, so the full [E, W] table
        gather is rarely paid.  `fetch(active, at, w)` supplies the code
        block [len(active), w] for the active entries."""
        cap = np.int64(self.num_editdist + 1)
        lb = np.zeros(E, np.int64)
        base0 = starts.astype(np.int32) + self._LB_PAD
        active = np.arange(E)
        CH = self._LB_BLOCK
        for at in range(0, W, CH):
            w = min(CH, W - at)
            j = np.arange(at, at + w, dtype=np.int32)
            bi = base0[active][:, None] + j[None, :]
            ok_any = self._match_ok6_dil[bi, fetch(active, at, w)]
            in_win = j[None, :] < w_eff[active][:, None]
            lb[active] += (in_win & ~ok_any).sum(axis=1)
            still = (lb[active] < cap) & (w_eff[active] > at + w)
            active = active[still]
            if not len(active):
                break
        return np.minimum(lb, cap)

    def _verify_pending(self, st, start_rank):
        """Pass 2: native batch verification (threads in C++), primary
        orientation first; unresolved reads retry the other orientation.
        start_rank=1 when rank 0 was already handled by the batched
        device DP."""
        if self.native is None:
            return
        for rank in range(start_rank, 2):
            if not len(st["pending"]):
                break
            entries = self._rank_entries(st, rank)
            if entries is None:
                continue
            self._resolve_entries_staged(entries, st["results"])
            self._drop_resolved(st)

    @staticmethod
    def _drop_resolved(st):
        results = st["results"]
        pend = st["pending"]
        st["pending"] = pend[np.fromiter(
            (results[i] is None for i in pend.tolist()), bool, len(pend))]

    def _chunk_output(self, st):
        with TRACE.stage("place.output"):
            return self._chunk_output_impl(st)

    def _chunk_output_impl(self, st):
        n = st["n"]
        read_ids = st["read_ids"]
        results = st["results"]
        fwd_codes, rc_codes = st["fwd_codes"], st["rc_codes"]
        mate = st["mate"]
        out = []
        P = len(self.gene.backbone)
        ops_to_cmp_list = self.verifier.ops_to_cmp_list

        def build(tup, i, is_rc):
            cost, ops, start, clip_front, sub_len = tup
            cmp_list, right = ops_to_cmp_list(ops, start, sub_len)
            if right > P:
                return None
            codes = rc_codes[i] if is_rc else fwd_codes[i]
            if clip_front or sub_len < len(codes):
                codes = codes[clip_front:clip_front + sub_len]
            # classify once here so the typing engine's hot loops test
            # two attributes instead of re-walking cmp per alignment
            # (ops holds exactly cmp's non-match entries, so classifying
            # from it skips the match segments)
            catalog = True
            has_indel = False
            for kind, _p, _l, vidx, _d in ops:
                if vidx is None or vidx < 0:
                    catalog = False
                if kind != "mismatch":
                    has_indel = True
            # direct construction: ReadAln is a plain dataclass and the
            # 12-kwarg __init__ is measurable at chunk scale (same trick
            # as the fan-out clone, guarded by test_fanout_clone_equiv)
            aln = object.__new__(ReadAln)
            aln.__dict__ = {
                "read_id": read_ids[i], "mate": mate, "pos": start,
                "right": right, "cmp": cmp_list, "nm": cost,
                "is_rc": is_rc, "seq": decode_seq(codes), "qual": "",
                "codes": codes, "alts": None, "catalog": catalog,
                "has_indel": has_indel, "uid": next(_aln_uid)}
            return aln

        for i in range(n):
            if results[i] is None:
                out.append(None)
                continue
            primary, others, is_rc = results[i]
            aln = build(primary, i, is_rc)
            if aln is None:
                out.append(None)
                continue
            if others:
                aln.alts = [a for a in (build(t, i, is_rc) for t in others)
                            if a is not None][:8]
            out.append(aln)
        return out

    def _resolve_entries(self, ent, idx, results, clear=None):
        """Run the native verifier over the entries `idx` of `ent` and
        install each read's best (cost, then proposal order; leftmost
        start in STR mode, with every other equal-cost spelling as its
        alternatives) into `results`.  `clear` lists read rows whose
        previous result must be discarded first (device-verify
        fallback)."""
        if clear is not None:
            for i in clear:
                results[i] = None
        if not len(idx):
            return
        reads = ent.codes(idx)
        starts = ent.starts[idx]
        with TRACE.stage("verify.native"):
            cost, nops, ops = self.native.verify_raw(reads, starts)
        cost = np.asarray(cost, np.int64)
        rows = ent.rows[idx]
        valid = np.flatnonzero(cost >= 0)
        if not len(valid):
            return
        keys = (cost[valid], starts[valid]) if self.leftmost \
            else (cost[valid],)
        win = valid[_first_min(rows[valid], *keys)]
        alts = {}
        if self.leftmost:
            best = np.full(int(rows.max()) + 1, -1, np.int64)
            best[rows[win]] = cost[win]
            same = (cost >= 0) & (cost == best[rows])
            same[win] = False
            for k in np.flatnonzero(same).tolist():
                alts.setdefault(int(rows[k]), []).append(k)
        # batch-materialize every needed edit script in one pass
        need = []                     # positions in idx, winners first
        for w in win.tolist():
            need.append(w)
            need.extend(alts.get(int(rows[w]), ()))
        ops_by = dict(zip(need, self.native.ops_entries_batch(
            [reads[k] for k in need], [nops[k] for k in need],
            [ops[k] for k in need])))
        for w in win.tolist():
            i = int(rows[w])
            results[i] = (ent.record(idx[w], cost[w], ops_by[w]),
                          [ent.record(idx[k], cost[k], ops_by[k])
                           for k in alts.get(i, ())],
                          bool(ent.rc[idx[w]]))

    def _resolve_entries_staged(self, ent, results):
        """Exact two-stage native verify: each read's FIRST proposal
        entry is scored first; later proposals are scored only when
        their novel-cost lower bound could STRICTLY beat the found cost.
        The non-leftmost pick is first-minimal (lowest entry index among
        minimal costs), so an unverified later entry with lb >= found
        cost can never change the result — most reads pay one DFS
        instead of one per proposal.  Leftmost/STR mode needs every
        equal-cost entry (alt spellings + leftmost tie-break) and stays
        on the single-batch path.  Only the entries actually verified
        are ever sliced (_Entries.codes)."""
        E = len(ent)
        head = np.ones(E, bool)           # each read's first entry
        head[1:] = ent.rows[1:] != ent.rows[:-1]
        if self.leftmost or head.all():
            return self._resolve_entries(ent, np.arange(E), results)
        f_idx = np.flatnonzero(head)
        reads1 = ent.codes(f_idx)
        with TRACE.stage("verify.native"):
            cost1, nops1, ops1 = self.native.verify_raw(reads1,
                                                        ent.starts[f_idx])
        cost1 = np.asarray(cost1, np.int64)
        limit = np.where(cost1 >= 0, cost1, self.num_editdist + 1)
        rest = np.flatnonzero(~head & (ent.lbs < limit[np.cumsum(head) - 1]))
        reads2 = []
        cost2 = np.zeros(0, np.int64)
        if len(rest):
            reads2 = ent.codes(rest)
            with TRACE.stage("verify.native"):
                cost2, nops2, ops2 = self.native.verify_raw(
                    reads2, ent.starts[rest])
            cost2 = np.asarray(cost2, np.int64)
        # the first-minimal (cost, entry) of each read over both batches
        idx = np.concatenate([f_idx, rest])
        cost = np.concatenate([cost1, cost2])
        order = np.argsort(idx, kind="stable")
        order = order[cost[order] >= 0]
        win = order[_first_min(ent.rows[idx[order]], cost[order])]
        src = [(reads1[w], nops1[w], ops1[w]) if w < len(f_idx) else
               (reads2[w - len(f_idx)], nops2[w - len(f_idx)],
                ops2[w - len(f_idx)]) for w in win.tolist()]
        all_ops = self.native.ops_entries_batch(*zip(*src)) if src else []
        for w, entry_ops in zip(win.tolist(), all_ops):
            k = idx[w]
            results[int(ent.rows[k])] = (ent.record(k, cost[w], entry_ops),
                                         [], bool(ent.rc[k]))

    def _dp_costs(self, flat_reads, flat_starts):
        """One banded-DP launch over proposal entries, W padded to a
        multiple of 32 as hgtpu pads it.  hgtpu also pads E to a power of
        two for XLA's compile cache; torch compiles nothing, and no
        entry's result depends on another's, so E stays as it is.
        Returns host (cost, over) arrays."""
        E = len(flat_reads)
        with TRACE.stage("verify.dp_pad"):
            W = max(len(r) for r in flat_reads)
            W = ((W + 31) // 32) * 32
            reads = _pad_codes_2d(flat_reads, E, W, fill=4)
            lens = np.fromiter((len(r) for r in flat_reads), np.int32, E)
            starts = np.asarray(flat_starts, np.int32)
        with TRACE.stage("verify.device_dp"):
            cost, over = self._dp_tables.costs(
                reads, lens, starts, max_novel=self.num_editdist)
            # the fetch waits for the kernel: keep it inside the stage
            cost = to_host(cost)
            over = to_host(over)
        return cost, over

    def _apply_dp(self, st, ent, cost, over):
        """Install each read's first-minimal DP winner via host
        edit-script extraction; reads whose winner overflowed the band
        or whose DFS cost diverges (haplotype-window constraint) redo
        the full proposal set, so results stay bit-identical to the
        host-only path."""
        results = st["results"]
        cost = np.asarray(cost, np.int64)
        over = np.asarray(over, bool)
        over_rows = np.unique(ent.rows[over])
        ok = np.flatnonzero(~over & (cost <= self.num_editdist))
        win = ok[_first_min(ent.rows[ok], cost[ok])]
        win = win[~np.isin(ent.rows[win], over_rows)]
        if len(win):
            self._resolve_entries(ent, win, results)
        redo = set(over_rows.tolist())
        for i, c_dp in zip(ent.rows[win].tolist(), cost[win].tolist()):
            r = results[i]
            if r is None or r[0][0] != c_dp:
                redo.add(i)
        if redo:
            rk = np.flatnonzero(np.isin(ent.rows, list(redo)))
            self._resolve_entries(ent, rk, results, clear=redo)
        self._drop_resolved(st)

    def _lb_keep(self, flat_reads, flat_starts):
        """Boolean keep-mask over proposal entries: False entries provably
        exceed the novel-edit budget, so the DFS need not run them.

        Bound: inside the window after `start` that precedes any catalog
        indel position, a path's backbone position for read base j can
        only drift within +-max_novel of the plain diagonal (each novel
        indel costs its length, catalog indels lie outside the window).
        A base matching neither backbone nor a catalog SNP on any of the
        2*max_novel+1 shifted diagonals therefore costs >= 1 novel edit
        on every path; counting such bases lower-bounds the true cost.
        """
        E = len(flat_reads)
        if E == 0:
            return np.zeros(0, dtype=bool)
        starts = np.asarray(flat_starts, dtype=np.int64)
        lens = np.array([len(r) for r in flat_reads], dtype=np.int64)
        w_eff, W = self._lb_window(starts, lens)
        reads_pad = _pad_codes_2d(flat_reads, E, W, fill=5)  # 5 never free

        def fetch(active, at, w):
            return reads_pad[active][:, at:at + w]

        return self._lb_core(fetch, E, starts, w_eff, W) \
            <= self.num_editdist

    def _fast_exact_batch(self, fwd_pad, rc_pad, lens, sf, pf, sr, pr,
                          use_rc, planes=None):
        """Chunk-wide _fast_exact: {row: (0, ops, start, 0, m)} for reads
        whose best-orientation top candidate attains the full placement
        score and whose every base is backbone- or catalog-SNP-free on
        the plain diagonal.

        With `planes` (the fused device scan, place_scan_batch) the
        mismatch positions were already extracted on the device on the
        placement dispatch; the host [R, L] compare runs only for rows
        whose mismatch count overflowed the device's k_mm slots."""
        P = len(self.gene.backbone)
        L = fwd_pad.shape[1]
        s0 = np.where(use_rc, pr[:, 0], pf[:, 0]).astype(np.int64)
        sc0 = np.where(use_rc, sr[:, 0], sf[:, 0])
        valid = (s0 >= 0) & (s0 + lens <= P) & (sc0 >= lens)
        if not valid.any():
            return {}
        # the placement score IS the free-base count on this diagonal
        # (backbone_pwm and _match_ok6 encode the same backbone-or-SNP
        # predicate, with the PWM strictly tighter on N bases), so a
        # full score sc0 == lens already proves every base free — no
        # per-base re-check gather is needed, only the mismatch
        # (catalog-SNP) extraction for the admitted rows.
        vr = np.flatnonzero(valid)
        s0v = s0[vr]
        lensv = lens[vr]
        out = {int(r): (0, [], int(s), 0, int(l))
               for r, s, l in zip(vr.tolist(), s0v.tolist(),
                                  lensv.tolist())}
        single_at = self.verifier.single_at
        n = len(use_rc)
        if planes is not None:
            _first, _last, mm_pos, mm_cnt = planes
            prow = vr + np.where(use_rc[vr], n, 0)
            easy = mm_cnt[prow] <= mm_pos.shape[1]
            er = vr[easy]
            if len(er):
                codes_e = np.where(use_rc[er, None], rc_pad[er],
                                   fwd_pad[er])
                pj = mm_pos[prow[easy]]                # [E, K] asc, -1 pad
                rws, cls = np.nonzero(pj >= 0)
                s0e = s0v[easy]
                for r_, c_ in zip(rws.tolist(), cls.tolist()):
                    jj = int(pj[r_, c_])
                    pos = int(s0e[r_]) + jj
                    base = int(codes_e[r_, jj])
                    out[int(er[r_])][1].append(
                        ("mismatch", pos, 1, single_at[(pos, base)],
                         "ACGT"[base]))
            vr = vr[~easy]                             # host fallback rows
            if not len(vr):
                return out
            s0v = s0v[~easy]
            lensv = lensv[~easy]
        codes_pad = np.where(use_rc[vr, None], rc_pad[vr], fwd_pad[vr])
        j = np.arange(L, dtype=np.int32)
        idx = (s0v.astype(np.int32) + self._LB_PAD)[:, None] + j[None, :]
        np.clip(idx, 0, len(self._match_ok6) - 1, out=idx)
        in_len = j[None, :] < lensv[:, None]
        mism = in_len & (codes_pad != self._bb_pad[idx])
        rows, cols = np.nonzero(mism)
        for r_, c_ in zip(rows.tolist(), cols.tolist()):
            pos = int(s0v[r_]) + c_
            base = int(codes_pad[r_, c_])
            out[int(vr[r_])][1].append(
                ("mismatch", pos, 1, single_at[(pos, base)],
                 "ACGT"[base]))
        return out

    def _indel_fast_tables(self):
        """Sorted catalog-indel arrays (+ sentinel row) for the chunk-wide
        single-indel fast path; cached on the aligner."""
        cached = self.__dict__.get("_indel_fast")
        if cached is not None:
            return cached
        from ..db.catalog import VT_DELETION, VT_INSERTION

        gene = self.gene
        MAXI = 16
        idx = np.flatnonzero((gene.var_type == VT_DELETION)
                             | (gene.var_type == VT_INSERTION))
        D = len(idx)
        pos = np.full(D + 1, 1 << 30, np.int64)
        ln = np.zeros(D + 1, np.int64)
        is_ins = np.zeros(D + 1, bool)
        ivar = np.full(D + 1, -1, np.int64)
        iright = np.full(D + 1, 1 << 30, np.int64)
        ins_codes = np.full((D + 1, MAXI), 7, np.int8)
        for k, vi in enumerate(idx):
            pos[k] = gene.var_pos[vi]
            ivar[k] = vi
            if gene.var_type[vi] == VT_INSERTION:
                is_ins[k] = True
                seq = gene.var_data[vi]
                iright[k] = pos[k]
                if len(seq) <= MAXI:
                    ln[k] = len(seq)
                    for j, b in enumerate(seq):
                        ins_codes[k, j] = "ACGT".index(b)
                # longer insertions keep length 0 (never spell; the DFS
                # path handles them)
            else:
                ln[k] = gene.var_len[vi]
                iright[k] = pos[k] + ln[k] - 1
        order = np.argsort(pos[:D], kind="stable")
        for arr in (pos, ln, is_ins, ivar, iright):
            arr[:D] = arr[order]
        ins_codes[:D] = ins_codes[order]
        max_shift = int(ln.max()) if D else 0
        self._indel_fast = (pos, ln, is_ins, ivar, iright, ins_codes,
                            max_shift, MAXI)
        return self._indel_fast

    def _fast_indel_batch(self, fwd_pad, rc_pad, lens, sf, pf, sr, pr,
                          use_rc, rows, planes=None):
        """Chunk-wide single-indel fast path: {row: (0, ops, start, 0, m)}
        for reads whose best-orientation placement admits EXACTLY ONE
        zero-novel split-diagonal spelling through one catalog
        deletion/insertion (matches + catalog SNPs elsewhere).

        Scoring is prefix-sum based: one mismatch-count plane per
        DISTINCT diagonal shift (the gene's deletion/insertion lengths,
        a dozen values) answers every (candidate, anchor) hypothesis
        with two O(1) lookups — prefix clean on the anchored diagonal
        and suffix clean on the shifted one — instead of materializing a
        per-hypothesis position tensor.  Uniqueness over the complete
        candidate window pins the DFS's minimal-cost answer: a second
        0-cost path would need another single indel (excluded) or repeat
        periodicity (STR loci run in leftmost mode, where this path is
        disabled).  Differentially pinned by
        tests/test_aligner.py::test_fast_indel_batch_matches_verifier.
        Everything else stays pending for the verifier."""
        pos, ln, is_ins, ivar, iright, ins_codes, max_shift, MAXI = \
            self._indel_fast_tables()
        D = len(pos) - 1
        if D == 0 or len(rows) == 0 or self.leftmost:
            return {}
        C = 12
        P = len(self.gene.backbone)
        rows = np.asarray(rows, np.int64)
        s0 = np.where(use_rc, pr[:, 0], pf[:, 0]).astype(np.int32)[rows]
        sc0 = np.where(use_rc, sr[:, 0], sf[:, 0])[rows]
        m = lens[rows].astype(np.int32)
        codes = np.where(use_rc[rows, None],
                         rc_pad[rows], fwd_pad[rows])          # [R, L]
        R, L = codes.shape

        # candidate window + completeness (the guard below needs every
        # in-window indel enumerated)
        c0 = np.searchsorted(pos[:D], s0 - max_shift)
        cand = np.minimum(c0[:, None] + np.arange(C)[None, :], D)
        cand = np.where(pos[cand] <= (s0 + m + max_shift)[:, None],
                        cand, D)                                # [R, C]
        nxt = np.minimum(c0 + C, D)
        complete = (c0 + C >= D) | (pos[nxt] > s0 + m + max_shift)

        # Every hypothesis test below is "no novel mismatch in an
        # interval anchored at 0 or m" on some shifted diagonal, so two
        # [R, S] index planes — first and last novel-mismatch position
        # per distinct shift — answer every (candidate, anchor) query
        # without materializing [R, S, L] prefix sums.  With `planes`
        # the device scan already computed them on the placement
        # dispatch (same shift order: _scan_shifts feeds both).
        shifts = list(self._scan_shifts)
        sh = np.asarray(shifts, np.int32)
        S = len(shifts)
        j = np.arange(L, dtype=np.int32)
        dl = np.where(is_ins[cand], 0, ln[cand]).astype(np.int32)
        il = np.where(is_ins[cand], ln[cand], 0).astype(np.int32)
        pv = pos[cand].astype(np.int64)
        ar_ = np.arange(R)
        if planes is not None:
            first_all, last_all = planes[0], planes[1]
            prow = rows + np.where(use_rc[rows],
                                   np.int64(len(use_rc)), 0)
            first = first_all[prow].astype(np.int32)            # [R, S]
            last = last_all[prow].astype(np.int32)              # [R, S]
        else:
            # sparse planes: each (row, shift) slot is gathered only when
            # some hypothesis below queries it — family 1/2 query the
            # +-deletion-length diagonals of in-window deletions, family
            # 3/4 the -+insertion-length diagonals of in-window
            # insertions, and every row with any candidate queries shift
            # 0.  Unqueried slots keep a poisoned default (first=-1,
            # last=L: "mismatch everywhere"), so if the needed-mask ever
            # under-covered, hypotheses would FAIL (reads fall to the
            # exact DFS) rather than accept a wrong spelling.
            has_cand = cand < D
            isdel_q = has_cand & (dl > 0)
            isins_q = has_cand & (il > 0)
            needed = np.zeros((R, S), bool)
            needed[:, np.searchsorted(sh, 0)] = has_cand.any(1)
            for qmask, shv in ((isdel_q, dl), (isdel_q, -dl),
                               (isins_q, il), (isins_q, -il)):
                rr, cc = np.nonzero(qmask)
                needed[rr, np.searchsorted(sh, shv[rr, cc])] = True
            first = np.full((R, S), -1, np.int32)
            last = np.full((R, S), L, np.int32)
            for k, d in enumerate(shifts):
                rk = np.flatnonzero(needed[:, k])
                if not len(rk):
                    continue
                base_k = (s0[rk, None] + self._LB_PAD) + j[None, :]
                idx = np.clip(base_k + d, 0, len(self._match_ok6) - 1)
                misk = ~self._match_ok6[idx, codes[rk]] \
                    & (j[None, :] < m[rk, None])
                any_ = misk.any(1)
                first[rk, k] = np.where(any_, misk.argmax(1), m[rk])
                last[rk, k] = np.where(any_,
                                       L - 1 - misk[:, ::-1].argmax(1), -1)

        def clean_prefix(shift_arr, q):
            """No novel mismatch in [0, q) on the shifted diagonal."""
            si = np.searchsorted(sh, shift_arr)
            return first[ar_[:, None], si] >= q

        def clean_suffix(shift_arr, lo):
            """No novel mismatch in [lo, m) on the shifted diagonal."""
            si = np.searchsorted(sh, shift_arr)
            return last[ar_[:, None], si] < lo

        zero = np.zeros_like(dl)
        # insertion content match per candidate (read-relative junction q
        # is the same for both anchors)
        full_list = []
        meta = []   # (s_h [R,C], q [R,C]) per hypothesis family

        def add_family(s_h, q, pre_shift, suf_shift, suf_from, extra_ok):
            valid = ((cand < D) & (s_h >= 0) & (q >= 1)
                     & (suf_from <= m[:, None] - 1)
                     & (s_h + m[:, None] - 1 + dl - il <= P - 1))
            pre_clean = clean_prefix(pre_shift, q)
            suf_clean = clean_suffix(suf_shift, suf_from)
            full_list.append(valid & pre_clean & suf_clean & extra_ok)
            meta.append((s_h, q))

        t = np.ones_like(dl, bool)
        # deletions: suffix rides diagonal +d relative to the read start
        is_del = (dl > 0)
        add_family(np.broadcast_to(s0[:, None], dl.shape),
                   (pv - s0[:, None]).astype(np.int32),
                   zero, dl, (pv - s0[:, None]).astype(np.int32),
                   is_del)
        add_family(s0[:, None] - dl,
                   (pv - s0[:, None] + dl).astype(np.int32),
                   -dl, zero, (pv - s0[:, None] + dl).astype(np.int32),
                   is_del)
        # insertions: il read bases spell the inserted sequence, the
        # suffix rides diagonal -il
        qi = (pv - s0[:, None]).astype(np.int32)
        ins_ok = np.ones_like(dl, bool)
        has_ins = is_ins[cand] & (il > 0)
        if has_ins.any():
            k = np.arange(MAXI, dtype=np.int32)
            rdpos = np.clip(qi[:, :, None] + k[None, None, :], 0, L - 1)
            rb = codes[ar_[:, None, None], rdpos]               # [R,C,MAXI]
            want = ins_codes[cand]
            ins_ok = np.where(k[None, None, :] < il[:, :, None],
                              rb == want, True).all(2)
        add_family(np.broadcast_to(s0[:, None], dl.shape), qi,
                   zero, -il, qi + il, has_ins & ins_ok)
        qi2 = (pv - s0[:, None] - il).astype(np.int32)
        ins_ok2 = np.ones_like(dl, bool)
        if has_ins.any():
            k = np.arange(MAXI, dtype=np.int32)
            rdpos = np.clip(qi2[:, :, None] + k[None, None, :], 0, L - 1)
            rb = codes[ar_[:, None, None], rdpos]
            want = ins_codes[cand]
            ins_ok2 = np.where(k[None, None, :] < il[:, :, None],
                               rb == want, True).all(2)
        add_family(s0[:, None] + il, qi2,
                   il, zero, qi2 + il, has_ins & ins_ok2)

        full = np.concatenate(full_list, 1)                    # [R, 4C]
        nf = full.sum(1)
        acc = (nf == 1) & complete & (sc0 < m)
        if not acc.any():
            return {}
        win = np.argmax(full, 1)
        fam = win // C
        wc = win % C

        # ---- ops assembly for accepted rows ---- #
        accr = np.flatnonzero(acc)
        A = len(accr)
        s_w = np.stack([mt[0] for mt in meta], 1)[accr, fam[accr], wc[accr]]
        q_w = np.stack([mt[1] for mt in meta], 1)[accr, fam[accr], wc[accr]]
        c_w = cand[accr, wc[accr]]
        dl_w = dl[accr, wc[accr]]
        il_w = il[accr, wc[accr]]
        pv_w = pv[accr, wc[accr]].astype(np.int32)
        m_w = m[accr]
        codes_w = codes[accr]
        # split-diagonal backbone positions of the winning spelling
        in_pre = j[None, :] < q_w[:, None]
        in_insr = (il_w[:, None] > 0) & ~in_pre \
            & (j[None, :] < (q_w + il_w)[:, None])
        bbpos = (s_w[:, None] + j[None, :]
                 + np.where(~in_pre, dl_w[:, None], 0)
                 - np.where(j[None, :] >= (q_w + il_w)[:, None],
                            il_w[:, None], 0))
        gw = np.clip(bbpos + self._LB_PAD, 0, len(self._bb_pad) - 1)
        in_len = j[None, :] < m_w[:, None]
        mm = (in_len & ~in_insr
              & (codes_w != self._bb_pad[gw]))
        single_at = self.verifier.single_at
        out = {}
        ops_all = [[] for _ in range(A)]
        rws, cls = np.nonzero(mm)
        for k_, jj in zip(rws.tolist(), cls.tolist()):
            bpos = int(gw[k_, jj]) - self._LB_PAD
            base = int(codes_w[k_, jj])
            ops_all[k_].append(
                ("mismatch", bpos, 1, single_at[(bpos, base)],
                 "ACGT"[base]))
        for k_ in range(A):
            c = int(c_w[k_])
            if is_ins[c]:
                seq = "".join("ACGT"[b] for b in
                              ins_codes[c, : int(ln[c])])
                iop = ("insertion", int(pv_w[k_]), int(ln[c]),
                       int(ivar[c]), seq)
            else:
                iop = ("deletion", int(pv_w[k_]), int(ln[c]),
                       int(ivar[c]), str(int(ln[c])))
            ops = ops_all[k_]
            at = 0
            while at < len(ops) and ops[at][1] < iop[1]:
                at += 1
            ops.insert(at, iop)
            r = int(rows[accr[k_]])
            out[r] = (0, ops, int(s_w[k_]), 0, int(m_w[k_]))
        return out

    def _proposal_entries(self, codes, cand_pos, cand_scores, m):
        """Ordered verification entries [(sub_codes, start, clip_front)]
        of one read (_expand_rows)."""
        _, starts, clip, ln = self._expand_rows(
            np.asarray(cand_pos)[None], np.asarray(cand_scores)[None],
            np.array([m]))
        return [(codes[c:c + n], s, c) for s, c, n in
                zip(starts.tolist(), clip.tolist(), ln.tolist())]

    def _verify_candidates(self, codes, cand_pos, cand_scores, m):
        """Returns (cost, ops, start, clip_front, clip_len) or None.

        In leftmost (STR) mode the result carries every equal-cost
        spelling, leftmost first, as a 6th element."""
        best = None
        equal = []
        entries = self._proposal_entries(codes, cand_pos, cand_scores, m)
        if entries:
            keep = self._lb_keep([e[0] for e in entries],
                                 [e[1] for e in entries])
            entries = [e for e, k in zip(entries, keep) if k]
        for sub, s, clip_front in entries:
            res = self.verifier.verify(sub, s)
            if res is None:
                continue
            cost, ops = res
            if self.leftmost:
                if best is None or cost < best[0]:
                    best = (cost, ops, s, clip_front, len(sub))
                    equal = [best]
                elif cost == best[0]:
                    equal.append((cost, ops, s, clip_front, len(sub)))
                    if s < best[2]:
                        best = equal[-1]
                continue
            if best is None or cost < best[0]:
                best = (cost, ops, s, clip_front, len(sub))
                if cost == 0 and len(sub) == m:
                    return best
        if self.leftmost and best is not None:
            others = [e for e in equal if e is not best]
            return (*best, others)
        return best

    _START_CAP = 48    # start proposals per anchor

    def _start_closure(self, p, m, max_depth=3):
        """Candidate read-start positions for an anchor diagonal p.

        The diagonal placement votes for the read's longest match segment; every
        known indel preceding that segment within the read shifts the true
        start (deletion: start -= len, insertion: start += len).  We close
        over up to `max_depth` stacked indel shifts.  Ref equivalent:
        HISAT2's internal seed-chain resolution across graph edges.
        """
        v = self.verifier
        seen = {p}
        frontier = [p]
        order = [p]
        for _ in range(max_depth):
            nxt = []
            for s in frontier:
                # the shift-causing indel lies between the true start t and
                # the anchored segment, so its position can precede s by up
                # to the deletion length: scan q in (s - 64, s + m]
                i = np.searchsorted(v.indel_pos, max(0, s - 64))
                while i < len(v.indel_pos) and v.indel_pos[i] <= s + m + 8:
                    q = int(v.indel_pos[i])
                    for dlen, _vi in v.dels_at.get(q, ()):
                        t = s - dlen
                        if t >= 0 and t < q <= t + m and t not in seen:
                            seen.add(t)
                            nxt.append(t)
                    for ins_codes, _vi in v.ins_at.get(q, ()):
                        t = s + len(ins_codes)
                        if t < q <= t + m and t not in seen:
                            seen.add(t)
                            nxt.append(t)
                    i += 1
            order.extend(nxt)
            frontier = nxt
            if not frontier or len(order) >= self._START_CAP:
                break
        return order[:self._START_CAP]
