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
        self._prop_cache = {}  # start proposals per (anchor, read len)
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
            sizes = [len(e[2]) if e else 0 for e in per_chunk]
            if sum(sizes):
                with TRACE.stage("verify.dp_codes"):
                    codes = [r for e in per_chunk if e
                             for r in e[0](range(len(e[2])))]
                cost, over = self._dp_costs(
                    codes, [s for e in per_chunk if e for s in e[1]])
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
        return fwd_codes, rc_codes, device_out, max_len, fwd, rc, lens

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
        fwd_codes, rc_codes, device_out, max_len, fwd_pad, rc_pad, lens = \
            placed
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
        pending = []           # (read i, orientation order, read len)
        for i in range(n):
            if read_ids[i] == "__pad__":
                continue
            m = len(fwd_codes[i])
            is_rc = bool(use_rc[i])
            fast = fast_ops.get(i)
            if fast is not None:
                results[i] = (fast, [], is_rc)
                continue
            order = [(True, rc_codes[i], pr[i], sr[i]),
                     (False, fwd_codes[i], pf[i], sf[i])]
            if not use_rc[i]:
                order.reverse()
            if self.native is not None:
                pending.append((i, order, m))
            else:
                for o_rc, codes, cand_p, cand_s in order:
                    aln = self._verify_candidates(codes, cand_p, cand_s, m)
                    if aln is not None:
                        if len(aln) == 6:
                            results[i] = (aln[:5], aln[5], o_rc)
                        else:
                            results[i] = (aln, [], o_rc)
                        break
        return {"n": n, "read_ids": read_ids, "mate": mate,
                "fwd_codes": fwd_codes, "rc_codes": rc_codes,
                "fwd_pad": fwd_pad, "rc_pad": rc_pad,
                "results": results, "pending": pending}

    def _rank_entries(self, st, rank):
        with TRACE.stage("verify.prep"):
            return self._rank_entries_impl(st, rank)

    def _rank_entries_impl(self, st, rank):
        """Flat proposal entries of the given orientation rank for the
        still-unresolved reads, lower-bound filtered; None when nothing
        survives.  Returns (get_codes, flat_starts, flat_meta, lbs) —
        per-entry read codes are NOT materialized here: the staged
        verifier touches only each read's first proposal plus the rare
        lower-bound survivors, so slicing all E subreads up front paid
        ~E list/array allocations for entries that are never verified.
        get_codes(idxs) materializes exactly the requested entries."""
        flat_starts, flat_meta = [], []
        with TRACE.stage("verify.prep.proposals"):
            for i, order, m in st["pending"]:
                o_rc, codes, cand_p, cand_s = order[rank]
                for s, cf, ln in self._proposal_meta(cand_p, cand_s, m):
                    flat_starts.append(s)
                    flat_meta.append((i, o_rc, cf, ln))
        if not flat_meta:
            return None
        with TRACE.stage("verify.prep.bound"):
            lbs = self._lb_values_meta(st, flat_meta, flat_starts)
        with TRACE.stage("verify.prep.filter"):
            keep = lbs <= self.num_editdist
            if not keep.all():
                kept = np.flatnonzero(keep)
                flat_starts = [flat_starts[k] for k in kept]
                flat_meta = [flat_meta[k] for k in kept]
                lbs = lbs[kept]
        if not flat_meta:
            return None
        fwd_codes, rc_codes = st["fwd_codes"], st["rc_codes"]

        def get_codes(idxs):
            out = []
            for k in idxs:
                i, o_rc, cf, ln = flat_meta[k]
                c = rc_codes[i] if o_rc else fwd_codes[i]
                out.append(c[cf:cf + ln])
            return out

        return get_codes, flat_starts, flat_meta, lbs

    def _proposal_meta(self, cand_pos, cand_scores, m,
                       max_clip_frac=0.35):
        """_proposal_entries without materializing subreads: ordered
        (start, clip_front, sub_len) tuples (same dedup + clip rules).

        Memoized on (valid candidate prefix, m): the output depends on
        cand_scores only through the first below-threshold break, so
        reads anchored at the same diagonals (common among punts from
        the same locus) share one computed list."""
        min_score = m * self.min_seed_frac
        kv = 0
        while kv < len(cand_pos) and cand_scores[kv] >= min_score:
            kv += 1
        ck = (m, bytes(np.ascontiguousarray(cand_pos[:kv]).data))
        cache = self.__dict__.setdefault("_pmeta_cache", {})
        hit = cache.get(ck)
        if hit is not None:
            return hit
        out = []
        P = len(self.gene.backbone)
        max_clip = int(m * max_clip_frac)
        tried = set()
        for k in range(len(cand_pos)):
            if cand_scores[k] < min_score:
                break
            for start in self._start_proposals(int(cand_pos[k]), m):
                clip_front = 0
                ln = m
                s = start
                if s < 0:
                    clip_front = -s
                    if clip_front > max_clip:
                        continue
                    ln -= clip_front
                    s = 0
                overhang = s + ln - P
                if overhang > 0:
                    if overhang > max_clip:
                        continue
                    ln -= overhang
                key = (s, clip_front, ln)
                if ln < m - max_clip or key in tried:
                    continue
                tried.add(key)
                out.append(key)
        if len(cache) > 100000:
            cache.clear()
        cache[ck] = out
        return out

    def _lb_values_meta(self, st, flat_meta, flat_starts):
        """_lb_keep without materializing per-entry read copies: every
        proposal entry is a (clip, length) window of a chunk row, so one
        fancy gather from the chunk's padded code matrices builds the
        [E, W] matrix the bound scans (same result as _lb_keep on the
        materialized subreads)."""
        comb = st.get("comb_pad")
        if comb is None or comb.shape[0] != 2 * st["n"]:
            comb = np.concatenate([st["fwd_pad"], st["rc_pad"]], axis=0)
            st["comb_pad"] = comb
        n = st["n"]
        E = len(flat_meta)
        rows = np.fromiter((m[0] + (n if m[1] else 0) for m in flat_meta),
                           np.int64, E)
        cfs = np.fromiter((m[2] for m in flat_meta), np.int64, E)
        lens = np.fromiter((m[3] for m in flat_meta), np.int64, E)
        starts = np.asarray(flat_starts, dtype=np.int64)
        w_eff, W = self._lb_window(starts, lens)

        def fetch(active, at, w):
            # gather one 64-column block for the still-active entries
            # only: most wrong proposals die in the first block, so the
            # full [E, W] gather is never materialized
            jj = np.arange(at, at + w, dtype=np.int64)
            col = np.minimum(cfs[active][:, None] + jj[None, :],
                             comb.shape[1] - 1)
            rp = comb[rows[active][:, None], col]
            rp[jj[None, :] >= lens[active][:, None]] = 5   # 5 never free
            return rp

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
        CH = 64
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
        if self.native is None or not st["pending"]:
            return
        results = st["results"]
        for rank in range(start_rank, 2):
            if not st["pending"]:
                break
            entries = self._rank_entries(st, rank)
            if entries is None:
                continue
            self._resolve_entries_staged(entries[0], entries[1],
                                         entries[2], entries[3], results)
            st["pending"] = [po for po in st["pending"]
                             if results[po[0]] is None]

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

    def _resolve_entries(self, flat_reads, flat_starts, flat_meta, results,
                         clear=None):
        """Run the native verifier over proposal entries and install each
        read's best (cost, then proposal-order; leftmost start in STR
        mode) result into `results`.  `clear` lists read rows whose
        previous result must be discarded first (device-verify
        fallback)."""
        if clear:
            for i in clear:
                results[i] = None
        if not flat_reads:
            return
        with TRACE.stage("verify.native"):
            cost, nops, ops = self.native.verify_raw(flat_reads, flat_starts)
        E = len(flat_meta)
        best = {}
        if not self.leftmost and E > 64:
            # vectorized per-read first-minimal-cost pick (the python
            # dict walk below costs ~7us/entry over 10k+ entries)
            cost_np = np.asarray(cost, dtype=np.int64)
            reads_np = np.fromiter((m[0] for m in flat_meta), np.int64, E)
            valid = cost_np >= 0
            if valid.any():
                key = cost_np * E + np.arange(E, dtype=np.int64)
                hi = np.int64(1) << 62
                nmax = int(reads_np.max()) + 1
                slot = np.full(nmax, hi)
                np.minimum.at(slot, reads_np[valid], key[valid])
                for i in np.flatnonzero(slot < hi).tolist():
                    idx = int(slot[i] % E)
                    _i, o_rc, cf, slen = flat_meta[idx]
                    best[i] = (int(slot[i] // E), idx, o_rc, cf, slen)
        else:
            for idx, (i, o_rc, cf, slen) in enumerate(flat_meta):
                c = int(cost[idx])
                if c < 0:
                    continue
                better = i not in best or c < best[i][0] or (
                    self.leftmost and c == best[i][0]
                    and int(flat_starts[idx]) < int(flat_starts[best[i][1]]))
                if better:
                    best[i] = (c, idx, o_rc, cf, slen)
        equal_alts = {}
        if self.leftmost:
            for idx, (i, o_rc, cf, slen) in enumerate(flat_meta):
                c = int(cost[idx])
                if i in best and c == best[i][0] and idx != best[i][1]:
                    equal_alts.setdefault(i, []).append(
                        (c, idx, o_rc, cf, slen))
        # batch-materialize every needed edit script in one pass
        need = []                     # flat entry indices, winners first
        for i, (c, idx, o_rc, cf, slen) in best.items():
            need.append(idx)
            need.extend(e[1] for e in equal_alts.get(i, ()))
        ops_by_idx = dict(zip(need, self.native.ops_entries_batch(
            [flat_reads[k] for k in need],
            [nops[k] for k in need],
            [ops[k] for k in need])))
        for i, (c, idx, o_rc, cf, slen) in best.items():
            def tup(c_, idx_, cf_, slen_):
                return (c_, ops_by_idx[idx_],
                        int(flat_starts[idx_]), cf_, slen_)
            others = [tup(c_, idx_, cf_, slen_)
                      for c_, idx_, _rc, cf_, slen_ in
                      equal_alts.get(i, ())]
            results[i] = (tup(c, idx, cf, slen), others, o_rc)

    def _resolve_entries_staged(self, get_codes, flat_starts, flat_meta,
                                lbs, results):
        """Exact two-stage native verify: each read's FIRST proposal
        entry is scored first; later proposals are scored only when
        their novel-cost lower bound could STRICTLY beat the found cost.
        The non-leftmost pick is first-minimal (lowest entry index among
        minimal costs), so an unverified later entry with lb >= found
        cost can never change the result — most reads pay one DFS
        instead of one per proposal.  Leftmost/STR mode needs every
        equal-cost entry (alt spellings + leftmost tie-break) and stays
        on the single-batch path.  `get_codes(idxs)` materializes entry
        subreads on demand (see _rank_entries_impl) — only the entries
        actually verified are ever sliced."""
        if self.leftmost:
            return self._resolve_entries(get_codes(range(len(flat_meta))),
                                         flat_starts, flat_meta, results)
        first = {}
        for idx, m in enumerate(flat_meta):
            if m[0] not in first:
                first[m[0]] = idx
        if len(first) == len(flat_meta):
            return self._resolve_entries(get_codes(range(len(flat_meta))),
                                         flat_starts, flat_meta, results)
        f_idx = sorted(first.values())
        reads1 = get_codes(f_idx)
        with TRACE.stage("verify.native"):
            cost1, nops1, ops1 = self.native.verify_raw(
                reads1, [flat_starts[k] for k in f_idx])
        limit = {}
        best = {}          # i -> (cost, orig idx, batch, local row)
        for k, idx in enumerate(f_idx):
            i = flat_meta[idx][0]
            c = int(cost1[k])
            limit[i] = c if c >= 0 else self.num_editdist + 1
            if c >= 0:
                best[i] = (c, idx, 1, k)
        rest = [idx for idx, m in enumerate(flat_meta)
                if idx != first[m[0]] and int(lbs[idx]) < limit[m[0]]]
        cost2 = nops2 = ops2 = None
        reads2 = []
        if rest:
            reads2 = get_codes(rest)
            with TRACE.stage("verify.native"):
                cost2, nops2, ops2 = self.native.verify_raw(
                    reads2, [flat_starts[k] for k in rest])
            for k, idx in enumerate(rest):
                c = int(cost2[k])
                if c < 0:
                    continue
                i = flat_meta[idx][0]
                cur = best.get(i)
                if cur is None or (c, idx) < (cur[0], cur[1]):
                    best[i] = (c, idx, 2, k)
        items = list(best.items())
        all_ops = self.native.ops_entries_batch(
            [(reads1[k] if batch == 1 else reads2[k])
             for _i, (_c, _idx, batch, k) in items],
            [(nops1[k] if batch == 1 else nops2[k])
             for _i, (_c, _idx, batch, k) in items],
            [(ops1[k] if batch == 1 else ops2[k])
             for _i, (_c, _idx, batch, k) in items])
        for (i, (c, idx, batch, k)), entry_ops in zip(items, all_ops):
            _i, o_rc, cf, slen = flat_meta[idx]
            results[i] = ((c, entry_ops, int(flat_starts[idx]), cf, slen),
                          [], o_rc)

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

    def _apply_dp(self, st, entries, cost, over):
        """Install each read's first-minimal DP winner via host
        edit-script extraction; reads whose winner overflowed the band
        or whose DFS cost diverges (haplotype-window constraint) redo
        the full proposal set, so results stay bit-identical to the
        host-only path."""
        get_codes, flat_starts, flat_meta = entries[:3]
        results = st["results"]
        over_reads = set()
        winner = {}
        for idx, (i, _o_rc, _cf, _slen) in enumerate(flat_meta):
            if over[idx]:
                over_reads.add(i)
                continue
            c = int(cost[idx])
            if c > self.num_editdist:
                continue
            if i not in winner or c < winner[i][0]:
                winner[i] = (c, idx)
        sel_k, sel_s, sel_m = [], [], []
        dp_expect = {}
        for i, (c, idx) in winner.items():
            if i in over_reads:
                continue
            sel_k.append(idx)
            sel_s.append(flat_starts[idx])
            sel_m.append(flat_meta[idx])
            dp_expect[i] = c
        if sel_k:
            self._resolve_entries(get_codes(sel_k), sel_s, sel_m, results)
        redo = set(over_reads)
        for i, c_dp in dp_expect.items():
            r = results[i]
            if r is None or r[0][0] != c_dp:
                redo.add(i)
        if redo:
            rk = [k for k, m_ in enumerate(flat_meta) if m_[0] in redo]
            self._resolve_entries(get_codes(rk),
                                  [flat_starts[k] for k in rk],
                                  [flat_meta[k] for k in rk], results,
                                  clear=redo)
        st["pending"] = [po for po in st["pending"]
                         if results[po[0]] is None]

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

    def _proposal_entries(self, codes, cand_pos, cand_scores, m,
                          max_clip_frac=0.35):
        """Ordered verification entries [(sub_codes, start, clip_front)].

        Candidates that overhang a backbone end are soft-clipped to the
        overlapping part, as the reference trims hisat2 soft clips
        (typing_core.py:1097-1107).
        """
        entries = []
        min_score = m * self.min_seed_frac
        P = len(self.gene.backbone)
        max_clip = int(m * max_clip_frac)
        tried = set()
        for k in range(len(cand_pos)):
            if cand_scores[k] < min_score:
                break
            for start in self._start_proposals(int(cand_pos[k]), m):
                clip_front = 0
                sub = codes
                s = start
                if s < 0:
                    clip_front = -s
                    if clip_front > max_clip:
                        continue
                    sub = sub[clip_front:]
                    s = 0
                overhang = s + len(sub) - P
                if overhang > 0:
                    if overhang > max_clip:
                        continue
                    sub = sub[:-overhang]
                if len(sub) < m - max_clip \
                        or (s, clip_front, len(sub)) in tried:
                    continue
                tried.add((s, clip_front, len(sub)))
                entries.append((sub, s, clip_front))
        return entries

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

    def _start_proposals(self, p, m, max_depth=3, cap=48):
        """Candidate read-start positions for an anchor diagonal p.

        The diagonal placement votes for the read's longest match segment; every
        known indel preceding that segment within the read shifts the true
        start (deletion: start -= len, insertion: start += len).  We close
        over up to `max_depth` stacked indel shifts.  Ref equivalent:
        HISAT2's internal seed-chain resolution across graph edges.
        """
        cached = self._prop_cache.get((p, m))
        if cached is not None:
            return cached
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
            if not frontier or len(order) >= cap:
                break
        out = order[:cap]
        if len(self._prop_cache) > 100000:
            self._prop_cache.clear()
        self._prop_cache[(p, m)] = out
        return out
