# Port of hgtpu/typer/engine.py: the host engine is a copy; the device
# counter, the device fold and the "auto" rule run on torch.
"""The typing engine: alignments -> compatibility stats -> hierarchical EM.

Re-architecture of the reference's typing() hot loop
(typing_core.py:800-1789) without the SAM/text round trip: consumes
ReadAln batches from align, registers novel variants, trims
ambiguous read ends through the alternative-haplotype tables, counts
allele compatibility through the vectorized link-matrix counter, and runs
the exon-representative -> full-length EM staging for HLA-style families.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..db.catalog import GeneRef
from ..utils.trace import TRACE
from .. import resolve_device
from ..align.types import aln_key
from .alts import (VarTable, alts_sorted_lists, get_alternatives,
                   identify_ambiguous_diffs)
from .counting import GeneCounter, HtOp, StatAccumulator
from .exons import get_exon_haplotypes


# allele-panel width at which device_counting="auto" switches the
# counting+class fold onto the device when the device is the CPU (host
# reduceat is memory-bound at IMGT width); on CUDA "auto" always takes
# the device fold, as hgtpu does on a TPU
DEVICE_FOLD_MIN_A = 1024


@dataclasses.dataclass
class TypingOptions:
    family: str = "hla"
    num_editdist: int = 2
    # linear-path mismatch cap (--num-mismatch, args.py:176-181); 0 means
    # the hisat2-default-equivalent per-read budget (align/linear.py)
    num_mismatch: int = 0
    allow_discordant: bool = False
    simulation: bool = False
    # reference default is to prune (args.py:342-346 is a store_false
    # --keep-low-abundance-alleles flag)
    remove_low_abundance_alleles: bool = True
    type_primary_exons: bool = False
    output_allele_counts: bool = False
    best_alleles: bool = False
    use_alts: bool = True
    error_correction: bool = True
    device_counting: str = "auto"  # "auto" | "on" | "off"
    # route typing through the production device program with host punt
    # rescue (parallel/production.py): "auto" takes it on CUDA, as hgtpu
    # does on a TPU
    device_typing: str = "auto"    # "auto" | "on" | "off"
    assembly: bool = False
    report_base: str = ""     # when set, assembly also renders <base>.<gene>.pdf
    # alleles whose variant tracks are drawn in the assembly plot
    # (--display-alleles, ref hisatgenotype_args.py:347-352)
    display_alleles: tuple = ()
    # exact-match linear-index path instead of the variant graph
    # (--aligner bowtie2 / --linear-index, ref typing_core.py:1597-1648)
    linear_typing: bool = False
    # genes whose mate pairs are disambiguated by fragment inter-distance
    # (ref: applied to CODIS D18S51, typing_core.py:1547-1552)
    choose_pairs_genes: tuple = ("D18S51",)
    # strict reference parity for the pair-distance measurement: raw
    # backbone coordinates only (typing_core.py:686-716), disabling the
    # deletion-aware allele-frame correction documented in NEXT.md
    strict_pair_distance: bool = False


@dataclasses.dataclass
class GeneTypingResult:
    gene: str
    num_reads: int
    num_pairs: int
    counts: list                 # [(allele, count)] desc
    prob: list                   # [[allele, prob]] desc
    cmpt: dict                   # full-level class counts {names-joined: n}
    exon_cmpt: dict
    primary_exon_cmpt: dict
    novel_vars: dict = dataclasses.field(default_factory=dict)
    assembly_call: list = None   # [[allele1, allele2], log10 group score]
    contigs: dict = None         # fasta_key -> contig sequence


def get_rep_alleles(gene: GeneRef, exon_var_mask, in_alleles=None):
    """Group alleles sharing identical exonic variant sets.

    Ref: get_rep_alleles (typing_core.py:86-115).  Only alleles carrying
    at least one exonic variant participate.  Returns
    (rep_mask [A] bool, groups {rep index: [allele indices]}).
    """
    cols = gene.links[exon_var_mask]          # [Ve, A]
    groups = {}
    for a in range(gene.n_alleles):
        if in_alleles is not None and not in_alleles[a]:
            continue
        if not cols[:, a].any():
            continue
        groups.setdefault(cols[:, a].tobytes(), []).append(a)
    rep_mask = np.zeros(gene.n_alleles, dtype=bool)
    rep_groups = {}
    for members in groups.values():
        rep = members[0]  # DB order; deterministic
        rep_mask[rep] = True
        rep_groups[rep] = members
    return rep_mask, rep_groups


class NovelVars:
    """Per-run novel variant registry (ref: add_novel_var,
    typing_core.py:404-431)."""

    def __init__(self):
        self.by_key = {}     # (type, pos, data) -> id
        self.meta = {}       # id -> (type_str, pos, data)

    def get(self, kind, pos, data):
        key = (kind, pos, data)
        vid = self.by_key.get(key)
        if vid is None:
            vid = "nv%d" % len(self.by_key)
            self.by_key[key] = vid
            self.meta[vid] = (kind, pos, data)
        return vid


def _aln_to_ref_cmp(gene: GeneRef, aln):
    """ReadAln.cmp -> reference-style cmp_list with string var ids
    (novel/unresolved differences stay "unknown" until registration)."""
    out = []
    for kind, pos, length, var_idx, data in aln.cmp:
        if kind == "match":
            out.append(["match", pos, length])
            continue
        if var_idx is not None and var_idx >= 0:
            vid = gene.var_ids[var_idx]
        else:
            vid = "unknown"
        out.append([kind, pos, length, vid])
    return out


def _register_novels(cmp_list, read_seq, novel: NovelVars):
    """Assign nv ids to unknown differences (ref: typing_core.py:1126-1164;
    N-base mismatches stay "unknown")."""
    read_pos = 0
    for e in cmp_list:
        kind, pos, length = e[:3]
        if kind != "match" and e[3] == "unknown":
            if kind == "mismatch":
                data = read_seq[read_pos]
                if data != "N":
                    e[3] = novel.get("single", pos, data)
            elif kind == "deletion":
                e[3] = novel.get("deletion", pos, str(length))
            else:
                data = read_seq[read_pos:read_pos + length]
                e[3] = novel.get("insertion", pos, data)
        if kind != "deletion":
            read_pos += length
    return cmp_list


def _merge_unknown(cmp_list):
    """cmp_list2: unknown/novel mismatches become matches
    (ref: typing_core.py:1352-1368)."""
    out = []
    for cmp in cmp_list:
        typ, pos, length = cmp[:3]
        if typ == "match":
            if out and out[-1][0] == "match":
                out[-1][2] += length
            else:
                out.append(list(cmp))
        elif typ == "mismatch" and (cmp[3] == "unknown"
                                    or cmp[3].startswith("nv")):
            if out and out[-1][0] == "match":
                out[-1][2] += 1
            else:
                out.append(["match", pos, 1])
        else:
            out.append(list(cmp))
    return out


def _read_pos_of(cmp_list, target):
    rp = 0
    for e in cmp_list:
        if e is target:
            return rp
        if e[0] != "deletion":
            rp += e[2]
    return rp


def _ht_to_ops(gene: GeneRef, novel: NovelVars, tokens):
    """Middle tokens of a ht string -> [HtOp]."""
    ops = []
    for t in tokens:
        if t.startswith("hv"):
            vi = gene.var_index(t)
            kind = ("mismatch", "deletion", "insertion")[int(gene.var_type[vi])]
            ops.append(HtOp(kind, int(gene.var_pos[vi]),
                            int(gene.var_len[vi]), vi, gene.var_data[vi]))
        elif t in novel.meta:
            ntype, pos, data = novel.meta[t]
            kind = "mismatch" if ntype == "single" else ntype
            length = int(data) if ntype == "deletion" else len(data)
            ops.append(HtOp(kind, pos, length, -1, data))
        # "unknown" tokens constrain nothing
    return ops


def _sparse_table(v, op):
    """Sparse RMQ table: tabs[k][i] = op over v[i : i + 2**k]."""
    tabs = [np.asarray(v)]
    k = 1
    while (1 << k) <= len(v):
        w = 1 << (k - 1)
        prev = tabs[-1]
        tabs.append(op(prev[: len(prev) - w], prev[w:]))
        k += 1
    return tabs


def _range_query(tabs, i0, i1, op, fill):
    """Vectorized RMQ over half-open windows [i0, i1); empty -> fill."""
    i0 = np.atleast_1d(np.asarray(i0, np.int64))
    i1 = np.atleast_1d(np.asarray(i1, np.int64))
    length = i1 - i0
    res = np.full(i0.shape, fill,
                  dtype=tabs[0].dtype if len(tabs[0]) else np.int64)
    nz = length > 0
    if not nz.any():
        return res
    lev = np.zeros(i0.shape, np.int64)
    lev[nz] = np.floor(np.log2(length[nz])).astype(np.int64)
    for l in np.unique(lev[nz]).tolist():
        m = nz & (lev == l)
        w = 1 << l
        t = tabs[l]
        res[m] = op(t[i0[m]], t[i1[m] - w])
    return res


def _gene_shared_state(gene: GeneRef) -> dict:
    """Option-independent precomputed typing state, cached ON the
    GeneRef instance (never keyed by id(): the cache dies with the
    object, and building a new GeneRef — exclude_alleles, replace —
    naturally starts fresh).  At IMGT scale the alts equivalence index
    and the packed device tables cost ~1.5 s to build; typing many read
    sets / simulation tests against one gene shares them.  The key is
    the port's own ("_typer_shared_torch"; hgtpu's GeneRef keeps its jax
    tables under "_typer_shared")."""
    st = gene.__dict__.get("_typer_shared_torch")
    if st is None:
        st = {}
        gene.__dict__["_typer_shared_torch"] = st
    return st


def shared_device_counter(gene: GeneRef, device=None):
    """The gene's DeviceCounter on `device`, built once per device."""
    from .device_count import DeviceCounter

    device = resolve_device(device)
    counters = _gene_shared_state(gene).setdefault("device_counters", {})
    if device not in counters:
        counters[device] = DeviceCounter(gene, device)
    return counters[device]


def ensure_alt_gate(gene: GeneRef):
    """Build (once, on the gene's shared state) the alternative-
    haplotype tables and the reach-based trim gate: anchors + the rep's
    far boundary per entry, as sparse RMQ tables (see may_trim).  Shared
    by GeneTyper and the sharded device program (whose production path
    punts may_trim reads to the host rescue)."""
    st = _gene_shared_state(gene)
    if "alts" not in st:
        st["alts"] = get_alternatives(gene)
        st["alts_lists"] = alts_sorted_lists(*st["alts"])
        ll, rl = st["alts_lists"]
        La = np.fromiter((p for p, _ in ll), np.int64, len(ll))
        Lq = np.fromiter((int(h.split("-")[0]) for _, h in ll),
                         np.int64, len(ll))
        Ra = np.fromiter((p for p, _ in rl), np.int64, len(rl))
        Rq = np.fromiter((int(h.split("-")[-1]) for _, h in rl),
                         np.int64, len(rl))
        st["alt_gate"] = (La, _sparse_table(Lq, np.minimum),
                          Ra, _sparse_table(Rq, np.maximum))
    return st["alt_gate"]


class GeneTyper:
    """Holds the per-gene precomputed state (counter, rep groups, alts)."""

    def __init__(self, gene: GeneRef, opts: TypingOptions = None,
                 device=None):
        self.gene = gene
        self.opts = opts or TypingOptions()
        self.device = resolve_device(device)
        st = _gene_shared_state(gene)
        if "counter" not in st:
            st["counter"] = GeneCounter(gene)
            exon_vars = gene.exonic_var_mask(gene.exons)
            primary_vars = gene.exonic_var_mask(gene.primary_exons)
            rep = get_rep_alleles(gene, exon_vars)
            st["rep"] = rep
            st["primary_rep"] = get_rep_alleles(gene, primary_vars, rep[0])
        self.counter = st["counter"]
        self.allele_rep_mask, self.allele_rep_groups = st["rep"]
        self.primary_rep_mask, self.primary_rep_groups = st["primary_rep"]
        if self.opts.use_alts:
            ensure_alt_gate(gene)
            self.alts_left, self.alts_right = st["alts"]
            self.alts_left_list, self.alts_right_list = st["alts_lists"]
            self._alt_gate = st["alt_gate"]
        else:
            self.alts_left, self.alts_right = {}, {}
            self.alts_left_list, self.alts_right_list = \
                alts_sorted_lists({}, {})
            e = np.zeros(0, np.int64)
            self._alt_gate = (e, [e], e, [e])
        self._device_counter = None
        self._device_fold = None

    def may_trim(self, lo, hi):
        """Conservative vectorized gate: can _trim_end possibly fire for
        a read spanning [lo, hi]?  Every hit condition in the trimming
        scan (alts._trim_end:331-360) compares a rep boundary or a rep
        variant position against the read edge, and the rep's own span
        edge lower-bounds all of them — so trimming on the left needs an
        anchor inside the span whose rep reaches left of (or to) lo, and
        symmetrically on the right.  False is exact (no trim can fire;
        the fast paths may emit the span ht directly); True only routes
        the read to the slow path."""
        lo = np.atleast_1d(np.asarray(lo, np.int64))
        hi = np.atleast_1d(np.asarray(hi, np.int64))
        La, Lt, Ra, Rt = self._alt_gate
        out = np.zeros(lo.shape, dtype=bool)
        if len(La):
            l0 = np.searchsorted(La, lo, "left")
            l1 = np.searchsorted(La, hi, "right")
            q = _range_query(Lt, l0, l1, np.minimum, np.int64(1) << 60)
            out |= q <= lo
        if len(Ra):
            r0 = np.searchsorted(Ra, lo, "left")
            r1 = np.searchsorted(Ra, hi, "right")
            q = _range_query(Rt, r0, r1, np.maximum, np.int64(-1))
            out |= q >= hi
        return out

    # ------------------------------------------------------------------ #
    def clean_hts_batch(self, alns, mpileup, use_ec, memo):
        """Vectorized twin of read_hts' clean fast path: one batched
        pileup-support gather + alt-key scan over every unique nm==0
        alignment whose cmp holds only matches and catalog SNPs.  Fills
        `memo[(pos, seq)] = {ht}` for alignments the fast path resolves;
        the rest fall through to read_hts unchanged."""
        from ..utils.dna import encode_seq

        gene = self.gene
        N = len(alns)
        if N == 0:
            return
        span_l = np.fromiter((a.pos for a in alns), np.int64, N)
        span_r = np.fromiter((a.right - 1 for a in alns), np.int64, N)
        ok = ~self.may_trim(span_l, span_r)
        if use_ec and mpileup is not None:
            P = len(gene.backbone)
            code_list = [a.codes if a.codes is not None
                         else encode_seq(a.seq) for a in alns]
            lens = np.fromiter(
                (min(len(c), P - p) for c, p in zip(code_list, span_l)),
                np.int64, N)
            np.maximum(lens, 0, out=lens)   # span_l past the backbone end
            L = max(int(lens.max()), 0) if N else 0
            codes = np.full((N, L), 4, np.int8)
            for r, c in enumerate(code_list):
                codes[r, : lens[r]] = c[: lens[r]]
            pos = span_l[:, None] + np.arange(L, dtype=np.int64)[None, :]
            np.clip(pos, 0, P - 1, out=pos)
            okmat = mpileup.rep6[pos, codes]
            bad = mpileup.rep_any[pos] & ~okmat \
                & (np.arange(L)[None, :] < lens[:, None])
            ok &= ~bad.any(axis=1)
        var_ids = gene.var_ids
        for r in np.flatnonzero(ok).tolist():
            a = alns[r]
            toks = [str(a.pos)]
            for e in a.cmp:
                if e[0] == "mismatch":
                    toks.append(var_ids[e[3]])
            toks.append(str(int(span_r[r])))
            memo[aln_key(a)] = {"-".join(toks)}

    def indel_clean_hts_batch(self, alns, mpileup, use_ec, memo):
        """Vectorized fast path for nm==0 alignments whose edit script is
        ALL catalog ops including deletions/insertions (the indel twin of
        clean_hts_batch).  A fully catalog, fully pileup-supported read
        with no alt-haplotype key in its span takes none of the slow
        path's branches (error correction is a no-op on supported bases,
        novels/merging are no-ops with no unknowns, the trimming scan
        cannot fire) — so the ht string falls straight out of the cmp
        list, exactly as read_hts would produce.  Reads failing any gate
        fall through to read_hts unchanged."""
        from ..utils.dna import encode_seq

        gene = self.gene
        N = len(alns)
        if N == 0:
            return
        # span arithmetic mirrors read_hts (cmp_list2[0][1] ..
        # last pos + len - 1)
        span_l = np.fromiter((a.cmp[0][1] for a in alns), np.int64, N)
        span_r = np.fromiter(
            (a.cmp[-1][1] + a.cmp[-1][2] - 1 for a in alns), np.int64, N)
        ok = ~self.may_trim(span_l, span_r)
        # misalignment heuristics (read_hts): implausible deletions and
        # N bases inside insertions leave the read to the slow path
        for r in np.flatnonzero(ok).tolist():
            a = alns[r]
            rp = 0
            for kind, pos, length, _vi, _d in a.cmp:
                if kind == "insertion":
                    if "N" in a.seq[rp:rp + length]:
                        ok[r] = False
                        break
                elif kind == "deletion":
                    if (self.opts.family == "hla" and mpileup is not None
                            and not mpileup.deletion_plausible(pos)):
                        ok[r] = False
                        break
                    continue
                rp += length
        if use_ec and mpileup is not None and ok.any():
            # pileup support of every aligned base, through the indel
            # frame shifts: one flat gather over per-op match segments.
            # Per-segment (row, start, read-pos, length) scalars are
            # collected in the walk; the position/code expansion happens
            # once via repeat + offset arange (no per-segment array
            # allocs — measured 65k np.full/arange calls at depth)
            seg_r, seg_bb, seg_rp, seg_ln = [], [], [], []
            cds = []
            for r in np.flatnonzero(ok).tolist():
                a = alns[r]
                codes = a.codes if a.codes is not None else encode_seq(a.seq)
                cds.append(codes)
                rp = 0
                for kind, pos, length, _vi, _d in a.cmp:
                    if kind == "deletion":
                        continue
                    if kind == "insertion":
                        rp += length
                        continue
                    seg_r.append(r)
                    seg_bb.append(pos)
                    seg_rp.append(rp)
                    seg_ln.append(length)
                    rp += length
            if seg_r:
                S = len(seg_r)
                ln = np.asarray(seg_ln, np.int64)
                tot = int(ln.sum())
                base = np.arange(tot, dtype=np.int64) \
                    - np.repeat(np.cumsum(ln) - ln, ln)
                bb = np.repeat(np.asarray(seg_bb, np.int64), ln) + base
                rw = np.repeat(np.asarray(seg_r, np.int64), ln)
                # per-read code gather: index into each read's codes at
                # (seg read-pos + offset) via one concatenated buffer
                lens_c = np.fromiter((len(c) for c in cds), np.int64,
                                     len(cds))
                starts_c = np.cumsum(lens_c) - lens_c
                row_of = {r: k for k, r in
                          enumerate(np.flatnonzero(ok).tolist())}
                seg_row = np.fromiter((row_of[r] for r in seg_r),
                                      np.int64, S)
                cd = np.concatenate(cds)[
                    np.repeat(starts_c[seg_row]
                              + np.asarray(seg_rp, np.int64), ln) + base]
                sup = mpileup.rep6[bb, cd]
                bad = mpileup.rep_any[bb] & ~sup
                ok[np.unique(rw[bad])] = False
        var_ids = gene.var_ids
        for r in np.flatnonzero(ok).tolist():
            a = alns[r]
            toks = [str(int(span_l[r]))]
            for e in a.cmp:
                if e[0] != "match":
                    toks.append(var_ids[e[3]])
            toks.append(str(int(span_r[r])))
            memo[aln_key(a)] = {"-".join(toks)}

    def read_hts(self, aln, novel: NovelVars, mpileup=None):
        """One mate alignment -> set of ht strings (with alt spellings),
        or None when the read is rejected (error-correction budget or
        misalignment heuristics, ref: typing_core.py:1117-1124)."""
        gene = self.gene
        opts = self.opts

        # fast path: clean alignment (only matches + catalog SNPs), every
        # base pileup-supported, and no alternative-haplotype key inside
        # the span -> the ht string falls straight out of the cmp list
        if aln.nm == 0:
            clean = True
            for e in aln.cmp:
                if e[0] == "match":
                    continue
                if e[0] == "mismatch" and e[3] is not None and e[3] >= 0:
                    continue
                clean = False
                break
            if clean:
                span_l = aln.pos
                span_r = aln.right - 1
                no_alts = not bool(self.may_trim(span_l, span_r)[0])
                supported = True
                if opts.error_correction and mpileup is not None:
                    codes = aln.codes
                    n = min(len(codes), len(gene.backbone) - span_l)
                    ok = mpileup.rep6[
                        mpileup._ramp[span_l:span_l + n], codes[:n]]
                    supported = not (
                        mpileup.rep_any[span_l:span_l + n] & ~ok).any()
                if no_alts and supported:
                    toks = [str(span_l)]
                    toks += [gene.var_ids[e[3]] for e in aln.cmp
                             if e[0] == "mismatch"]
                    toks.append(str(span_r))
                    return {"-".join(toks)}

        cmp_list = _aln_to_ref_cmp(gene, aln)
        read_seq = aln.seq
        if opts.error_correction and mpileup is not None:
            from .mpileup import error_correct
            cmp_list, read_seq, n_corr = error_correct(
                gene, mpileup, cmp_list, read_seq, aln.codes)
            if n_corr > max(1, opts.num_editdist):
                return None
        # misalignment heuristics
        for e in cmp_list:
            if e[0] == "insertion":
                rp = _read_pos_of(cmp_list, e)
                if "N" in read_seq[rp:rp + e[2]]:
                    return None
            elif e[0] == "deletion" and opts.family == "hla" \
                    and mpileup is not None:
                if not mpileup.deletion_plausible(e[1]):
                    return None
        cmp_list = _register_novels(cmp_list, read_seq, novel)
        cmp_list2 = _merge_unknown(cmp_list)
        vars_tbl = VarTable(gene, novel.meta)
        span_l = cmp_list2[0][1]
        span_r = cmp_list2[-1][1] + cmp_list2[-1][2] - 1
        # fast path: no in-span anchor whose equivalence reaches a read
        # edge means the trimming scan cannot fire (exact, see may_trim)
        if not self.may_trim(span_l, span_r)[0]:
            cl, cr = 0, len(cmp_list2) - 1
            left_alts, right_alts = [str(span_l)], [str(span_r)]
        else:
            cl, cr, left_alts, right_alts = identify_ambiguous_diffs(
                gene.backbone, vars_tbl, self.alts_left, self.alts_right,
                self.alts_left_list, self.alts_right_list, cmp_list2)
        mid = []
        for cmp in cmp_list2[cl:cr + 1]:
            if cmp[0] in ("mismatch", "deletion", "insertion"):
                mid.append(cmp[3])
        hts = set()
        for l in left_alts:
            for r in right_alts:
                hts.add("-".join(l.split("-") + mid + r.split("-")))
        return hts

    def count_ht(self, ht_str, novel: NovelVars):
        """ht string -> (left, right, [HtOp])"""
        toks = ht_str.split("-")
        left, right = int(toks[0]), int(toks[-1])
        ops = _ht_to_ops(self.gene, novel, toks[1:-1])
        return (left, right, ops)

    def ht_masks(self, ht_str, novel: NovelVars, cache):
        """Per-ht compatibility masks at all three levels, memoized —
        tiled reads share haplotypes, so each distinct ht is computed
        once (cache: {ht_str: (full, exon, primary) int32 vectors})."""
        hit = cache.get(ht_str)
        if hit is not None:
            return hit
        ht = self.count_ht(ht_str, novel)
        A = self.gene.n_alleles
        full = self.counter.alleles_for_ht(*ht).astype(np.int32)
        exon = np.zeros(A, np.int32)
        for e in get_exon_haplotypes(ht, self.gene.exons):
            exon += self.counter.alleles_for_ht(*e)
        primary = np.zeros(A, np.int32)
        for e in get_exon_haplotypes(ht, self.gene.primary_exons):
            primary += self.counter.alleles_for_ht(*e)
        out = (full, exon, primary)
        cache[ht_str] = out
        return out

    def ht_masks_batch_host(self, ht_strs, novel: NovelVars, cache):
        """Fill `cache` for every ht with one vectorized host batch
        (numpy twin of ht_masks_batch; row-identical to ht_masks)."""
        todo = [h for h in ht_strs if h not in cache]
        if not todo:
            return
        sub_hts = []
        groups = []
        for ht_str in todo:
            left, right, ops = self.count_ht(ht_str, novel)
            exon_p = get_exon_haplotypes((left, right, ops), self.gene.exons)
            prim_p = get_exon_haplotypes((left, right, ops),
                                         self.gene.primary_exons)
            groups.append((len(exon_p), len(prim_p)))
            for l, r, o in [(left, right, ops)] + exon_p + prim_p:
                sub_hts.append((l, r, [op.var_idx for op in o]))
        masks = self.counter.alleles_for_hts_batch(sub_hts)
        A = self.gene.n_alleles
        at = 0
        for ht_str, (n_exon, n_prim) in zip(todo, groups):
            full = masks[at]
            at += 1
            exon = masks[at:at + n_exon].sum(axis=0) if n_exon \
                else np.zeros(A, np.int32)
            at += n_exon
            primary = masks[at:at + n_prim].sum(axis=0) if n_prim \
                else np.zeros(A, np.int32)
            at += n_prim
            cache[ht_str] = (full, exon, primary)

    def device_fold_run(self, hts_sorted, novel, grouped):
        """Device counting+fold (device_fold.DeviceFold); None when
        a haplotype exceeds the device variant budget."""
        from .device_fold import DeviceFold

        if self._device_fold is None:
            self._device_fold = DeviceFold(self)
        return self._device_fold.run(hts_sorted, novel, grouped)

    def ht_masks_batch(self, ht_strs, novel: NovelVars, cache):
        """Fill `cache` for every ht in `ht_strs` with one device batch.

        Each unique ht expands into its full-span plus exon/primary
        projections; all sub-haplotypes go through the device counter in
        a single batch (typer.device_count), then the per-level
        masks are reassembled per ht.
        """
        from .device_count import MAX_HT_VARS

        if self._device_counter is None:
            self._device_counter = shared_device_counter(self.gene,
                                                         self.device)
        dc = self._device_counter
        todo = [h for h in ht_strs if h not in cache]
        if not todo:
            return
        sub_hts = []      # packed (left, right, var idx list)
        groups = []       # per ht: (n_full=1, n_exon, n_primary)
        usable = []
        for ht_str in todo:
            left, right, ops = self.count_ht(ht_str, novel)
            if len([o for o in ops if o.var_idx >= 0]) > MAX_HT_VARS:
                usable.append(False)
                continue
            usable.append(True)
            exon_p = get_exon_haplotypes((left, right, ops), self.gene.exons)
            prim_p = get_exon_haplotypes((left, right, ops),
                                         self.gene.primary_exons)
            groups.append((len(exon_p), len(prim_p)))
            for l, r, o in [(left, right, ops)] + exon_p + prim_p:
                sub_hts.append((l, r, [op.var_idx for op in o]))
        if sub_hts:
            lefts, rights, vars_ = dc.pack_hts(sub_hts)
            masks = dc.compat_masks(lefts, rights, vars_).astype(np.int32)
        at = 0
        gi = 0
        A = self.gene.n_alleles
        for ht_str, ok in zip(todo, usable):
            if not ok:
                self.ht_masks(ht_str, novel, cache)  # host fallback
                continue
            n_exon, n_prim = groups[gi]
            gi += 1
            full = masks[at]
            at += 1
            exon = masks[at:at + n_exon].sum(axis=0) if n_exon \
                else np.zeros(A, np.int32)
            at += n_exon
            primary = masks[at:at + n_prim].sum(axis=0) if n_prim \
                else np.zeros(A, np.int32)
            at += n_prim
            cache[ht_str] = (full, exon, primary)


def choose_pairs(left_hts, right_hts, expected_interdist, gene=None):
    """Keep the (left, right) haplotype pairs whose inner distance is
    closest to the expected fragment inter-distance.
    Ref: choose_pairs (typing_core.py:680-716).

    Improvement over the reference: the reference measures the mate gap
    in raw backbone coordinates, so a catalog deletion lying *between*
    the mates inflates the distance of the true frame and can make a
    wrong equal-cost STR spelling win (e.g. a microvariant allele's
    junction reads).  When `gene` is given, each candidate pair may also
    be scored with any catalog deletion that fits entirely inside the
    mate gap subtracted — the allele-frame fragment geometry.  Diffs
    only shrink, so in the worst case this widens a tie (keeping the
    true spelling in the union) rather than dropping it.
    """
    if not (left_hts and right_hts
            and max(len(left_hts), len(right_hts)) >= 2):
        return left_hts, right_hts
    gap_dels = None
    if gene is not None:
        from ..db.catalog import VT_DELETION
        di = np.flatnonzero(gene.var_type == VT_DELETION)
        gap_dels = (gene.var_pos[di], gene.var_pos[di]
                    + gene.var_len[di] - 1, gene.var_len[di])
    best_diff = None
    picked = []
    for lht in left_hts:
        lt = lht.split("-")
        l_left, l_right = int(lt[0]), int(lt[-1])
        for rht in right_hts:
            rt = rht.split("-")
            r_left, r_right = int(rt[0]), int(rt[-1])
            if l_right < r_right:
                inter = r_left - l_right - 1
                gapl, gapr = l_right, r_left
            else:
                inter = l_left - r_right - 1
                gapl, gapr = r_right, l_left
            diff = abs(expected_interdist - inter)
            if gap_dels is not None and diff:
                dpos, dright, dlen = gap_dels
                inside = (dpos > gapl) & (dright < gapr)
                for dl in np.unique(dlen[inside]):
                    diff = min(diff,
                               abs(expected_interdist - (inter - int(dl))))
            if best_diff is None or diff < best_diff:
                best_diff = diff
                picked = [(lht, rht)]
            elif diff == best_diff:
                picked.append((lht, rht))
    return {l for l, _ in picked}, {r for _, r in picked}


def _concordant(alns, opts: TypingOptions):
    """Pair concordance filter: both mates mapped, opposite orientation,
    within the fragment bound (ref: hisat2 -X 1000 + flag 0x2 check at
    typing_core.py:826-852).  Returns the usable alignments or None."""
    out = []
    lm = rm = None
    for a in alns:
        if a is None:
            continue
        out.append(a)
        if a.mate == "L":
            if lm is None:
                lm = a
        elif rm is None:
            rm = a
    if not out:
        return None
    if opts.allow_discordant:
        return out
    if lm is None or rm is None:
        return None
    if lm.is_rc == rm.is_rc:
        return None
    if max(lm.right, rm.right) - min(lm.pos, rm.pos) > 1000:
        return None
    return out


def type_gene(gene: GeneRef, read_alns, opts: TypingOptions = None,
              typer: GeneTyper = None, device=None):
    """read_alns: iterable of (read_id, [ReadAln for its mates]).

    Returns GeneTypingResult.
    """
    opts = opts or TypingOptions()
    typer = typer or GeneTyper(gene, opts, device)
    A = gene.n_alleles
    novel = NovelVars()

    full_stats = StatAccumulator(gene.allele_names)
    exon_stats = StatAccumulator(gene.allele_names, typer.allele_rep_mask)
    primary_stats = StatAccumulator(gene.allele_names, typer.primary_rep_mask)

    num_reads = 0
    num_pairs = 0
    asm_reads = []
    ht_cache = {}

    read_alns = list(read_alns)
    with TRACE.stage("type.prep"):
        # concordance is a pure function of the pair; resolve it once for both
        # the pileup pass and the counting pass
        conc_alns = [(read_id, _concordant(alns, opts))
                     for read_id, alns in read_alns]

        # Pair-signature dedup, shared by the pileup and counting passes: a
        # pair's pileup contribution and its positive ht set are pure
        # functions of its alignments' (mate, pos, seq, nm) tuples, so
        # duplicate pairs (tiled simulation, deep resequencing) fold into
        # one weighted evaluation.  Assembly keeps per-read identity.
        sig_groups = {}
        if not opts.assembly:
            for read_id, alns in conc_alns:
                if alns is None:
                    continue
                sig = tuple((a.mate, a.uid) if a.uid >= 0
                            else (a.mate, a.pos, a.seq, a.nm) for a in alns)
                hit = sig_groups.get(sig)
                if hit is None:
                    sig_groups[sig] = [read_id, alns, 1]
                else:
                    hit[2] += 1

    # pass 1: pileup over all concordant alignments (no NM filter, as in
    # get_mpileup — typing_common.py:1059-1184)
    mpileup = None
    if opts.error_correction or opts.family == "hla":
        from .mpileup import Mpileup
        with TRACE.stage("type.pileup"):
            mpileup = Mpileup(gene)
            bulk = []
            bulk_w = []
            if not opts.assembly:
                for _rid, alns, w in sig_groups.values():
                    bulk.extend(alns)
                    bulk_w.extend([w] * len(alns))
            else:
                for _read_id, alns in conc_alns:
                    if alns is None:
                        continue
                    bulk.extend(alns)
                bulk_w = None
            mpileup.add_alignments_bulk(bulk, weights=bulk_w)
            mpileup.finalize()

    # expected mate inter-distance for CODIS pair disambiguation
    # (ref: get_pair_interdist called for codis, typing_core.py:451-456)
    interdist = None
    if opts.family == "codis" and gene.gene in opts.choose_pairs_genes:
        from .mpileup import pair_interdist
        interdist = pair_interdist(read_alns)

    # read_hts is deterministic in (start, oriented sequence): the edit
    # script, error correction, and alt trimming are all functions of
    # those two plus per-gene state fixed after the pileup pass — so
    # tiled duplicates share one computation
    hts_memo = {}

    # batched clean fast paths: one vectorized support/alt-key test over
    # every unique nm==0 all-catalog alignment prefills the memo —
    # diagonal reads (matches + catalog SNPs) and indel-crossing reads
    # (+ catalog deletions/insertions) each through their batch
    uniq_clean = {}
    uniq_indel = {}
    for _rid, alns in conc_alns:
        if alns is None:
            continue
        for a in alns:
            if a.nm != 0:
                continue
            k = aln_key(a)
            if k in uniq_clean or k in uniq_indel:
                continue
            catalog = a.catalog
            has_indel = a.has_indel
            if catalog is None:        # SAM-parsed: classify here
                catalog = True
                has_indel = False
                for e in a.cmp:
                    if e[0] == "match":
                        continue
                    if e[3] is None or e[3] < 0:
                        catalog = False
                        break
                    if e[0] != "mismatch":
                        has_indel = True
            if not catalog:
                continue
            (uniq_indel if has_indel else uniq_clean)[k] = a
    with TRACE.stage("type.clean_fast_path"):
        typer.clean_hts_batch(list(uniq_clean.values()), mpileup,
                              opts.error_correction, hts_memo)
        typer.indel_clean_hts_batch(list(uniq_indel.values()), mpileup,
                                    opts.error_correction, hts_memo)

    def memo_hts(a):
        k = aln_key(a)
        hit = hts_memo.get(k, False)
        if hit is not False:
            return hit
        r = typer.read_hts(a, novel, mpileup)
        hts_memo[k] = r
        return r

    with TRACE.stage("type.read_hts"):
        if not opts.assembly:
            work = sig_groups.values()
        else:
            work = ([rid, alns, 1] for rid, alns in conc_alns
                    if alns is not None)
        grouped = {}
        for read_id, alns, w in work:
            left_hts = set()
            right_hts = set()
            per_mate_hts = []
            n_counted = 0
            for a in alns:
                if a.nm > opts.num_editdist:
                    continue
                n_counted += 1
                hts = memo_hts(a)
                if hts is not None:
                    (left_hts if a.mate == "L" else right_hts).update(hts)
                    if opts.assembly:
                        per_mate_hts.append((a, hts))
                # equal-cost alternative spellings (STR periodicity) also
                # contribute positive haplotypes
                for alt in (a.alts or ()):
                    alt_hts = memo_hts(alt)
                    if alt_hts is not None:
                        (left_hts if a.mate == "L"
                         else right_hts).update(alt_hts)
            num_reads += w * n_counted
            if interdist is not None and interdist >= 0:
                left_hts, right_hts = choose_pairs(
                    left_hts, right_hts, interdist,
                    None if opts.strict_pair_distance else gene)
            positive_hts = left_hts | right_hts
            if not positive_hts:
                continue
            num_pairs += w
            if opts.assembly:
                asm_reads.append((read_id, per_mate_hts))
            key = frozenset(positive_hts)
            hit = grouped.get(key)
            if hit is None:
                grouped[key] = [w, positive_hts]
            else:
                hit[0] += w

    # batch the per-ht compatibility masks through the device counter
    unique_hts = set()
    for _w, hts in grouped.values():
        unique_hts |= hts
    # Device-vs-host counting: "auto" takes the device fold
    # (device_fold.DeviceFold) on CUDA, and on the CPU at IMGT width
    # (A >= DEVICE_FOLD_MIN_A), where the host fold is memory-bound
    # ([F, A] int32 gathers/reduceats).
    hts_sorted = sorted(unique_hts)
    # grouped ht-set classes were folded with weights inside the loop
    # above (first-seen class creation order preserved: equal ht sets
    # always map to equal class keys at every level)

    use_device = opts.device_counting == "on" or (
        opts.device_counting == "auto"
        and (gene.n_alleles >= DEVICE_FOLD_MIN_A
             or typer.device.type == "cuda"))
    folded = None
    if use_device and grouped:
        with TRACE.stage("type.count_fold.device"):
            folded = typer.device_fold_run(hts_sorted, novel, grouped)

    with TRACE.stage("type.stats"):
        if folded is not None:
            stats_levels = [full_stats, exon_stats, primary_stats] \
                if opts.family == "hla" else [full_stats]
            with TRACE.stage("type.stats.classes"):
                # the device fold already deduplicated classes and aggregated
                # weights (first-seen order preserved via min original row id)
                for (rows, uweights, totals), st in zip(folded, stats_levels):
                    st.add_packed_batch(rows, uweights, totals)
        elif grouped:
            with TRACE.stage("type.count_masks.host"):
                typer.ht_masks_batch_host(hts_sorted, novel, ht_cache)
            ht_idx = {h: i for i, h in enumerate(hts_sorted)}
            U = len(hts_sorted)
            with TRACE.stage("type.stats.mask_fill"):
                mask_f = np.empty((U, A), dtype=np.int32)
                mask_e = np.empty((U, A), dtype=np.int32)
                mask_p = np.empty((U, A), dtype=np.int32)
                for i, h in enumerate(hts_sorted):
                    full, exon, primary = ht_cache[h]
                    mask_f[i] = full
                    mask_e[i] = exon
                    mask_p[i] = primary
                weights = np.fromiter((g[0] for g in grouped.values()),
                                      np.int64, len(grouped))
                flat = []
                starts = np.empty(len(grouped), dtype=np.int64)
                at = 0
                for gi, (_w, positive_hts) in enumerate(grouped.values()):
                    starts[gi] = at
                    for h in positive_hts:
                        flat.append(ht_idx[h])
                    at += len(positive_hts)
                flat = np.asarray(flat, dtype=np.int64)
            if opts.family == "hla":
                with TRACE.stage("type.stats.fold"):
                    fold_p = np.add.reduceat(mask_p[flat], starts, axis=0)
                    fold_e = np.add.reduceat(mask_e[flat], starts, axis=0)
                with TRACE.stage("type.stats.classes"):
                    primary_stats.add_reads_batch(fold_p, weights)
                    exon_stats.add_reads_batch(fold_e, weights)
            with TRACE.stage("type.stats.fold"):
                fold_f = np.add.reduceat(mask_f[flat], starts, axis=0)
            with TRACE.stage("type.stats.classes"):
                full_stats.add_reads_batch(fold_f, weights)

    # ------------------------------------------------------------------ #
    # Hierarchical abundance (ref: typing_core.py:1679-1789)
    # ------------------------------------------------------------------ #
    with TRACE.stage("type.em"):
        from .staging import class_levels, staged_abundance

        levels, (full_cmpt, exon_cmpt, primary_cmpt) = class_levels(
            full_stats, exon_stats, primary_stats)
        prob = staged_abundance(gene, opts, *levels,
                                typer.allele_rep_groups,
                                typer.primary_rep_groups,
                                gene.allele_lengths())

    assembly_call = None
    contigs = None
    if opts.assembly and asm_reads:
        with TRACE.stage("type.assembly"):
            assembly_call, contigs = _run_assembly(gene, typer, novel,
                                                   asm_reads, prob)

    return GeneTypingResult(
        gene=gene.gene,
        num_reads=num_reads,
        num_pairs=num_pairs,
        counts=full_stats.ranked_counts(),
        prob=prob,
        cmpt=full_cmpt,
        exon_cmpt=exon_cmpt,
        primary_exon_cmpt=primary_cmpt,
        novel_vars=dict(novel.meta),
        assembly_call=assembly_call,
        contigs=contigs,
    )


def _run_assembly(gene: GeneRef, typer: GeneTyper, novel: NovelVars,
                  asm_reads, prob):
    """Guided de Bruijn assembly + Viterbi phasing over the collected read
    haplotypes (ref: typing_core.py:1791-1838, 2014-2070)."""
    from ..assemble.graph import AssemblyGraph
    from ..assemble.nodes import allele_node, read_nodes_from_hts

    var_table = VarTable(gene, novel.meta)
    predicted = {}
    for allele_name, p in prob:
        if p < 0.1:
            break
        predicted[allele_name] = allele_node(gene, allele_name, var_table)
        if len(predicted) >= 2:
            break
    graph = AssemblyGraph(gene.backbone, var_table, gene.exons,
                          gene.primary_exons,
                          predicted_allele_nodes=predicted)
    for read_id, per_mate in asm_reads:
        for aln, hts in per_mate:
            base_id = aln.read_id.split("|")[0]
            node_read_id = "%s|%s" % (base_id, aln.mate)
            for nid, cmp_i, node in read_nodes_from_hts(
                    gene, var_table, node_read_id, hts, aln.seq):
                graph.add_node(nid, cmp_i, node)
    if not graph.nodes:
        return None, None
    panels = []
    if typer.opts.report_base:
        from ..assemble.pdf import panel_from_nodes
        panels.append(("a. Read alignment",
                       panel_from_nodes(graph, gene, graph.nodes)))
    try:
        call = graph.guided_debruijn()
    except Exception:
        return None, None
    if typer.opts.report_base:
        from ..assemble.pdf import draw_assembly, panel_from_nodes
        panels.append(("b. Assembly",
                       panel_from_nodes(graph, gene, graph.nodes)))
        if graph.nodes2:
            panels.append(("c. Assembly with known alleles",
                           panel_from_nodes(graph, gene, graph.nodes2)))
        shown = [a for a in typer.opts.display_alleles
                 if a in gene.allele_names]
        if shown:
            # --display-alleles: one track per allele with its catalog
            # variant positions ticked (the reference draws these allele
            # rows in its HTML view, assembly_graph.py display_alleles)
            panels.append(("d. Display alleles", [
                (name, 0, len(gene.backbone) - 1,
                 [int(gene.var_pos[i])
                  for i in gene.allele_var_indices(name)])
                for name in shown]))
        try:
            graph.calculate_coverage()
            draw_assembly("%s.%s.pdf" % (typer.opts.report_base, gene.gene),
                          len(gene.backbone), panels,
                          coverage=graph.coverage, exons=gene.exons)
        except Exception:
            pass

    # contig calls: closest catalog allele, Known if variant-identical
    # (ref: typing_core.py:2014-2070)
    contigs = {}
    allele_var_sets = {
        name: {gene.var_ids[i] for i in gene.allele_var_indices(name)}
        for name in gene.allele_names
    }
    cnt = 0
    for node_name, node in graph.nodes.items():
        nvars = set(node.get_var_ids())
        max_common = None
        best = []
        for name, avars in allele_var_sets.items():
            tmp = len(nvars & avars) - len(nvars | avars)
            if max_common is None or tmp > max_common:
                max_common = tmp
                best = [name]
            elif tmp == max_common:
                best.append(name)
        is_known = any(nvars == allele_var_sets[b] & nvars
                       and len(allele_var_sets[b] - nvars) == 0
                       for b in best)
        key = "%s contig %d %s" % (node_name, cnt,
                                   best[0] if is_known else "Novel")
        contigs[key] = node.get_seq()
        cnt += 1
    return call, contigs
