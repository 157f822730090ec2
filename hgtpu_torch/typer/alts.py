# Copy of hgtpu/typer/alts.py; only the imports differ.
"""Alternative-haplotype ambiguity machinery.

The equivalence engine that decides bit-identical counting (behavioral
spec: typing_common.py:1424-1657 `get_alternatives` and :1663-1955
`identify_ambigious_diffs` in the reference).  Where the reference spells
the left and right directions as two mirrored code blocks, this
implementation runs ONE direction-parameterized path for both:

- `get_alternatives`: for every deletion variant, breadth-explore pairs of
  haplotype spellings that denote the same sequence (deletions sliding
  through repeats), extending outward base-by-base in the chosen
  direction; maximal distinct-boundary pairs are recorded as equivalent.
- `identify_ambiguous_diffs`: per read, find the outermost anchor whose
  end spelling participates in an equivalence, trim the cmp list there,
  and emit every equivalent end spelling so the read contributes evidence
  to all alleles that could have produced it.

Haplotype strings follow the reference format
"<left>-<var id>-...-<right>" with catalog ids ("hv<N>") and novel ids
("nv<N>"); the counting layer parses them back.
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION

_TYPE_NAME = {VT_SINGLE: "single", VT_DELETION: "deletion",
              VT_INSERTION: "insertion"}


class VarTable:
    """var id -> ("single"|"deletion"|"insertion", pos, data) resolving
    catalog hv ids and per-run novel nv ids."""

    def __init__(self, gene: GeneRef, novel=None):
        self.gene = gene
        self.novel = novel or {}

    def __getitem__(self, var_id):
        if var_id.startswith("hv"):
            vi = self.gene.var_index(var_id)
            g = self.gene
            return (_TYPE_NAME[int(g.var_type[vi])], int(g.var_pos[vi]),
                    g.var_data[vi])
        return self.novel[var_id]

    def __contains__(self, var_id):
        return (var_id.startswith("hv") and
                var_id in self.gene._id2idx) or var_id in self.novel


def _lower_bound(lst, pos):
    """First index whose [0] >= pos (ref: lower_bound,
    typing_common.py:406-422)."""
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if lst[mid][0] < pos:
            lo = mid + 1
        else:
            hi = mid
    return lo


# A spelling is (lo, ids tuple, hi): the backbone interval [lo, hi] plus
# the ordered variant ids it carries.  lo > hi denotes the empty interval
# anchored at a boundary (the "deletion absent" alternative).


def _fmt(spelling):
    lo, ids, hi = spelling
    if not ids:
        return "%d-%d" % (lo, hi)
    return "%d-%s-%d" % (lo, "-".join(ids), hi)


class _AltExplorer:
    """Direction-parameterized spelling search for one gene."""

    def __init__(self, gene: GeneRef):
        self.gene = gene
        self.seq = gene.backbone
        self.vars = VarTable(gene)
        # scan list keyed by variant start (rightward extension)
        self.by_start = [(int(gene.var_pos[i]), gene.var_ids[i])
                         for i in range(gene.n_vars)]
        # scan list keyed by rightmost occupied/adjacent coordinate
        # (leftward extension): deletions key on their last deleted base,
        # insertions on start+1 — matching the reference's reversed list.
        keyed = []
        for pos, vid in self.by_start:
            vt, vp, vd = self.vars[vid]
            if vt == "deletion":
                vp += int(vd) - 1
            elif vt == "insertion":
                vp += 1
            keyed.append((vp, vid))
        keyed.sort(key=lambda x: x[0])
        self.by_end = keyed
        # adjacent variant-id pairs attested by at least one allele
        attested = set()
        for a in range(gene.n_alleles):
            carried = np.flatnonzero(gene.links[:, a])
            for k in range(len(carried) - 1):
                attested.add((gene.var_ids[carried[k]],
                              gene.var_ids[carried[k + 1]]))
        self.attested = attested
        self.equiv = ({}, {})  # (leftward store, rightward store)

    # ------------------------------------------------------------------ #
    def _boundary_vars(self, pos, leftward):
        """Variants whose extension edge lands exactly on `pos`, yielded
        in the reference's scan order (including its early-break rule that
        uses the *raw* position for singles/insertions)."""
        if leftward:
            lst = self.by_end
            idx = reversed(range(_lower_bound(lst, pos + 1)))
        else:
            lst = self.by_start
            idx = range(_lower_bound(lst, pos), len(lst))
        for k in idx:
            vid = lst[k][1]
            vt, vp, vd = self.vars[vid]
            edge = vp
            if leftward and vt == "deletion":
                if vp == 0:
                    continue
                edge = vp + int(vd) - 1
            if (edge > pos) if leftward else (edge < pos):
                continue
            if (edge < pos) if leftward else (edge > pos):
                break
            yield vid, vt, vp, vd

    def _grow(self, spelling, leftward, banned=()):
        """All one-base outward extensions of a spelling; returns
        [(new spelling, base denoted)].  A deletion at the boundary
        denotes no base, so it recurses one step further out."""
        lo, ids, hi = spelling
        pos = lo - 1 if leftward else hi + 1
        if pos < 0 or pos >= len(self.seq):
            return []
        grown = [((pos, ids, hi) if leftward else (lo, ids, pos),
                  self.seq[pos])]
        inner = ids[0] if leftward and ids else \
            (ids[-1] if not leftward and ids else None)
        for vid, vt, vp, vd in self._boundary_vars(pos, leftward):
            if vid in banned:
                continue
            if inner is not None:
                pair = (vid, inner) if leftward else (inner, vid)
                if pair not in self.attested:
                    continue
            if vt == "single":
                nxt = (vp, (vid,) + ids, hi) if leftward \
                    else (lo, ids + (vid,), vp)
                grown.append((nxt, vd))
            elif vt == "deletion":
                dl = int(vd)
                nxt = (vp, (vid,) + ids, hi) if leftward \
                    else (lo, ids + (vid,), vp + dl - 1)
                grown += self._grow(nxt, leftward, banned)
        return grown

    def _explore(self, del_id, a, b, leftward, depth=0):
        """Extend the spelling pair outward while they still denote the
        same bases with distinct boundaries; record maximal pairs."""
        grows_a = self._grow(a, leftward)
        grows_b = self._grow(b, leftward, (del_id,))
        extended = False
        for na, base_a in grows_a:
            for nb, base_b in grows_b:
                if base_a != base_b:
                    continue
                if leftward and na[0] == nb[0]:
                    continue
                if not leftward and na[2] == nb[2]:
                    continue
                extended = True
                self._explore(del_id, na, nb, leftward, depth + 1)
        if depth > 0 and not extended:
            store = self.equiv[0] if leftward else self.equiv[1]
            sa, sb = _fmt(a), _fmt(b)
            store.setdefault(sa, set()).add(sb)
            store.setdefault(sb, set()).add(sa)

    def run(self):
        for _, vid in self.by_start:
            vt, vp, vd = self.vars[vid]
            if vp == 0 or vt != "deletion":
                continue
            dl = int(vd)
            if vp + dl >= len(self.seq):
                continue
            span = (vp, (vid,), vp + dl - 1)
            self._explore(vid, span, (vp + dl, (), vp + dl - 1), True)
            self._explore(vid, span, (vp, (), vp - 1), False)
        return self.equiv


def get_alternatives(gene: GeneRef, verbose=False):
    """Compute (Alts_left, Alts_right) equivalence dictionaries."""
    return _AltExplorer(gene).run()


def alts_sorted_lists(alts_left, alts_right):
    """(pos, ht-string) lists sorted for the trimming scan
    (ref: haplotype_alts_list, typing_core.py:584-596)."""
    left_list = sorted(
        ((int(h.split("-")[-1]), h) for h in alts_left), key=lambda x: x[0])
    right_list = sorted(
        ((int(h.split("-")[0]), h) for h in alts_right), key=lambda x: x[0])
    return left_list, right_list


def _segment_span(entry):
    """Inclusive backbone span of one cmp-list entry."""
    typ, pos, length = entry[:3]
    return pos, pos + length - 1 if typ in ("match", "deletion") else pos


def _ht_and_seq(ref_seq, segments):
    """Variant-id list + denoted sequence of a cmp-list slice."""
    ids = []
    seq = []
    for seg in segments:
        typ, pos, length = seg[:3]
        vid = seg[3] if len(seg) > 3 else ""
        if typ == "match":
            seq.append(ref_seq[pos:pos + length])
        elif typ == "mismatch":
            seq.append(ref_seq[pos])
        if vid not in ("", "unknown"):
            ids.append(vid)
    return ids, "".join(seq)


def _walk_alt(Vars, alt_ids, start_pos, seq_len, seq_off, leftward):
    """Replay an alternative spelling against the trimmed end, walking
    variant ids away from the read (leftward: right-to-left).  Returns
    (ids consumed, final backbone pos, final seq offset)."""
    part = []
    cur = start_pos
    off = seq_off
    order = reversed(alt_ids) if leftward else alt_ids
    for vid in order:
        vt, vp, vd = Vars[vid]
        if leftward and vt == "deletion":
            dl = int(vd)
            vp = vp + dl - 1
        step = (cur - vp) if leftward else (vp - cur)
        assert step >= 0
        noff = off + step
        if noff >= seq_len:
            break
        if vt == "single":
            noff += 1
            ncur = vp - 1 if leftward else vp + 1
        elif leftward:
            ncur = vp - dl
        else:
            ncur = vp + int(vd)
        if leftward:
            part.insert(0, vid)
        else:
            part.append(vid)
        if noff >= seq_len:
            break
        off, cur = noff, ncur
    return part, cur, off


def _trim_end(ref_seq, Vars, alts, alts_list, cmp_list, read_edge,
              leftward):
    """Scan segments from the far end toward `read_edge`'s end, find
    anchors participating in an equivalence, and collect every equivalent
    end spelling.  Returns (trim index, alt spellings, anchored?)."""
    n = len(cmp_list)
    order = reversed(range(n)) if leftward else range(n)
    trim = 0 if leftward else n - 1
    spellings = set()
    anchored = False

    # cumulative end tables: _ht_and_seq over a prefix/suffix slice needs
    # only the joined variant ids and the denoted length, both of which
    # accumulate segment-by-segment — O(n) once instead of O(n) per scan
    # position
    seg_id = []
    seg_len = []
    for seg in cmp_list:
        typ = seg[0]
        v = seg[3] if len(seg) > 3 else ""
        seg_id.append(v if v not in ("", "unknown") else None)
        seg_len.append(seg[2] if typ == "match"
                       else (1 if typ == "mismatch" else 0))
    end_ids_str = [None] * n   # joined ids of the end slice at i
    end_n_ids = [0] * n
    end_seq_len = [0] * n
    acc_ids, acc_n, acc_len = "", 0, 0
    rng = range(n) if leftward else reversed(range(n))
    for i in rng:   # leftward slices are prefixes, rightward suffixes
        if seg_id[i] is not None:
            acc_ids = (acc_ids + "-" + seg_id[i] if acc_ids
                       else seg_id[i]) if leftward else \
                (seg_id[i] + "-" + acc_ids if acc_ids else seg_id[i])
            acc_n += 1
        acc_len += seg_len[i]
        end_ids_str[i] = acc_ids
        end_n_ids[i] = acc_n
        end_seq_len[i] = acc_len

    for i in order:
        seg = cmp_list[i]
        typ = seg[0]
        vid = seg[3] if typ in ("mismatch", "deletion") else ""
        if typ in ("mismatch", "deletion", "insertion") \
                and not str(vid).startswith("hv"):
            continue
        seg_lo, seg_hi = _segment_span(seg)
        ids_str = end_ids_str[i]
        n_ids = end_n_ids[i]
        seq_len = end_seq_len[i]
        if not n_ids:
            end_str = str(read_edge)
        elif leftward:
            end_str = "%d-%s" % (read_edge, ids_str)
        else:
            end_str = "%s-%d" % (ids_str, read_edge)

        hit = False
        if leftward:
            stop = _lower_bound(alts_list, seg_hi + 1)
            scan = reversed(range(min(stop + 1, len(alts_list))))
        else:
            scan = range(_lower_bound(alts_list, seg_lo), len(alts_list))
        for j in scan:
            anchor_pos, rep = alts_list[j]
            if (anchor_pos < seg_lo) if leftward else (anchor_pos > seg_hi):
                break
            if (anchor_pos > seg_hi) if leftward else (anchor_pos < seg_lo):
                continue
            if n_ids and rep.find(ids_str) == -1:
                continue
            # the equivalence must extend past the read edge: either the
            # rep ht has no extra inner variant (then its boundary must
            # reach the edge) or its first extra variant lies beyond it.
            rep_ids = rep.split("-")[:-1] if leftward else rep.split("-")[1:]
            if n_ids + 1 == len(rep_ids):
                bound = int(rep_ids[0]) if leftward else int(rep_ids[-1])
                if (read_edge < bound) if leftward else (read_edge > bound):
                    continue
            else:
                extra = rep_ids[len(rep_ids) - n_ids - 1] \
                    if leftward else rep_ids[n_ids]
                vt2, vp2, vd2 = Vars[extra]
                if leftward and vt2 == "deletion":
                    vp2 = vp2 + int(vd2) - 1
                if (read_edge <= vp2) if leftward else (read_edge >= vp2):
                    continue
            hit = True
            for alt_str in alts[rep]:
                toks = alt_str.split("-")
                if leftward:
                    alt_edge = int(toks[-1])
                    assert alt_edge <= seg_hi
                    off0 = seg_hi - alt_edge
                else:
                    alt_edge = int(toks[0])
                    assert seg_lo <= alt_edge
                    off0 = alt_edge - seg_lo
                part, cur, off = _walk_alt(Vars, toks[1:-1], alt_edge,
                                           seq_len, off0, leftward)
                if not part:
                    continue
                overhang = seq_len - off - 1
                if not leftward:
                    assert overhang >= 0
                # inner catalog variants between the old and new trim
                # points ride along on the emitted spelling
                bridge = ""
                if anchored:
                    lo_s, hi_s = ((i + 1, trim) if leftward
                                  else (trim + 1, i))
                    mids = [c[3] for c in cmp_list[lo_s:hi_s]
                            if c[0] in ("mismatch", "deletion", "insertion")
                            and str(c[3]).startswith("hv")]
                    if mids:
                        bridge = ("-" + "-".join(mids)) if leftward \
                            else ("-".join(mids) + "-")
                if leftward:
                    spellings.add("%d-%s%s" % (cur - overhang,
                                               "-".join(part), bridge))
                else:
                    spellings.add("%s%s-%d" % (bridge, "-".join(part),
                                               cur + overhang))
        if hit:
            if not anchored:
                trim = i + 1 if leftward else i - 1
                spellings.add(end_str)
            anchored = True

    if not anchored:
        spellings.add(str(read_edge))
    return trim, spellings, anchored


def identify_ambiguous_diffs(ref_seq, Vars, alts_left, alts_right,
                             alts_left_list, alts_right_list, cmp_list,
                             verbose=0):
    """Trim ambiguous read ends; returns
    (cmp_left, cmp_right, left_alt_strs, right_alt_strs).

    cmp_list entries: [type, pos, length, var_id_str] (reference format).
    """
    read_lo = cmp_list[0][1]
    read_hi = cmp_list[-1][1] + cmp_list[-1][2] - 1

    cmp_left, left_set, _ = _trim_end(
        ref_seq, Vars, alts_left, alts_left_list, cmp_list, read_lo, True)
    cmp_right, right_set, _ = _trim_end(
        ref_seq, Vars, alts_right, alts_right_list, cmp_list, read_hi, False)

    if cmp_right < cmp_left:
        cmp_left = 0
        left_set = {str(read_lo)}

    from ..validate import SANITY_CHECK, check_amb_uniqueness
    if SANITY_CHECK:
        check_amb_uniqueness(cmp_list, cmp_left, cmp_right,
                             list(left_set), list(right_set))

    return cmp_left, cmp_right, list(left_set), list(right_set)
