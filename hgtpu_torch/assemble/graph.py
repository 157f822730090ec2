# Copy of hgtpu/assemble/graph.py's helpers, viterbi_path, AsmNode, the
# AssemblyGraph constructor, add_node, remove_nodes and calculate_coverage;
# AssemblyGraph.guided_debruijn is written anew and held to hgtpu's results.
"""Guided de Bruijn assembly with Viterbi graph-coloring phasing.

- AsmNode      per-position {nt: [count, var_id]} sequences against the
               backbone, overlap/combine operations, variant extraction
               (ref: Node, hisatgenotype_assembly_graph.py:176-553).
- viterbi_path longest path through the contig trellis (ref :130-173).
- AssemblyGraph.guided_debruijn: positional de Bruijn graph (k = 60) over
  the read nodes, read pruning at branch positions, unbranched paths,
  strand groups and their merging into at most two allele strands, then
  Viterbi phasing against the predicted allele nodes.  Derived here from
  its behaviour (the passes are described above _Slots); its call, contig
  names and sequences equal hgtpu.assemble's.
"""
from __future__ import annotations

import math
import sys
from collections import deque
from copy import copy as shallow_copy, deepcopy

import numpy as np

K = 60  # k-mer length (ref: guided_DeBruijn, :661)


def get_major_nt(nt_dic):
    nt = ""
    max_count = 0
    for tmp_nt, (tmp_count, _vid) in nt_dic.items():
        if tmp_count > max_count:
            max_count = tmp_count
            nt = tmp_nt
    return nt


def match_score(nt_dic1, nt_dic2):
    total1 = sum(c for c, _ in nt_dic1.values()) * 2.0
    total2 = sum(c for c, _ in nt_dic2.values()) * 2.0
    best = 0.0
    for nt in "ACGT":
        if nt in nt_dic1 and nt in nt_dic2:
            best = max(best, nt_dic1[nt][0] / total1 + nt_dic2[nt][0] / total2)
    return best


def get_ungapped_seq(seq):
    return [nt_dic for nt_dic in seq if get_major_nt(nt_dic) != "D"]


def get_ungapped_seq_pos(seq, pos):
    tot_del = tot_ins = 0
    for i, nt_dic in enumerate(seq):
        nt = get_major_nt(nt_dic)
        if nt == "D":
            tot_del += 1
        elif nt[0] == "I":
            tot_ins += 1
        if i - tot_ins == pos:
            return pos - tot_del
    return -1


def mate_node_id(node_id):
    base, end = node_id.split("|")
    return "|".join([base, "R" if end == "L" else "L"])


def viterbi_path(trellis, states, verbose=False):
    """Max-plus decode of the contig/allele trellis (ref :130-173).

    The contig trellis carries NO transition costs — the cumulative weight
    of state j at step t is trellis[t][j] plus the best cumulative weight
    of step t-1, a constant across j.  The optimum therefore decomposes
    row-by-row: total score = sum of row maxima, path = each row's argmax
    (ties resolve to the lowest index, as the reference's sequential
    strictly-greater scan does).  One vectorized argmax per (ragged) row
    replaces the O(T x S^2) dynamic program.
    """
    assert trellis and all(len(row) for row in trellis)
    score = 0.0
    path = []
    for row, row_states in zip(trellis, states):
        w = np.asarray(row, dtype=np.float64)
        j = int(np.argmax(w))
        score += float(w[j])
        path.append(row_states[j])
    return score, path


class AsmNode:
    """A read/contig/allele node: positioned nt-dict sequence."""

    def __init__(self, id, left, seq, qual, var, ref_seq, ref_vars, mpileup):
        self.id = id
        self.left = left
        assert len(seq) == len(var)
        self.seq = []
        self.ins_len = 0
        for s in range(len(seq)):
            nt = seq[s]
            if len(nt) == 2:
                self.ins_len += 1
            self.seq.append({nt: [1, var[s]]})
        self.right = self.left + len(seq) - 1 - self.ins_len
        self.read_ids = {id}
        self.mate_ids = {id.split("|")[0]}
        self.ref_seq = ref_seq
        self.ref_vars = ref_vars   # var id -> (type, pos, data)
        self.mpileup = mpileup
        self.calculate_avg_cov()

    # ------------------------------------------------------------------ #
    # Overlap scoring parameters (behavioral constants the reference's
    # contig merge tolerates, assembly_graph.py:241-295 — protected by
    # the bit-identity mandate):
    #   MISMATCH_RATE       tolerated mismatch mass per overlapped base
    #   VAR_CONFLICT_PENALTY extra weight when the two majority bases
    #                        assert different variant identities,
    #                        discounted by how well-covered both are
    #   PROBE_WINDOW        +-bases around the nominal offset searched
    #                        (absorbs indel drift between the nodes)
    MISMATCH_RATE = 0.012
    VAR_CONFLICT_PENALTY = 5.0
    PROBE_WINDOW = 5

    def _ungapped_profile(self):
        """Columnar view of the ungapped sequence for the vectorized
        overlap scan: (majors [L] str, major var ids [L] str, major
        counts [L] f64, 2x total counts [L] f64, ACGT counts [L,4] f64,
        ACGT presence [L,4] bool)."""
        ung = get_ungapped_seq(self.seq)
        L = len(ung)
        majors = np.empty(L, object)
        mvars = np.empty(L, object)
        mcnt = np.empty(L, np.float64)
        tot2 = np.empty(L, np.float64)
        acgt = np.zeros((L, 4), np.float64)
        has = np.zeros((L, 4), bool)
        for i, d in enumerate(ung):
            nt = get_major_nt(d)
            majors[i] = nt
            mvars[i] = d[nt][1]
            mcnt[i] = d[nt][0]
            tot2[i] = sum(c for c, _ in d.values()) * 2.0
            for k, b in enumerate("ACGT"):
                e = d.get(b)
                if e is not None:
                    acgt[i, k] = e[0]
                    has[i, k] = True
        return majors, mvars, mcnt, tot2, acgt, has

    def overlap_with(self, other, skipN=False):
        """Best ungapped placement of `other` onto this node:
        (offset, overlap, mismatch score), or (-1, -1, maxsize).

        The scan probes offsets around the coordinate-implied one and
        accepts the first whose weighted mismatch mass stays within
        MISMATCH_RATE per base — the contig-merge acceptance rule of the
        reference (assembly_graph.py:241-295).  Each probe scores the
        whole window in one vectorized pass; because mismatch
        contributions are non-negative, total <= budget is equivalent to
        the reference's running-sum early exit."""
        assert self.left <= other.left
        if self.right < other.left:
            return -1, -1, sys.maxsize
        ma, va, ca, t2a, aa, ha = self._ungapped_profile()
        mb, vb, cb, t2b, ab, hb = other._ungapped_profile()
        La, Lb = len(ma), len(mb)
        i_left = get_ungapped_seq_pos(self.seq, other.left - self.left)
        avg_a, avg_b = self.get_avg_cov(), other.get_avg_cov()
        for i in range(i_left - self.PROBE_WINDOW,
                       i_left + self.PROBE_WINDOW + 1):
            max_mm = self.MISMATCH_RATE * (La - i)
            w = min(Lb, La - i) if i >= 0 else 0
            if w <= 0:
                # nothing aligns (off the front / past the end): zero
                # mismatch mass trivially passes a positive budget
                if 0.0 <= max_mm:
                    return i, min(La - i, Lb), 0.0
                continue
            sa = slice(i, i + w)
            mism = ma[sa] != mb[:w]
            if skipN:
                mism &= (ma[sa] != "N") & (mb[:w] != "N")
            if not mism.any():
                return i, min(La - i, Lb), 0.0
            # shared-base agreement score: best ACGT mass carried by
            # both columns (match_score)
            both = ha[sa] & hb[:w]
            agree = np.where(both, aa[sa] / t2a[sa, None]
                             + ab[:w] / t2b[:w, None], 0.0).max(axis=1)
            mm = np.where(mism, 1.0 - agree, 0.0)
            # conflicting variant identity: flat penalty, discounted by
            # coverage support of both majors, floored at 1.0
            conflict = mism & (va[sa] != vb[:w])
            adjust = (np.minimum(1.0, ca[sa] / avg_a)
                      * np.minimum(1.0, cb[:w] / avg_b))
            mm = np.where(conflict,
                          np.maximum(1.0, self.VAR_CONFLICT_PENALTY
                                     * adjust), mm)
            tmp_mm = float(mm.sum())
            if tmp_mm <= max_mm:
                return i, min(La - i, Lb), tmp_mm
        return -1, -1, sys.maxsize

    def combine_with(self, other):
        """Absorb `other` (same coordinate frame, self.left <=
        other.left): pool per-position nt counts over the overlap, gap
        any uncovered middle with N columns, append the tail
        (assembly_graph.py:298-377)."""
        if self.left > other.left:
            return
        absorbed = 0                 # positions of `other` already pooled
        if self.right >= other.left:
            # raw index of other.left in self.seq: backbone distance plus
            # the insertion columns encountered on the way
            at, ins_len = 0, 0
            for at, nt_dic in enumerate(self.seq):
                if get_major_nt(nt_dic).startswith("I"):
                    ins_len += 1
                if at == other.left - self.left + ins_len:
                    break
            for dst, src in zip(self.seq[at:], other.seq):
                for nt, (count, var_id) in src.items():
                    hit = dst.get(nt)
                    if hit is not None:
                        hit[0] += count
                    else:
                        dst[nt] = [count, var_id]
                absorbed += 1
        else:
            self.seq.extend({"N": [1, ""]}
                            for _ in range(other.left - self.right - 1))
        if absorbed < len(other.seq):
            self.seq.extend(deepcopy(other.seq[absorbed:]))
        self.read_ids |= other.read_ids
        self.mate_ids |= other.mate_ids
        self.ins_len = sum(
            1 for nt_dic in self.seq if get_major_nt(nt_dic)[0] == "I")
        self.right = self.left + len(self.seq) - 1 - self.ins_len
        self.calculate_avg_cov()

    def ungapped_length(self):
        return len(get_ungapped_seq(self.seq))

    def contain_Ns(self):
        return any(get_major_nt(d) == "N" for d in self.seq)

    def get_var_ids(self, left=0, right=sys.maxsize):
        """Variant ids expressed by the node's major bases (ref :393-421)."""
        vars = []
        left = max(left, self.left)
        right = min(right, self.right)
        ins_len = 0
        for pos in range(left, right + 1):
            var_i = pos - self.left + ins_len
            nt_dic = None
            while var_i < len(self.seq):
                nt_dic = self.seq[var_i]
                nt = get_major_nt(nt_dic)
                if nt.startswith("I"):
                    var_i += 1
                    ins_len += 1
                else:
                    break
            if nt_dic is None:
                continue
            nt = get_major_nt(nt_dic)
            for _, var in nt_dic.values():
                if var in ("", "unknown") or var not in self.ref_vars:
                    continue
                if vars and var == vars[-1]:
                    continue
                vtype, _vpos, vdata = self.ref_vars[var]
                if (vtype == "single" and vdata == nt) \
                        or (vtype == "deletion" and nt == "D") \
                        or (vtype == "insertion" and len(nt) == 2
                            and nt[1] == vdata):
                    vars.append(var)
        return vars

    def get_avg_cov(self):
        return self.avg

    def calculate_avg_cov(self):
        self.avg = sum(c for nt_dic in self.seq
                       for c, _ in nt_dic.values()) / max(1, len(self.seq))
        return self.avg

    def get_seq(self):
        out = []
        for nt_dic in self.seq:
            nt = get_major_nt(nt_dic)
            if nt[0] == "I":
                out.append(nt[1])
            elif nt != "D":
                out.append(nt)
            else:
                out.append("D")
        return "".join(c for c in out if c != "D")


# ---------------------------------------------------------------------- #
# Guided de Bruijn assembly: the port's own derivation.
#
# AssemblyGraph.guided_debruijn runs five passes over the read nodes:
#
# 1. The positional k-mer graph.  Every read node spells its major bases
#    (insertion columns dropped, deletions kept as "D").  Each window of K
#    spelled bases is an entry at the backbone position of its first base.
#    Equal windows at one position form one vertex; vertices are numbered
#    per position in the order of their first entry, entries taken in
#    node order (left, then right).  Vertex u at p - 1 precedes vertex v
#    at p when u's last K - 1 bases are v's first K - 1.
# 2. Read pruning.  At every position with two live vertices or more, the
#    reads behind the weaker alternatives are dropped, and the graph is
#    rebuilt until a round drops nothing: first under the lenient rules,
#    then under the strict one.
# 3. Unbranched paths, found by a breadth-first walk from the first
#    position.
# 4. Strand groups: paths that overlap the first path of a run are one
#    group of alternative strands.
# 5. Merging: the two groups that share the most evidence (read mates,
#    then predicted alleles) are merged until nothing is left to merge;
#    once contigs exist, their strands are phased against every pair of
#    predicted alleles by a Viterbi pass over the groups.
#
# The contig names, "(group-strand)read", and the numbering of vertices,
# paths and groups behind them are part of the result: every order below
# (node order, vertex order, the walk's queue, the stable sorts and the
# first-maximum picks) is chosen to give the same names and the same
# call as hgtpu.assemble.
# ---------------------------------------------------------------------- #

_SPELLED = frozenset("ACGTND")
_BASE_CODE = np.full(256, 7, np.uint8)
for _i, _ch in enumerate("ACGTD"):
    _BASE_CODE[ord(_ch)] = _i
_WORD = 20          # bases per uint64 word, 3 bits a base

# merge rules (the reference's merge thresholds, guided_DeBruijn)
SKEW = 6            # one side dominates when it is over 6x the other ...
MIN_LINKS = 2       # ... and over 2 links
MAJORITY = 2        # a strand leads when it holds over 2x the other's reads
UNPHASEABLE = -1    # score of a 2x2 pair whose two pairings tie


def _spell(node):
    """A node's major bases, insertions left out."""
    return "".join(nt for nt in map(get_major_nt, node.seq)
                   if nt in _SPELLED)


def _words(codes, width):
    """The uint64 word of `width` bases starting at every index of
    `codes` that has `width` bases from it on."""
    n = max(len(codes) - width + 1, 0)
    out = np.zeros(n, np.uint64)
    for i in range(width):
        out <<= np.uint64(3)
        out |= codes[i:i + n].astype(np.uint64)
    return out


def _dense_ids(*columns):
    """Equal rows of the given uint64 columns get equal ids."""
    rows = np.stack(columns, axis=1)
    return np.unique(rows, axis=0, return_inverse=True)[1].reshape(-1)


def _contig_name(group, strand, read_id):
    return "({}-{}){}".format(group, strand, read_id)


def _clone(node):
    """An AsmNode copy that owns its counts and id sets and shares the
    read-only backbone, variant table and pileup."""
    twin = shallow_copy(node)
    twin.seq = [{nt: list(cv) for nt, cv in col.items()} for col in node.seq]
    twin.read_ids = set(node.read_ids)
    twin.mate_ids = set(node.mate_ids)
    return twin


class _Slots:
    """The nodes that enter one build round, in graph order.

    A slot is one node of a read: (read id, 0) for the read's node and
    (read id, i) for its i-th alternative haplotype.  Its bases come from
    the spelling table, which keeps a slot's last spelling of K bases or
    more."""

    def __init__(self, graph, spelled):
        rows = []
        for rid, node in graph.nodes.items():
            for sub, nd in enumerate([node] + graph.other_nodes.get(rid, [])):
                seq = spelled.get((rid, sub))
                if seq is None or "N" in seq:
                    continue
                rows.append((nd.left, nd.right, rid, sub, seq))
        rows.sort(key=lambda r: (r[0], r[1]))
        self.keys = [(r[2], r[3]) for r in rows]
        self.read = [r[2] for r in rows]
        self.seq = [r[4] for r in rows]
        self.left = np.array([r[0] for r in rows], np.int64)
        self.length = np.array([len(r[4]) for r in rows], np.int64)

    def __len__(self):
        return len(self.keys)


class _KmerGraph:
    """The positional k-mer graph of one round, as flat arrays.

    entries, sorted by (position, slot): the first entry per position
    (`estart`), `ent_slot`, `ent_local` (vertex index within its
    position); vertices, sorted by (position, local index): first vertex
    and count per position (`vstart`, `nv`), `npred`, `members(v)`
    (slots, ascending), `succ(v)` (successors in local order) and
    `last_base(v)`."""

    def __init__(self, slots: _Slots, n_pos: int):
        n_pos = max(n_pos, 0)
        self.n_pos = n_pos
        S = len(slots)
        # a node's windows run from its left to its last full window,
        # but the sweep that built the reference's graph drops a node's
        # remaining windows once a later node (in slot order) has ended
        # two positions back: the reach is cut at 1 + the least last
        # window of the later slots
        last = slots.left + slots.length - K
        later = np.full(S, np.iinfo(np.int64).max - 1, np.int64)
        if S > 1:
            later[:-1] = np.minimum.accumulate(last[::-1])[::-1][1:]
        reach = np.minimum(np.minimum(last, later + 1), n_pos - 1)
        count = np.maximum(reach - slots.left + 1, 0)
        slot = np.repeat(np.arange(S, dtype=np.int64), count)
        first = np.cumsum(count) - count
        off = np.arange(len(slot), dtype=np.int64) - np.repeat(first, count)
        pos = slots.left[slot] + off
        order = np.lexsort((slot, pos))
        slot, off, pos = slot[order], off[order], pos[order]

        codes = _BASE_CODE[np.frombuffer(
            "".join(slots.seq).encode("ascii"), np.uint8)]
        base = np.cumsum(slots.length) - slots.length
        at = base[slot] + off
        w20, w19 = _words(codes, _WORD), _words(codes, K - 2 * _WORD - 1)
        kmer = _dense_ids(w20[at], w20[at + _WORD], w20[at + 2 * _WORD])

        # vertices: one per (position, k-mer), numbered by first entry
        n_kmer = int(kmer.max()) + 1 if len(kmer) else 1
        _, head, inv = np.unique(pos * n_kmer + kmer, return_index=True,
                                 return_inverse=True)
        by_head = np.argsort(head, kind="stable")
        rank = np.empty_like(by_head)
        rank[by_head] = np.arange(len(by_head))
        vert = rank[inv.reshape(-1)]
        head = head[by_head]
        vpos = pos[head]
        self.vstart = np.searchsorted(vpos, np.arange(n_pos + 1))
        self.nv = np.diff(self.vstart)
        self.ent_slot = slot
        self.ent_local = vert - self.vstart[pos]
        self.estart = np.searchsorted(pos, np.arange(n_pos + 1))
        by_vert = np.argsort(vert, kind="stable")
        self._members = slot[by_vert]
        self._mstart = np.searchsorted(vert[by_vert],
                                       np.arange(len(head) + 1))
        self._last = [slots.seq[s][o + K - 1]
                      for s, o in zip(slot[head], off[head])]

        # predecessors: u at p - 1 -> v at p when suffix(u) == prefix(v)
        h = at[head]
        k1 = _dense_ids(
            np.concatenate([w20[h], w20[h + 1]]),
            np.concatenate([w20[h + _WORD], w20[h + _WORD + 1]]),
            np.concatenate([w19[h + 2 * _WORD], w19[h + 2 * _WORD + 1]]))
        prefix, suffix = k1[:len(h)], k1[len(h):]
        n_k1 = int(k1.max()) + 1 if len(k1) else 1
        out_key = (vpos + 1) * n_k1 + suffix
        in_key = vpos * n_k1 + prefix
        by_out = np.argsort(out_key, kind="stable")
        lo = np.searchsorted(out_key[by_out], in_key, "left")
        hi = np.searchsorted(out_key[by_out], in_key, "right")
        self.npred = hi - lo
        dst = np.repeat(np.arange(len(head)), self.npred)
        src = by_out[np.arange(len(dst)) + np.repeat(
            lo - (np.cumsum(self.npred) - self.npred), self.npred)]
        by_src = np.argsort(src, kind="stable")
        self._succ = dst[by_src]
        self._sstart = np.searchsorted(src[by_src],
                                       np.arange(len(head) + 1))

    def vertex(self, pos, local):
        return int(self.vstart[pos]) + local

    def members(self, v):
        return self._members[self._mstart[v]:self._mstart[v + 1]]

    def succ(self, v):
        return self._succ[self._sstart[v]:self._sstart[v + 1]]

    def last_base(self, v):
        return self._last[v]


def _prune(kg: _KmerGraph, slots: _Slots, countable, strict):
    """One sweep of read pruning over the branch positions, left to
    right; returns the slots it drops.

    A vertex's support counts its live slots whose read has one node and
    whose mate has a node.  At a position with two live vertices or more:
    - strict: all but the two best supported vertices go (ties: the
      later vertex stays);
    - else, when a read has nodes in two vertices (the last such vertex,
      then its first partner), that read's slots leave the weaker one;
    - else, of two vertices, the one with under half the other's support
      goes when the other ends in a deletion and every one of its own
      slots continues as a prefix of the other's first slot, deletions
      removed from the latter;
    - else, of three or more, those below the second least support go."""
    dropped = np.zeros(len(slots), bool)
    index = {}
    reads = np.array([index.setdefault(r, len(index)) for r in slots.read],
                     np.int64)
    for p in np.flatnonzero(kg.nv >= 2):
        e0, e1 = kg.estart[p], kg.estart[p + 1]
        sl, loc = kg.ent_slot[e0:e1], kg.ent_local[e0:e1]
        nv = int(kg.nv[p])
        live = ~dropped[sl]
        if np.count_nonzero(np.bincount(loc[live], minlength=nv)) <= 1:
            continue
        support = np.bincount(loc, weights=live & countable[sl],
                              minlength=nv).astype(np.int64).tolist()
        shared = None
        if len(np.unique(reads[sl])) < len(sl):
            rsets = [{slots.read[s] for s in sl[loc == v]}
                     for v in range(nv)]
            for v in range(nv):
                for w in range(v + 1, nv):
                    if rsets[v] & rsets[w]:
                        shared = (v, w, rsets[v] & rsets[w])
                        break
        if strict:
            ranked = sorted(range(nv), key=support.__getitem__)
            for v in ranked[:-2]:
                dropped[sl[loc == v]] = True
        elif shared is not None:
            v, w, common = shared
            weak = v if support[v] < support[w] else w
            for s in sl[loc == weak]:
                if slots.read[s] in common:
                    dropped[s] = True
        elif nv == 2:
            for weak in (0, 1):
                strong = 1 - weak
                if not support[weak] * 2 < support[strong]:
                    continue
                if kg.last_base(kg.vertex(p, strong)) != "D":
                    continue
                s0 = sl[loc == strong][0]
                tail = slots.seq[s0][p - slots.left[s0] + K:]
                tail = tail.replace("D", "")
                weak_slots = sl[loc == weak]
                if all(tail.startswith(slots.seq[s][p - slots.left[s] + K:])
                       for s in weak_slots):
                    dropped[weak_slots] = True
        else:
            floor = sorted(support)[1]
            for v in range(nv):
                if support[v] < floor:
                    dropped[sl[loc == v]] = True
    return dropped


def _unbranched_paths(kg: _KmerGraph):
    """Unbranched paths [start, end, slots], in the order a breadth-first
    walk finds them.  The walk starts at every vertex of the first
    non-empty position.  From a start it follows the one successor while
    the next position has as many vertices, none without a predecessor,
    the current vertex has one successor and that successor one
    predecessor; it then ends the path before that position and queues
    the successors there (and any vertex without predecessors).  After a
    run of empty positions every vertex of the next position is queued."""
    n_pos = kg.n_pos
    nonempty = np.flatnonzero(kg.nv > 0)
    paths = []
    if not len(nonempty):
        return paths
    queue = deque((int(nonempty[0]), b)
                  for b in range(int(kg.nv[nonempty[0]])))
    seen = set()
    while queue:
        start = queue.popleft()
        if start in seen:
            continue
        p0, b0 = start
        cur = kg.vertex(p0, b0)
        reads = list(kg.members(cur))
        j = p0 + 1
        while j < n_pos:
            v0, nvj = int(kg.vstart[j]), int(kg.nv[j])
            stop = kg.nv[j - 1] != nvj
            for b in range(nvj):
                if kg.npred[v0 + b] == 0:
                    stop = True
                    queue.append((j, b))
            nxt = kg.succ(cur)
            if len(nxt) > 1 or (len(nxt) and kg.npred[nxt[0]] > 1):
                stop = True
            if stop:
                queue.extend((j, int(v) - v0) for v in nxt)
                break
            if not len(nxt):
                break
            cur = int(nxt[0])
            reads.extend(kg.members(cur))
            j += 1
        seen.add(start)
        paths.append([p0, j, set(int(s) for s in reads)])
        if j < n_pos and kg.nv[j] == 0:
            later = nonempty[nonempty > j]
            if len(later):
                queue.extend((int(later[0]), b)
                             for b in range(int(kg.nv[later[0]])))
    return paths


class _Strand:
    """One alternative in a group: its paths (indices in sorted order),
    its read slots, those slots with their mates' slots ("linked"), and
    the predicted alleles phased onto it."""
    __slots__ = ("paths", "reads", "linked", "alleles")

    def __init__(self, paths, reads, linked, alleles):
        self.paths, self.reads = paths, reads
        self.linked, self.alleles = linked, alleles

    def copy(self):
        return _Strand(list(self.paths), set(self.reads), set(self.linked),
                       set(self.alleles))


def _strand_groups(paths, with_mates):
    """Sort the paths by (start, end); each run of paths that start
    before the run's first path ends is one group of strands.  Slots of
    multi-strand groups are `shared`; single-strand groups lose them and
    vanish when nothing is left."""
    paths = sorted(paths, key=lambda q: (q[0], q[1]))
    runs, shared = [], set()
    p = 0
    while p < len(paths):
        end = p + 1
        while end < len(paths) and paths[end][0] < paths[p][1]:
            end += 1
        runs.append([_Strand([i], paths[i][2], with_mates(paths[i][2]),
                             set()) for i in range(p, end)])
        if end - p > 1:
            for i in range(p, end):
                shared |= paths[i][2]
        p = end
    groups = []
    for run in runs:
        if len(run) == 1:
            reads = run[0].reads - shared
            if not reads:
                continue
            run[0].reads, run[0].linked = reads, with_mates(reads)
        groups.append(run)
    return groups, shared


def _log_jaccard(a, b):
    a, b = set(a), set(b)
    return math.log10(float(len(a & b) + 1) / float(len(a | b) + 1))


def _pair_matrix(ga, gb, phased):
    """Evidence two groups share, strand by strand: common alleles once
    phased, else common linked slots."""
    if phased:
        return [[len(s.alleles & t.alleles) for t in gb] for s in ga]
    return [[len(s.linked & t.linked) for t in gb] for s in ga]


def _pair_score(mat):
    """How clearly two groups pair up: all shared evidence when either
    has one strand; else each row's margin of its best column over its
    second, or UNPHASEABLE when both pairings tie."""
    if len(mat) == 1 or len(mat[0]) == 1:
        return sum(sum(row) for row in mat)
    if mat[0][0] + mat[1][1] == mat[1][0] + mat[0][1]:
        return UNPHASEABLE
    total = 0
    for row in mat:
        top = sorted(row, reverse=True)
        total += top[0] - top[1]
    return total


def _dominates(a, b):
    return a > max(MIN_LINKS, b * SKEW)


def _skewed(n1, n2):
    return n1 * SKEW < n2 or n2 * SKEW < n1


class _Merger:
    """Merges group b into group a by the merge rules.  While contigs
    exist it also logs what happens to them: merged, moved or retired."""

    def __init__(self, groups, a, b, read_of, phased):
        self.a, self.b = a, b
        self.ga, self.gb = groups[a], groups[b]
        self.read_of = read_of
        self.phased = phased
        self.merged, self.moved, self.retired = [], [], []

    def _key(self, group, index, strand):
        return (group, index, self.read_of[min(strand.reads)])

    def absorb(self, i, j, into):
        """Strand i of a takes strand j of b; its contig is named as
        strand `into` of a."""
        si, sj = self.ga[i], self.gb[j]
        if self.phased:
            lead = min(min(si.reads), min(sj.reads))
            self.merged.append((self._key(self.a, i, si),
                                self._key(self.b, j, sj),
                                (self.a, into, self.read_of[lead])))
        si.paths = sorted(si.paths + sj.paths)
        si.reads |= sj.reads

    def take(self, i, j, into):
        """Strand j of b replaces strand i of a."""
        sj = self.gb[j]
        if self.phased:
            key = self._key(self.b, j, sj)
            self.moved.append((key, (self.a, into, key[2])))
        self.ga[i] = sj

    def retire(self, i):
        """Strand i of a keeps its place but its contig goes."""
        if self.phased:
            self.retired.append(self._key(self.a, i, self.ga[i]))

    def _trim(self, mat, shared):
        """Two strands against two: a side with skewed strand sizes loses
        the strand that a dominant other strand leaves unlinked (rows of
        a first, then columns of b), and its remaining strand loses the
        shared slots."""
        ga, gb = self.ga, self.gb
        if _skewed(len(ga[0].reads), len(ga[1].reads)):
            r0, r1 = sum(mat[0]), sum(mat[1])
            if _dominates(r0, r1) or _dominates(r1, r0):
                keep = 0 if _dominates(r0, r1) else 1
                ga, mat = ga[keep:keep + 1], mat[keep:keep + 1]
                ga[0].reads -= shared
        if len(ga) == 2 and _skewed(len(gb[0].reads), len(gb[1].reads)):
            c0 = mat[0][0] + mat[1][0]
            c1 = mat[0][1] + mat[1][1]
            if _dominates(c0, c1) or _dominates(c1, c0):
                keep = 0 if _dominates(c0, c1) else 1
                gb = gb[keep:keep + 1]
                mat = [row[keep:keep + 1] for row in mat]
                gb[0].reads -= shared
        self.ga, self.gb = ga, gb
        return mat

    def run(self, mat, shared):
        """Apply the rules; False when the pair cannot be phased."""
        if len(self.ga) > 2 or len(self.gb) > 2:
            raise ValueError("a strand group holds more than two strands")
        if len(self.ga) == 2 and len(self.gb) == 2:
            mat = self._trim(mat, shared)
        ga, gb = self.ga, self.gb
        if len(ga) == 1 and len(gb) == 1:
            self.absorb(0, 0, 0)
        elif len(ga) == 1:
            # one strand against two: follow a dominant link to the
            # larger strand unless the strand holds the first path;
            # else split the strand in two
            first = 0 in ga[0].paths
            n0, n1 = len(gb[0].reads), len(gb[1].reads)
            if not first and _dominates(mat[0][0], mat[0][1]) \
                    and n0 > n1 * MAJORITY:
                self.absorb(0, 0, 0)
            elif not first and _dominates(mat[0][1], mat[0][0]) \
                    and n1 > n0 * MAJORITY:
                self.absorb(0, 1, 0)
            else:
                ga.append(ga[0].copy())
                leaning = (mat[0][0] > mat[0][1] * MAJORITY
                           or mat[0][1] > mat[0][0] * MAJORITY)
                if ga[0].paths == [0] and leaning:
                    if mat[0][0] > mat[0][1]:
                        self.absorb(0, 0, 0)
                        self.take(1, 1, 1)
                    else:
                        self.take(0, 0, 0)
                        self.absorb(1, 1, 1)
                else:
                    self.absorb(0, 0, 0)
                    self.absorb(1, 1, 1)
        elif len(gb) == 1:
            # two strands against one: a dominant strand takes it (and
            # a much smaller other strand's contig retires); else both do
            if _dominates(mat[0][0], mat[1][0]):
                self.absorb(0, 0, 0)
                if len(ga[0].reads) > len(ga[1].reads) * SKEW:
                    self.retire(1)
            elif _dominates(mat[1][0], mat[0][0]):
                self.absorb(1, 0, 0)
                if len(ga[1].reads) > len(ga[0].reads) * SKEW:
                    self.retire(0)
            else:
                self.absorb(0, 0, 0)
                self.absorb(1, 0, 1)
        else:
            straight = mat[0][0] + mat[1][1]
            crossed = mat[0][1] + mat[1][0]
            if straight == crossed:
                return False
            if straight > crossed:
                self.absorb(0, 0, 0)
                self.absorb(1, 1, 1)
            else:
                self.absorb(0, 1, 0)
                self.absorb(1, 0, 1)
        return True

    def rebuild(self, contigs):
        """The contigs after this merge: merged pairs (the one further
        left absorbing the other), then moved ones, then the rest in
        their order with group numbers past b shifted down by one."""
        out, used = {}, set()
        for k1, k2, k3 in self.merged:
            n1, n2 = contigs[k1], contigs[k2]
            lead, tail = (n1, n2) if n1.left <= n2.left else (n2, n1)
            node = _clone(lead)
            node.combine_with(tail)
            node.id = _contig_name(*k3)
            out[k3] = node
            used |= {k1, k2}
        for k1, k2 in self.moved:
            node = contigs[k1]
            node.id = _contig_name(*k2)
            out[k2] = node
            used.add(k1)
        used.update(self.retired)
        for (g, s, rid), node in contigs.items():
            if (g, s, rid) in used:
                continue
            key = (g - 1 if g > self.b else g, s, rid)
            node.id = _contig_name(*key)
            out[key] = node
        return out


class AssemblyGraph:
    def __init__(self, backbone, ref_vars, exons, primary_exons,
                 true_allele_nodes=None, predicted_allele_nodes=None):
        self.backbone = backbone
        self.ref_vars = ref_vars
        self.exons = exons
        self.primary_exons = primary_exons
        self.true_allele_nodes = true_allele_nodes or {}
        self.predicted_allele_nodes = predicted_allele_nodes or {}
        self.allele_node_order = []
        self.nodes = {}
        self.nodes2 = None
        self.other_nodes = {}
        self.coverage = {}

    def add_node(self, id, id_i, node):
        if id_i == 0:
            if id in self.nodes:
                return
            self.nodes[id] = node
        else:
            self.other_nodes.setdefault(id, []).append(node)

    # ------------------------------------------------------------------ #
    def remove_nodes(self, nodes):
        """Drop nodes contained in others or with low coverage
        (ref :621-653)."""
        delete_ids = set()
        node_list = sorted(
            ([id, n.left, n.right] for id, n in nodes.items()),
            key=lambda x: (x[2], x[1]))
        for n in range(len(node_list)):
            id, left, right = node_list[n]
            node = nodes[id]
            i = n - 1
            while i >= 0:
                id2, left2, right2 = node_list[i]
                if right2 < left:
                    break
                node2 = nodes[id2]
                if left <= left2 and right2 <= right:
                    at, overlap, mm = node.overlap_with(node2)
                    if mm < 1.0:
                        mult = overlap / float(max(right - left,
                                                   right2 - left2))
                        if node2.get_avg_cov() * mult * 10 < node.get_avg_cov():
                            delete_ids.add(id2)
                        elif left == left2 and right == right2:
                            delete_ids.add(id)
                    elif overlap > 0:
                        if node2.get_avg_cov() * 10 < node.get_avg_cov():
                            delete_ids.add(id2)
                        elif node.get_avg_cov() * 10 < node2.get_avg_cov():
                            delete_ids.add(id)
                i -= 1
        for did in delete_ids:
            del nodes[did]

    # ------------------------------------------------------------------ #
    def guided_debruijn(self):
        """Guided de Bruijn assembly and phasing (the passes described
        above _Slots).  Leaves the contigs in self.nodes and the phased
        contigs in self.nodes2; returns [[allele, allele], log10 score],
        or [["No Known alleles to match"], -1] when there is nothing to
        phase against."""
        assert len(self.nodes) > 0
        spelled = {}
        for rid in self.nodes:
            self._respell(spelled, rid)

        # passes 1-2: build, prune, rebuild until a strict round drops
        # nothing; that round's graph goes on
        strict = False
        while True:
            slots = _Slots(self, spelled)
            kgraph = _KmerGraph(slots, len(self.backbone) - K + 1)
            countable = np.array(
                [rid not in self.other_nodes
                 and mate_node_id(rid) in self.nodes for rid in slots.read],
                bool)
            dropped = _prune(kgraph, slots, countable, strict)
            if dropped.any():
                self._drop(spelled,
                           [slots.keys[s] for s in np.flatnonzero(dropped)])
            elif strict:
                break
            else:
                strict = True

        # passes 3-4: paths and strand groups, over read slots
        read_slots = {}
        for s, rid in enumerate(slots.read):
            read_slots.setdefault(rid, set()).add(s)
        mate_slots = {}

        def with_mates(reads):
            out = set(reads)
            for s in reads:
                rid = slots.read[s]
                if rid not in mate_slots:
                    mate_slots[rid] = read_slots.get(mate_node_id(rid), set())
                out |= mate_slots[rid]
            return out

        groups, shared = _strand_groups(_unbranched_paths(kgraph),
                                        with_mates)

        # pass 5: merge the best-linked pair of groups until none is left;
        # contigs (keyed group, strand, read) exist from the first time
        # no pair links
        contigs = None
        colouring = None
        while True:
            if contigs is not None:
                if not self.predicted_allele_nodes:
                    break
                colouring = self._phase(groups, contigs, slots.read)
            best, pick = -math.inf, None
            for a in range(len(groups) - 1):
                for b in range(a + 1, len(groups)):
                    mat = _pair_matrix(groups[a], groups[b],
                                       contigs is not None)
                    score = _pair_score(mat)
                    if score > best:
                        best, pick = score, (a, b, mat)
            if best < 0:
                if contigs is not None:
                    self.remove_nodes(contigs)
                    break
                contigs = self._collapse(groups, slots.read)
                continue
            a, b, mat = pick
            merger = _Merger(groups, a, b, slots.read, contigs is not None)
            if not merger.run(mat, shared):
                break
            for strand in merger.ga:
                strand.linked = with_mates(strand.reads)
            groups[a] = merger.ga
            del groups[b]
            if contigs is not None:
                contigs = merger.rebuild(contigs)
        if contigs is not None:
            self.nodes2 = {_contig_name(*key): node
                           for key, node in contigs.items()}
            if colouring is not None:
                return colouring
        return [["No Known alleles to match"], -1]

    def _respell(self, spelled, rid):
        """Spell every node of a read; spellings under K bases leave the
        slot's earlier spelling in place."""
        for sub, node in enumerate([self.nodes[rid]]
                                   + self.other_nodes.get(rid, [])):
            seq = _spell(node)
            if len(seq) >= K:
                spelled[(rid, sub)] = seq

    def _drop(self, spelled, keys):
        """Remove the given (read, slot) nodes.  A read's first surviving
        alternative takes the place of a dropped read node; a read with
        no node left goes; the reads touched are spelled again."""
        touched = set()
        for rid, sub in keys:
            touched.add(rid)
            if sub:
                self.other_nodes[rid][sub - 1] = None
            else:
                self.nodes[rid] = None
        for rid in list(self.nodes):
            alts = [n for n in self.other_nodes.get(rid, ()) if n is not None]
            if self.nodes[rid] is None and alts:
                self.nodes[rid] = alts.pop(0)
            if rid in self.other_nodes:
                if alts:
                    self.other_nodes[rid] = alts
                else:
                    del self.other_nodes[rid]
            if self.nodes[rid] is None:
                del self.nodes[rid]
        for rid in touched:
            if rid in self.nodes:
                self._respell(spelled, rid)

    def _collapse(self, groups, read_of):
        """Every strand becomes a contig: its first read's node absorbing
        the nodes of its other reads, in slot order.  self.nodes becomes
        the contigs less those remove_nodes drops; the returned copies,
        keyed (group, strand, read), are the contigs that phasing merges."""
        made = {}
        for g, group in enumerate(groups):
            for s, strand in enumerate(group):
                order = sorted(strand.reads)
                rid = read_of[order[0]]
                node = _clone(self.nodes[rid])
                for slot in order[1:]:
                    node.combine_with(self.nodes[read_of[slot]])
                node.id = _contig_name(g, s, rid)
                made[(g, s, rid)] = node
        self.nodes = {node.id: node for node in made.values()}
        contigs = {key: _clone(node) for key, node in made.items()}
        self.remove_nodes(self.nodes)
        return contigs

    def _phase(self, groups, contigs, read_of):
        """Score every pair of predicted alleles (in order, with
        repeats) against the strands, group by group: a one-strand group
        scores each allele against its strand; a two-strand group scores
        both assignments of the two alleles to its strands.  The best
        pair (first maximum) is added to its strands' allele sets.
        Returns [pair, log10 score]."""
        names = list(self.predicted_allele_nodes)
        best = None
        for i in range(len(names)):
            for j in range(i, len(names)):
                pair = [names[i], names[j]]
                alleles = [self.predicted_allele_nodes[n] for n in pair]
                trellis, states = [], []
                for g, group in enumerate(groups):
                    fits = []
                    for s, strand in enumerate(group):
                        node = contigs[(g, s, read_of[min(strand.reads)])]
                        nvars = node.get_var_ids()
                        fits.append([_log_jaccard(
                            nvars, an.get_var_ids(node.left, node.right))
                            for an in alleles])
                    if len(fits) > 1:
                        # state c puts allele c on strand 0 and the other
                        # allele on strand 1
                        row = []
                        for c in (0, 1):
                            total = 0
                            for s, fit in enumerate(fits):
                                total += fit[1 - c] if s == 1 else fit[c]
                            row.append(total)
                        states.append([[0, 1], [1, 0]])
                    else:
                        row = fits[0]
                        states.append([[0, 0], [0, 0]])
                    trellis.append(row)
                score, path = viterbi_path(trellis, states)
                if best is None or score > best[0]:
                    best = (score, pair, path)
        score, pair, path = best
        for group, state in zip(groups, path):
            for c, s in enumerate(state):
                group[s].alleles.add(pair[c])
        return [pair, score]

    # ------------------------------------------------------------------ #
    def calculate_coverage(self, simulation=False):
        """Per-allele coverage profile for drawing (ref :1688-1743)."""
        allele_nodes = self.true_allele_nodes if simulation \
            else self.predicted_allele_nodes
        anode_list = [[id, n.left, n.right] for id, n in allele_nodes.items()]
        coverage = {id: [0.0] * len(self.backbone) for id, _, _ in anode_list}
        for id, node in self.nodes.items():
            nodes2 = [node] + self.other_nodes.get(id, [])
            for nd in nodes2:
                left, right = nd.left, nd.right
                nvars = nd.get_var_ids()
                max_common = -sys.maxsize
                max_ids = []
                for aid, aleft, aright in anode_list:
                    if right - left <= 500 and (left < aleft or right > aright):
                        continue
                    avars = allele_nodes[aid].get_var_ids(left, right)
                    tmp = len(set(nvars) & set(avars)) \
                        - len(set(nvars) | set(avars))
                    if tmp > max_common:
                        max_common = tmp
                        max_ids = [aid]
                    elif tmp == max_common:
                        max_ids.append(aid)
                if not max_ids:
                    continue
                add_cov = 1.0 / len(nodes2) / len(max_ids)
                for aid in max_ids:
                    for p in range(left, min(right + 1, len(self.backbone))):
                        coverage[aid][p] += add_cov
        max_cov = max((max(c) for c in coverage.values()), default=0.0)
        if max_cov > 0:
            coverage = {a: [x / max_cov for x in c]
                        for a, c in coverage.items()}
        self.coverage = coverage
        return coverage
