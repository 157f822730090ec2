"""The aligner's verify prep on arrays equals the list build it replaced.

  expansion  GeneAligner._expand gives the entries of the list build
             (_proposal_meta below, kept here as the oracle): the same
             entries in the same order, read, then candidate, then
             proposal; on a gene with stacked catalogue indels, at both
             orientation ranks, in leftmost mode too, with reads clipped
             at either backbone end, a below-threshold candidate in the
             middle of a list and a start repeated across candidates
  bound      _lb_entries gives _lb_values_meta's bounds (the oracle's
             [E, 64] scan) and _rank_entries_impl keeps the same set; the
             counters count every bounded entry and, on the CPU, none on
             the card
  host path  _proposal_entries (aligners without the native verifier)
             gives the list build's entries and subreads, read by read
  empty      a chunk with no pending read gives no entries
  plain      the CUDA kernel's packed inputs (pack_mask, pack_entries)
             decoded on the host give _lb_core's bound on random entries:
             windows of 1 to _LB_TAIL columns, front clips, the pad code,
             an exit at every cap, E = 0 and E = 1; the kernel's wrapper
             refuses CPU tensors (tests/test_torch_cuda.py holds the
             kernel itself against _lb_core on the card)

No jax: tests/test_torch_cuda.py imports `bound_case` from here on a
machine without it.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from hgtpu_torch.align import GeneAligner
from hgtpu_torch.db import build_gene_ref
from hgtpu_torch.ops.proposal_bound import (pack_entries, pack_mask,
                                            proposal_bound)
from hgtpu_torch.sim import simulate_reads
from hgtpu_torch.utils.trace import TRACE, to_host
from synth import make_gene_msa
from torch_threads import _torch_threads  # noqa: F401


def proposal_meta(ga, cand_pos, cand_scores, m, max_clip_frac=0.35):
    """The list build's per-read expansion, as the aligner had it:
    ordered (start, clip_front, sub_len) tuples."""
    min_score = m * ga.min_seed_frac
    out = []
    P = len(ga.gene.backbone)
    max_clip = int(m * max_clip_frac)
    tried = set()
    for k in range(len(cand_pos)):
        if cand_scores[k] < min_score:
            break
        for start in ga._start_closure(int(cand_pos[k]), m):
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
    return out


def lb_values_meta(ga, st, flat_meta, flat_starts):
    """The list build's bound: one [E, 64]-block gather per step from the
    chunk's forward and reverse codes (on the CPU the placement's `both`
    is their concatenation)."""
    comb = st["both"].numpy()
    n = st["n"]
    E = len(flat_meta)
    rows = np.fromiter((m[0] + (n if m[1] else 0) for m in flat_meta),
                       np.int64, E)
    cfs = np.fromiter((m[2] for m in flat_meta), np.int64, E)
    lens = np.fromiter((m[3] for m in flat_meta), np.int64, E)
    starts = np.asarray(flat_starts, dtype=np.int64)
    w_eff, W = ga._lb_window(starts, lens)

    def fetch(active, at, w):
        jj = np.arange(at, at + w, dtype=np.int64)
        col = np.minimum(cfs[active][:, None] + jj[None, :],
                         comb.shape[1] - 1)
        rp = comb[rows[active][:, None], col]
        rp[jj[None, :] >= lens[active][:, None]] = 5
        return rp

    return ga._lb_core(fetch, E, starts, w_eff, W)


def oracle(ga, st, rank):
    sf, pf, sr, pr, use_rc = st["cand"]
    starts, meta = [], []
    for i in st["pending"].tolist():
        o_rc = bool(use_rc[i]) != bool(rank)
        cand_p, cand_s = (pr[i], sr[i]) if o_rc else (pf[i], sf[i])
        for s, cf, ln in proposal_meta(ga, cand_p, cand_s,
                                       int(st["lens"][i])):
            starts.append(s)
            meta.append((i, o_rc, cf, ln))
    return starts, meta


@pytest.fixture(scope="module")
def gene():
    spec = make_gene_msa(seed=23, n_alleles=10, length=900, n_snp=40,
                         n_del=22, n_ins=16)
    g, _ = build_gene_ref("A", spec["names"], spec["rows"],
                          spec["ref_allele"], min_var_freq=0.0)
    return g


def chunk(ga, gene):
    """A placed chunk: error-laden reads of two alleles, reads hanging
    30 bases off either backbone end, then three reads' candidate lists
    edited: a below-threshold candidate in the middle, and a candidate
    repeating an earlier one's anchor (every start proposed twice)."""
    rng = np.random.default_rng(5)
    r1, _r2, _ = simulate_reads(gene, list(gene.allele_names[:2]),
                                simulate_interval=13, perbase_errorrate=3.0,
                                seed=7)
    seqs = [r.seq for r in r1]
    bb = gene.backbone

    def junk(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    seqs += [junk(30) + bb[:70], junk(25) + bb[:75],
             bb[-70:] + junk(30), bb[-75:] + junk(25)]
    ids = ["r%d" % i for i in range(len(seqs))]
    placed = ga._place_chunk(seqs)
    placed = placed[:2] + (to_host(placed[2]),) + placed[3:]
    st = ga._chunk_state(ids, seqs, "L", placed)
    sf, pf, sr, pr, _use_rc = st["cand"]
    pend = st["pending"]
    assert len(pend) > 20
    a, b, c = pend[:3].tolist()
    for s_ in (sf, sr):
        s_[a, 2] = 0                  # the list stops at candidate 2
    for p_ in (pf, pr):
        p_[b, 1] = p_[b, 0]           # candidate 1 repeats candidate 0
        p_[c, 3] = p_[c, 1]
    return st


@pytest.mark.parametrize("leftmost", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_entries_equal_the_list_build(gene, rank, leftmost):
    ga = GeneAligner(gene, device="cpu", leftmost=leftmost)
    st = chunk(ga, gene)
    want_s, want_m = oracle(ga, st, rank)
    at, rc, starts, clip, lens = ga._expand(st, rank)
    got_m = list(zip(st["pending"][at].tolist(), rc.tolist(),
                     clip.tolist(), lens.tolist()))
    assert got_m == want_m and starts.tolist() == want_s
    assert any(m[2] > 0 for m in want_m)                # clipped in front
    assert any(s + ln == len(gene.backbone)             # clipped at the end
               for s, m in zip(want_s, want_m) for ln in [m[3]]
               if ln < int(st["lens"][m[0]]) and m[2] == 0)
    want_lb = lb_values_meta(ga, st, want_m, want_s)
    before = TRACE.counters()
    got_lb = ga._lb_entries(st, st["pending"][at]
                            + np.where(rc, st["n"], 0), starts, clip, lens)
    after = TRACE.counters()
    assert np.array_equal(got_lb, want_lb)
    assert after.get("verify.lb.entries", 0) \
        - before.get("verify.lb.entries", 0) == len(want_s)
    assert after.get("verify.lb.card", 0) == before.get("verify.lb.card", 0)
    keep = np.flatnonzero(want_lb <= ga.num_editdist)
    assert 0 < len(keep) < len(want_s)
    ent = ga._rank_entries_impl(st, rank)
    assert list(zip(ent.rows.tolist(), ent.rc.tolist(), ent.clip.tolist(),
                    ent.lens.tolist())) == [want_m[k] for k in keep]
    assert ent.starts.tolist() == [want_s[k] for k in keep]
    assert ent.lbs.tolist() == want_lb[keep].tolist()
    k = int(keep[-1])
    i, o_rc, cf, ln = want_m[k]
    want_codes = (st["rc_codes"] if o_rc else st["fwd_codes"])[i][cf:cf + ln]
    assert bytes(ent.codes([len(keep) - 1])[0]) == bytes(want_codes)


def test_a_chunk_with_nothing_pending(gene):
    ga = GeneAligner(gene, device="cpu")
    st = chunk(ga, gene)
    st["pending"] = st["pending"][:0]
    assert all(len(x) == 0 for x in ga._expand(st, 0))
    assert ga._rank_entries_impl(st, 1) is None
    ga._verify_pending(st, 0)
    assert len(st["pending"]) == 0


def bound_case(gene, budget, E, seed, device="cpu"):
    """Random bound entries for an aligner of `gene` at edit budget
    `budget`: codes [E, L] int8 (0-4, with the pad code 5 sprinkled in),
    half the rows the backbone under their window with 0 to budget + 2
    substitutions (so counts stop below the cap, at it, or run the whole
    window), the rest random; windows of 1 to _LB_TAIL columns, front
    clips of 0 to 40.  Returns the aligner, the kernel's inputs on
    `device` and _lb_core's bound."""
    ga = GeneAligner(gene, num_editdist=budget, device="cpu")
    rng = np.random.default_rng(seed)
    P = len(gene.backbone)
    tail = ga._LB_TAIL
    L = tail + 48
    codes = rng.integers(0, 5, (max(E, 1), L)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 5
    win = rng.integers(1, 200, E)
    win[::7] = rng.integers(1, tail + 1, len(win[::7]))
    if E >= 2:
        win[:2] = (1, tail)
    clip = rng.integers(0, 41, E)
    clip[::3] = 0
    starts = rng.integers(0, P, E)
    bb = ga.verifier.bb
    for e in range(0, E, 2):
        s, w, c = int(starts[e]), int(win[e]), int(clip[e])
        seg = np.full(w, 5, np.int8)
        n_bb = max(0, min(w, P - s))
        seg[:n_bb] = bb[s:s + n_bb]
        hits = rng.choice(w, min(w, int(rng.integers(0, budget + 3))),
                          replace=False)
        seg[hits] = (seg[hits] + 1) % 4
        codes[e, c:c + w] = seg
    rows = np.arange(E)

    def fetch(active, at, w):
        jj = np.arange(at, at + w)
        return codes[rows[active][:, None], clip[active][:, None] + jj]

    W = int(win.max()) if E else 0
    want = ga._lb_core(fetch, E, starts, win, W) if E else \
        np.zeros(0, np.int64)
    args = (torch.from_numpy(codes).to(device),
            torch.from_numpy(pack_mask(ga._match_ok6_dil)).to(device),
            torch.from_numpy(pack_entries(rows, starts + ga._LB_PAD, clip,
                                          win)).to(device),
            budget + 1)
    return ga, args, want


def decode_bound(codes, mask, entries, cap):
    """The bound the kernel computes, read off its packed inputs."""
    codes, mask, entries = (a.numpy() for a in (codes, mask, entries))
    rows, base, cw = entries.astype(np.int64).T
    clip, win = cw & 0xFFFF, cw >> 16
    out = np.zeros(len(rows), np.int64)
    for e in range(len(rows)):
        j = np.arange(win[e])
        c = codes[rows[e], clip[e] + j].astype(np.int64)
        free = (c < 6) & (((mask[base[e] + j] >> np.minimum(c, 5)) & 1) == 1)
        out[e] = min(int((~free).sum()), cap)
    return out


@pytest.mark.parametrize("budget,E", [(2, 600), (0, 300), (7, 300), (2, 1),
                                      (2, 0)])
def test_plain_bound_equals_lb_core(gene, budget, E):
    ga, args, want = bound_case(gene, budget, E, seed=budget * 10 + E)
    assert np.array_equal(decode_bound(*args), want)
    before = proposal_bound.launches
    with pytest.raises(RuntimeError, match="no proposal bound kernel"):
        proposal_bound(*args)
    assert proposal_bound.launches == before
    if E > 100:
        assert set(want.tolist()) == set(range(budget + 2))


@pytest.mark.parametrize("rank", [0, 1])
def test_host_path_entries_equal_the_list_build(gene, rank):
    ga = GeneAligner(gene, device="cpu")
    st = chunk(ga, gene)
    sf, pf, sr, pr, use_rc = st["cand"]
    n_entries = 0
    for i in st["pending"].tolist():
        o_rc = bool(use_rc[i]) != bool(rank)
        cand_p, cand_s = (pr[i], sr[i]) if o_rc else (pf[i], sf[i])
        codes = (st["rc_codes"] if o_rc else st["fwd_codes"])[i]
        m = int(st["lens"][i])
        got = ga._proposal_entries(codes, cand_p, cand_s, m)
        want = proposal_meta(ga, cand_p, cand_s, m)
        assert [(s_, cf, len(sub)) for sub, s_, cf in got] == want
        assert all(bytes(sub) == bytes(codes[cf:cf + len(sub)])
                   for sub, _s, cf in got)
        n_entries += len(want)
    assert n_entries > 100


def test_the_start_table_fills_at_first_sight_and_grows(gene):
    """Rows fill the first time their anchor is seen, anchors past either
    end of the table grow it, and every row is the start closure's."""
    ga = GeneAligner(gene, device="cpu")
    P = len(gene.backbone)
    seen = []
    for anchors in ([5, 100, 300], [P + 40, 12], [-250, 40], [-90, P + 90]):
        starts, counts = ga._start_rows(100, np.array(anchors))
        seen += anchors
        lo, _tab, filled = ga._start_tabs[100]
        assert sorted(np.flatnonzero(filled) + lo) == sorted(set(seen))
        for p, row, c in zip(anchors, starts, counts):
            assert row[:c].tolist() == ga._start_closure(p, 100)
    assert ga._start_tabs[100][0] == -250
