"""The port's production passes equal hgtpu's, one pass at a time.

On the indel gene (dense catalog indels, insertions spelled on the
device), paired and single-end, at 0 % and 5 % per-base error, hgtpu's
jitted programs on a 1-device mesh and the port's torch callables take
the same inputs and must return the same arrays, buffer for buffer and
state for state:

  place  _place_pairs_p / _place_single_p (K1's plain version here)
  spell  _spell_pairs_t[t] / _spell_single_t[t] for every tier t, and
         _spell_fused[m]
  count  _count_multi[(m, T)] for one tier (fused) and three tiers,
         against the device pileup and against a constructed pileup
         whose positions carry several representative bases

uint32 words compare through the port's int32 bit patterns.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hgtpu.db import build_gene_ref
from hgtpu.db.catalog import VT_DELETION, VT_INSERTION, VT_SINGLE
from hgtpu.parallel.e2e import ShardedTyper as JaxTyper
from hgtpu.parallel.sharded import make_mesh
from hgtpu.sim import simulate_reads
from hgtpu_torch.parallel.e2e import ShardedTyper
from tests.synth import make_gene_msa
from tests.test_torch_db import carried
from tests.test_torch_e2e_tables import as_numpy
from tests.torch_threads import _torch_threads  # noqa: F401

ERRS = (0.0, 5.0)     # per-base error, in percent (the simulator's unit)


@pytest.fixture(scope="module")
def indel_ref():
    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=8.0)
    return ref


def truths(ref):
    d = ref.var_type == VT_DELETION
    i = ref.var_type == VT_INSERTION
    snp = ref.var_type == VT_SINGLE
    t_indel = next(n for a, n in enumerate(ref.allele_names)
                   if ref.links[d, a].any() and ref.links[i, a].any())
    t_snp = next(n for a, n in enumerate(ref.allele_names)
                 if ref.links[snp, a].any() and n != t_indel)
    return [t_indel, t_snp]


@pytest.fixture(scope="module")
def typers(indel_ref):
    return (JaxTyper(indel_ref, make_mesh(1)),
            ShardedTyper(carried(indel_ref), "cpu"))


@pytest.fixture(scope="module")
def mates(indel_ref, typers):
    """{err: (r1 codes, r2 codes)}, padded as count_classes pads them."""
    st = typers[1]
    out = {}
    for err in ERRS:
        r1, r2, _ = simulate_reads(indel_ref, truths(indel_ref),
                                   simulate_interval=4, read_len=100,
                                   frag_len=250, seed=11,
                                   perbase_errorrate=err)
        out[err] = tuple(st._pad(st.encode([r.seq for r in r]), True)
                         for r in (r1, r2))
    return out


def same(j, t, what):
    """hgtpu's output (a jax array or a tuple of them) equals the port's,
    dtype and values."""
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t), what
        for k, (a, b) in enumerate(zip(j, t)):
            same(a, b, "%s[%d]" % (what, k))
        return
    a = np.asarray(j)
    b = as_numpy(t, a)
    assert b.dtype == a.dtype, (what, b.dtype, a.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


class Runs:
    """Both implementations' pass outputs, computed once per module."""

    def __init__(self, typers, mates):
        self.jt, self.tt = typers
        self.mates = mates
        self.cache = {}

    def args(self, err, paired):
        c1, c2 = self.mates[err]
        cs = (c1, c2) if paired else (c1,)
        return ([jnp.asarray(c) for c in cs],
                [torch.from_numpy(c) for c in cs])

    def run(self, key, jfn, tfn, jargs, targs):
        if key not in self.cache:
            self.cache[key] = (jfn(*self.jt._tables, *jargs),
                               tfn(*self.tt._tables, *targs))
        return self.cache[key]

    def place(self, err, paired):
        ja, ta = self.args(err, paired)
        name = "_place_pairs_p" if paired else "_place_single_p"
        return self.run(("place", err, paired), getattr(self.jt, name),
                        getattr(self.tt, name), ja, ta)

    def spell(self, err, paired, tier):
        ja, ta = self.args(err, paired)
        m = 2 if paired else 1
        if tier == "fused":
            return self.run(("spell", err, paired, tier),
                            self.jt._spell_fused[m],
                            self.tt._spell_fused[m], ja, ta)
        pl = np.asarray(self.place(err, paired)[0])
        cols = (0, 1, 2, 4, 5, 6) if paired else (0, 1, 2)
        ja += [jnp.asarray(pl[:, c]) for c in cols]
        ta += [torch.from_numpy(pl[:, c].copy()) for c in cols]
        name = "_spell_pairs_t" if paired else "_spell_single_t"
        return self.run(("spell", err, paired, tier),
                        getattr(self.jt, name)[tier],
                        getattr(self.tt, name)[tier], ja, ta)


@pytest.fixture(scope="module")
def runs(typers, mates):
    return Runs(typers, mates)


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("err", ERRS)
def test_place_pass_equals_hgtpu(runs, err, paired):
    j, t = runs.place(err, paired)
    same(j, t, "place")
    assert t.shape[1] == (8 if paired else 4)


@pytest.mark.parametrize("tier", [0, 1, 2, "fused"])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("err", ERRS)
def test_spell_pass_equals_hgtpu(runs, err, paired, tier):
    j, t = runs.spell(err, paired, tier)
    m = 2 if paired else 1
    assert len(t) == 1 + runs.tt._NSTATE[m]
    same(j, t, "spell")


def _rich_pileup(P_bb, seed):
    """A pileup where many positions carry two or three representative
    bases (ties for the first-true argmax) and deletion columns of every
    weight."""
    rng = np.random.default_rng(seed)
    pile = rng.integers(0, 40, (P_bb, 6)).astype(np.int32)
    pile[rng.random(P_bb) < 0.3, :4] = 30
    return pile.reshape(-1)


@pytest.mark.parametrize("pileup", ["device", "constructed"])
@pytest.mark.parametrize("tiers", ["fused", "three"])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("err", ERRS)
def test_count_pass_equals_hgtpu(runs, err, paired, tiers, pileup):
    m = 2 if paired else 1
    ts = ["fused"] if tiers == "fused" else [0, 1, 2]
    outs = [runs.spell(err, paired, t) for t in ts]
    if pileup == "device":
        P6 = runs.tt.P_bb * 6
        pile = sum(np.asarray(j[0])[:P6].astype(np.int64)
                   for j, _t in outs).astype(np.int32)
    else:
        pile = _rich_pileup(runs.tt.P_bb, seed=int(err) + m)
    jstate = [a for j, _t in outs for a in j[1:]]
    tstate = [a for _j, t in outs for a in t[1:]]
    j = runs.jt._count_multi[(m, len(ts))](
        *runs.jt._tables, jnp.asarray(pile), *jstate)
    t = runs.tt._count_multi[(m, len(ts))](
        *runs.tt._tables, torch.from_numpy(pile), *tstate)
    same(j, t, "count")


def test_combine_bufs_equals_hgtpu(runs):
    outs = [runs.spell(5.0, True, t) for t in (0, 1, 2)]
    same(runs.jt._combine_bufs(*[j[0] for j, _t in outs]),
         runs.tt._combine_bufs(*[t[0] for _j, t in outs]), "combine")


# ---- traps of the translation, each on a constructed input ---- #

def test_top2_tie_order_and_sentinel():
    """lax.top_k puts the lowest column first among equal scores; the
    port's key must agree, and -1 (invalid hypothesis) must rank below
    every real score, 0 included."""
    import jax

    rng = np.random.default_rng(0)
    score = rng.integers(-1, 4, (500, 27)).astype(np.float32)
    score[:, 0] = np.maximum(score[:, 0], 0)        # straight is valid
    score[:3] = [[2, 5, 5] + [-1] * 24, [0] + [-1] * 26,
                 [0, 0] + [-1] * 25]
    from hgtpu_torch.parallel.e2e import _top2

    tv, ti = _top2(torch.from_numpy(score))
    jv, ji = jax.lax.top_k(jnp.asarray(score), 2)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [1, 2] and ti[1].tolist() == [0, 1]


def test_k_smallest_ascending():
    import jax

    from hgtpu_torch.parallel.e2e import _k_smallest

    rng = np.random.default_rng(1)
    x = rng.integers(0, 40, (300, 102)).astype(np.int32)
    x[:, 50:] = 39                                   # many equal values
    want = -jax.lax.top_k(-jnp.asarray(x), 24)[0]
    assert np.array_equal(_k_smallest(torch.from_numpy(x), 24).numpy(),
                          np.asarray(want))


def test_uint32_words_with_the_top_bit_set():
    """Winner words (bit 31 from the causes, span << 2 wrapping mod
    2**32), bit-packed masks with bit 31 set, and the class hash, against
    numpy's uint32 arithmetic."""
    from hgtpu_torch.parallel.e2e import _bitpack, _mul32, _winner_word

    rng = np.random.default_rng(2)
    n = 77
    causes = rng.integers(0, 16, n)
    causes[:4] = 15
    l = rng.integers(-5, 1 << 30, n)
    l[:3] = (1 << 30, -1, (1 << 30) - 1)
    use_r = rng.random(n) < 0.5
    tier1 = rng.random(n) < 0.5
    want = ((causes.astype(np.uint32) << np.uint32(28))
            | (np.maximum(l, 0).astype(np.uint32) << np.uint32(2))
            | (use_r.astype(np.uint32) << np.uint32(1))
            | tier1.astype(np.uint32))
    got = _winner_word(torch.from_numpy(causes), torch.from_numpy(l),
                       torch.from_numpy(use_r), torch.from_numpy(tier1))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)

    m = rng.random(n) < 0.5
    m[31] = m[63] = True
    pad = np.zeros(96, np.uint32)
    pad[:n] = m
    want = (pad.reshape(3, 32) << np.arange(32, dtype=np.uint32)).sum(
        1, dtype=np.uint32)
    got = _bitpack(torch.from_numpy(m), n).numpy().view(np.uint32)
    assert np.array_equal(got, want) and (want[:2] >> 31).all()

    rows = rng.integers(0, 2**32, (50, 7), dtype=np.uint64).astype(np.uint32)
    mixer = (np.arange(7, dtype=np.uint32) * np.uint32(0x9E3779B9)
             + np.uint32(0x85EBCA77))
    h = (rows * mixer[None, :]).sum(1, dtype=np.uint32)
    want = (h ^ (h >> np.uint32(15))) * np.uint32(0x2C1B3C6D)
    r = torch.from_numpy(rows.astype(np.int64))
    mx = torch.from_numpy(mixer.astype(np.int64))
    ht = _mul32(r, mx[None, :]).sum(1) & 0xFFFFFFFF
    got = _mul32(ht ^ (ht >> 15), torch.tensor(0x2C1B3C6D))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("cap", [1, 8, 40, 64])
def test_first_rows_is_static_size_nonzero(cap):
    from hgtpu_torch.parallel.e2e import _first_rows

    rng = np.random.default_rng(cap)
    m = rng.random(64) < 0.3
    want = jnp.nonzero(jnp.asarray(m), size=cap, fill_value=64)[0]
    assert np.array_equal(_first_rows(torch.from_numpy(m), cap).numpy(),
                          np.asarray(want))


def test_floor_log2_exact_at_powers_of_two():
    from hgtpu_torch.parallel.e2e import _floor_log2

    x = np.unique(np.concatenate([2 ** np.arange(15), 2 ** np.arange(15) - 1,
                                  2 ** np.arange(15) + 1, [3, 5, 100]]))
    x = x[x >= 1].astype(np.int32)
    got = _floor_log2(torch.from_numpy(x), 16).numpy()
    want = np.array([int(v).bit_length() - 1 for v in x])
    assert np.array_equal(got, want)


def test_row_take_equals_the_shift_sweep():
    """One gather along a fetched row equals hgtpu's static-shift select
    sweep, out-of-sweep offsets keeping the sweep's initial value."""
    from hgtpu_torch.parallel.e2e import _row_take

    rng = np.random.default_rng(4)
    lo, hi, W = 3, 6, 10
    rows = rng.integers(0, 100, (20, W + lo + hi + 1)).astype(np.int32)
    off = rng.integers(-lo - 2, hi + 3, (20, W)).astype(np.int32)
    j = np.arange(W, dtype=np.int32)[None, :]
    want = np.full((20, W), -7, np.int32)
    for o in range(-lo, hi + 1):
        want = np.where(off == o, rows[:, lo + o:lo + o + W], want)
    got = _row_take(torch.from_numpy(rows), torch.from_numpy(off),
                    torch.from_numpy(j), lo, hi, -7)
    assert np.array_equal(got.numpy(), want)
