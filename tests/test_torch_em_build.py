"""The staged EM fed allele masks equals the string route.

The port hands the staged EM each class level as a mask matrix
(`StatAccumulator.classes()`, a `counting.ClassLevel`) and makes names
only for the result's dicts.  The oracle below is the string route:
every class joined into its sorted allele names (`oracle_cmpt_names`),
restricted by splitting the names again (`oracle_restrict`), and split
a third time into the solver's dense matrix (`oracle_abundance`), under
the dict form of the staged hierarchy (`oracle_staged`).  Both must
agree exactly: dict keys, order and counts, and every probability.
"""
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from hgtpu_torch.typer.counting import StatAccumulator, name_order
from hgtpu_torch.typer.em import single_abundance
from hgtpu_torch.typer.staging import (class_levels, expansion_winners,
                                       staged_abundance)
from hgtpu_torch.utils.trace import TRACE
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the oracle: the classes as joined names ---- #

def oracle_cmpt_names(acc):
    out = {}
    for key, cnt in acc.cmpt.items():
        names = sorted(acc.allele_names[i]
                       for i in np.flatnonzero(acc.cmpt_mask[key]))
        out["-".join(names)] = out.get("-".join(names), 0) + cnt
    return out


def oracle_restrict(cmpt, alleles):
    out = {}
    for cls, value in cmpt.items():
        kept = [a for a in cls.split("-") if a in alleles]
        if kept:
            k = "-".join(kept)
            out[k] = out.get(k, 0) + value
    return out


def oracle_abundance(cmpt_counts, remove_low=False, lengths=None):
    if not cmpt_counts:
        return []
    alleles, index, rows, cols, counts = [], {}, [], [], []
    for ci, (cmpt, count) in enumerate(cmpt_counts.items()):
        for a in cmpt.split("-"):
            i = index.get(a)
            if i is None:
                i = len(alleles)
                index[a] = i
                alleles.append(a)
            rows.append(ci)
            cols.append(i)
        counts.append(float(count))
    A, C = len(alleles), len(counts)
    M = np.zeros((C, A), dtype=np.float64)
    M[rows, cols] = 1.0
    cnt = np.asarray(counts)
    use_len = bool(lengths)
    inv_len = (np.array([1.0 / lengths[a] for a in alleles])
               if use_len else None)

    def norm(p):
        if use_len:
            p = p * inv_len
        return p / p.sum()

    def nxt_of(p):
        denom = M @ p
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.where(denom > 0.0,
                         cnt / np.where(denom > 0.0, denom, 1.0), 0.0)
        return norm((M.T @ w) * p)

    active = np.ones(A, dtype=bool)
    p = norm(M.T @ (cnt / M.sum(axis=1)))
    diff, it = 1.0, 0
    while diff > 0.0001 and it < 1000:
        n1 = nxt_of(p)
        n2 = nxt_of(n1)
        r = n1 - p
        v = n2 - n1 - r
        ssv = float(v @ v)
        if ssv > 0.0:
            gamma = -math.sqrt(float(r @ r) / ssv)
            accel = np.maximum(0.0, p - 2 * gamma * r + gamma * gamma * v)
            n1 = nxt_of(accel)
        diff = float(np.abs(p - n1).sum())
        p = n1
        if it >= 10 and remove_low and p.any():
            active &= p >= p.max() / 10.0
            p = np.where(active, p, 0.0)
        it += 1
    if remove_low and p.any():
        active &= p >= p.max() / 10.0
        p = np.where(active, p, 0.0)
    p = norm(p)
    out = [[alleles[i], float(p[i])] for i in np.flatnonzero(active)]
    out.sort(key=lambda x: x[1], reverse=True)
    return out


def oracle_staged(gene, opts, full_cmpt, exon_cmpt, primary_cmpt,
                  rep_groups, primary_rep_groups, lengths):
    if opts.family != "hla":
        if len(full_cmpt) <= 1:
            return [[list(full_cmpt.keys())[0], 1.0]] if full_cmpt else []
        return oracle_abundance(full_cmpt)
    name2idx = {n: i for i, n in enumerate(gene.allele_names)}
    if opts.type_primary_exons and primary_cmpt:
        primary_prob = oracle_abundance(primary_cmpt)
        px_alleles = set()
        px_sum = 0.0
        for allele, prob in primary_prob:
            group = primary_rep_groups.get(name2idx[allele], [])
            if len(group) <= 1:
                continue
            px_sum += prob
            px_alleles |= {gene.allele_names[i] for i in group}
        if px_alleles:
            sub = oracle_abundance(oracle_restrict(exon_cmpt, px_alleles),
                                   opts.remove_low_abundance_alleles)
            merged = {a: p for a, p in primary_prob if a not in px_alleles}
            for a, p in sub:
                merged[a] = p * px_sum
            exon_prob = sorted(([a, p] for a, p in merged.items()),
                               key=lambda x: x[1], reverse=True)
        else:
            exon_prob = primary_prob
    else:
        exon_prob = oracle_abundance(exon_cmpt,
                                     opts.remove_low_abundance_alleles)
    sel, exon_prob_sum = expansion_winners(
        ((name2idx[a], p) for a, p in exon_prob), rep_groups)
    exon_alleles = {gene.allele_names[i] for i in sel}
    if exon_alleles:
        full_prob = oracle_abundance(
            oracle_restrict(full_cmpt, exon_alleles),
            opts.remove_low_abundance_alleles, lengths)
        combined = {a: p for a, p in exon_prob if a not in exon_alleles}
        for a, p in full_prob:
            combined[a] = p * exon_prob_sum
        return sorted(([a, p] for a, p in combined.items()),
                      key=lambda x: x[1], reverse=True)
    return exon_prob


# ---- random accumulators ---- #

def random_names(rng, A):
    """Allele names whose sorted order is not their index order: first
    fields without zero padding ('A*10' sorts before 'A*2')."""
    names = ["A*%d:%02d" % (1 + i // 7, i % 7 * 3) for i in range(A)]
    return [names[i] for i in rng.permutation(A)]


def random_rows(rng, A, G):
    """Per-read compatibility counts [G, A] whose classes include
    one-allele, all-allele and uniform (all-zero) rows, with repeats."""
    mat = np.zeros((G, A), dtype=np.int32)
    for g in range(G):
        kind = rng.integers(0, 6)
        if kind == 0:
            mat[g, rng.integers(0, A)] = 2
        elif kind == 1:
            mat[g] = 1
        elif kind == 2:
            pass                            # max 0: the uniform class
        else:
            k = int(rng.integers(1, A))
            mat[g, rng.choice(A, k, replace=False)] = 1 + rng.integers(0, 2)
    reps = rng.integers(0, G, G // 3)
    mat[rng.integers(0, G, len(reps))] = mat[reps]
    return mat


def packed_rows(acc, mat, weights):
    """add_packed_batch's inputs for the rows add_reads_batch would take:
    the class rows bit-packed (bit b of word w is allele w*32+b) and the
    weighted per-allele totals."""
    mx = mat[:, acc.include].max(axis=1)
    cur = (mat == mx[:, None]) & acc.include
    W = (acc.A + 31) // 32
    bits = np.zeros((len(mat), W * 32), dtype=np.uint64)
    bits[:, :acc.A] = cur
    words = (bits.reshape(len(mat), W, 32)
             << np.arange(32, dtype=np.uint64)).sum(axis=2)
    totals = (cur * weights[:, None]).sum(axis=0)
    return words.astype(np.uint32), weights, totals


def random_accumulator(rng, names, how, include=None):
    acc = StatAccumulator(names, include)
    for _ in range(3):
        mat = random_rows(rng, len(names), int(rng.integers(5, 40)))
        weights = rng.integers(1, 9, len(mat)).astype(np.int64)
        use = how if how != "both" else ("reads", "packed")[
            int(rng.integers(0, 2))]
        if use == "reads":
            acc.add_reads_batch(mat, weights)
        else:
            acc.add_packed_batch(*packed_rows(acc, mat, weights))
    return acc


HOWS = ["reads", "packed", "both"]


# ---- (a) the result's dicts ---- #

@pytest.mark.parametrize("how", HOWS)
def test_class_names_from_masks_equal_the_joined_names(how):
    rng = np.random.default_rng(25)
    for trial in range(8):
        A = int(rng.integers(1, 90))
        names = random_names(rng, A)
        include = None if trial % 2 else rng.random(A) < 0.5
        if include is not None and not include.any():
            include[0] = True
        acc = random_accumulator(rng, names, how, include)
        want = oracle_cmpt_names(acc)
        got = acc.classes().cmpt()
        assert list(got.items()) == list(want.items()), trial
        assert all(type(v) is int for v in got.values())


def test_name_order_is_sorted_order():
    rng = np.random.default_rng(3)
    names = random_names(rng, 50)
    no = name_order(names)
    assert no.sorted_names.tolist() == sorted(names)
    assert [names[i] for i in no.order] == sorted(names)
    assert (no.order[no.rank] == np.arange(50)).all()
    assert name_order(list(names)) is no


def test_no_classes_give_an_empty_level():
    acc = StatAccumulator(["B*01", "A*02"])
    level = acc.classes()
    assert len(level) == 0 and level.cmpt() == {}


# ---- (b) the restriction ---- #

@pytest.mark.parametrize("how", HOWS)
def test_restriction_by_columns_equals_the_split_names(how):
    rng = np.random.default_rng(26)
    for trial in range(8):
        A = int(rng.integers(2, 90))
        names = random_names(rng, A)
        acc = random_accumulator(rng, names, how)
        level = acc.classes()
        cmpt = oracle_cmpt_names(acc)
        for k in (1, A // 4 + 1, A // 2, A):
            keep = set(rng.choice(A, k, replace=False).tolist())
            want = oracle_restrict(cmpt, {names[i] for i in keep})
            got = level.restrict(keep)
            assert list(got.cmpt().items()) == list(want.items()), (trial, k)
            assert len(got) == len(want)


def test_restriction_to_alleles_in_no_class_is_empty():
    names = ["A*2:01", "A*10:01", "A*1:01", "A*3:01"]
    acc = StatAccumulator(names)
    mat = np.array([[1, 1, 0, 0], [0, 1, 0, 0]], dtype=np.int32)
    acc.add_reads_batch(mat, np.array([3, 4]))
    level = acc.classes()
    assert level.cmpt() == {"A*10:01-A*2:01": 3, "A*10:01": 4}
    for keep in (set(), {2, 3}):
        got = level.restrict(keep)
        assert len(got) == 0 and got.cmpt() == {}
        assert oracle_restrict(level.cmpt(), {names[i] for i in keep}) == {}
    assert level.restrict({0}).cmpt() == {"A*2:01": 3}
    assert level.restrict({1}).cmpt() == {"A*10:01": 7}


# ---- (c) the staged EM ---- #

def staged_case(rng, A=72):
    """A gene of A alleles in groups of 1-8 (rep first), exon reps in
    primary groups, and one sample's three accumulators."""
    names = random_names(rng, A)
    perm = rng.permutation(A).tolist()
    rep_groups = {}
    while perm:
        k = int(rng.integers(1, 9))
        group, perm = perm[:k], perm[k:]
        rep_groups[group[0]] = sorted(group)
    reps = list(rep_groups)
    rng.shuffle(reps)
    primary_groups = {}
    while reps:
        k = int(rng.integers(1, 5))
        group, reps = reps[:k], reps[k:]
        primary_groups[group[0]] = sorted(group)
    rep_mask = np.zeros(A, bool)
    rep_mask[list(rep_groups)] = True
    primary_mask = np.zeros(A, bool)
    primary_mask[list(primary_groups)] = True
    how = HOWS[int(rng.integers(0, 3))]
    accs = (random_accumulator(rng, names, how),
            random_accumulator(rng, names, how, rep_mask),
            random_accumulator(rng, names, how, primary_mask))
    lengths = {n: int(x) for n, x in
               zip(names, rng.integers(800, 1200, A))}
    return (SimpleNamespace(allele_names=names), accs, rep_groups,
            primary_groups, lengths)


@pytest.mark.parametrize("primary", [False, True])
@pytest.mark.parametrize("remove_low", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_staged_abundance_from_masks_equals_the_string_route(
        primary, remove_low, with_lengths):
    rng = np.random.default_rng(int(primary) + 2 * int(remove_low)
                                + 4 * int(with_lengths))
    opts = SimpleNamespace(family="hla", type_primary_exons=primary,
                           remove_low_abundance_alleles=remove_low)
    expanded = 0
    for trial in range(6):
        gene, accs, groups, pgroups, lengths = staged_case(rng)
        lengths = lengths if with_lengths else {}
        levels, dicts = class_levels(*accs)
        assert [list(d.items()) for d in dicts] == \
            [list(oracle_cmpt_names(a).items()) for a in accs]
        want = oracle_staged(gene, opts, *dicts, groups, pgroups, lengths)
        before = TRACE.counters().get("em.stages", 0)
        got = staged_abundance(gene, opts, *levels, groups, pgroups, lengths)
        assert got == want, trial
        expanded += TRACE.counters()["em.stages"] - before >= 2 + primary
    assert expanded                        # the expanded stages ran


def test_staged_abundance_with_levels_not_computed():
    rng = np.random.default_rng(8)
    gene, accs, groups, pgroups, lengths = staged_case(rng)
    opts = SimpleNamespace(family="hla", type_primary_exons=True,
                           remove_low_abundance_alleles=True)
    levels, dicts = class_levels(accs[0], None, None)
    assert dicts[1:] == [{}, {}] and levels[1:] == [None, None]
    assert staged_abundance(gene, opts, *levels, groups, pgroups,
                            lengths) == []
    assert oracle_staged(gene, opts, *dicts, groups, pgroups, lengths) == []


@pytest.mark.parametrize("n_classes", [0, 1, 5])
def test_other_families_take_the_full_level(n_classes):
    rng = np.random.default_rng(9)
    names = random_names(rng, 30)
    acc = StatAccumulator(names)
    while len(acc.cmpt) < n_classes:
        acc.add_reads_batch(random_rows(rng, 30, 1),
                            np.array([int(rng.integers(1, 9))]))
    opts = SimpleNamespace(family="cyp", type_primary_exons=False,
                           remove_low_abundance_alleles=False)
    gene = SimpleNamespace(allele_names=names)
    (level,), (cmpt,) = class_levels(acc)
    got = staged_abundance(gene, opts, level, None, None, {}, {}, {})
    assert got == oracle_staged(gene, opts, cmpt, {}, {}, {}, {}, {})
    assert len(got) >= (n_classes > 0)


def test_the_dict_front_equals_the_string_route():
    """single_abundance (linear typing's entry) on keys in no sorted
    order: the solver keeps their first-appearance order."""
    rng = np.random.default_rng(10)
    for trial in range(6):
        names = random_names(rng, 40)
        cmpt = {}
        for _ in range(25):
            k = int(rng.integers(1, 12))
            key = "-".join(names[i] for i in rng.choice(40, k, replace=False))
            cmpt[key] = cmpt.get(key, 0) + int(rng.integers(1, 50))
        lengths = {n: float(x) for n, x in
                   zip(names, rng.integers(800, 1200, 40))}
        for remove_low, ld in ((False, None), (True, None), (True, lengths)):
            assert single_abundance(cmpt, remove_low, ld) == \
                oracle_abundance(cmpt, remove_low, ld), trial


# ---- (d) the counters ---- #

@pytest.fixture(scope="module")
def sample():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_gene_msa
    from hgtpu_torch.db import build_gene_ref
    from hgtpu_torch.sim import simulate_reads

    spec = make_gene_msa(seed=3)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"],
                            exons_ref_coords=spec["exons"],
                            min_var_freq=0.1)
    r1, r2, _ = simulate_reads(ref, [ref.allele_names[7],
                                     ref.allele_names[3]],
                               simulate_interval=6)
    return (ref, [(r.name, r.seq) for r in r1],
            [(r.name, r.seq) for r in r2])


@pytest.mark.parametrize("device_typing", ["off", "on"])
def test_every_solver_stage_of_a_typing_call_takes_masks(sample,
                                                         device_typing):
    from hgtpu_torch.pipeline import type_reads
    from hgtpu_torch.typer import TypingOptions

    ref, r1, r2 = sample
    t0 = time.perf_counter()
    res = type_reads(ref, r1, r2, TypingOptions(device_typing=device_typing),
                     device="cpu")
    (call,) = TRACE.calls(t0, time.perf_counter())
    got = call["counters"]
    assert res.prob and got["em.stages"] >= 1
    assert got["em.stages.masks"] == got["em.stages"]
    assert "em.build" in call["stages"]
