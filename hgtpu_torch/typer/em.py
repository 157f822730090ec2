# Port of hgtpu/typer/em.py: the numpy solver's SQUAREM loop is a copy;
# its input is built from class masks (class_abundance; the dict front
# turns its keys into masks), its two halves under the TRACE stages
# em.build and em.solve; the dense device EM (_em_dense, em_solve_dense)
# runs on torch.
"""EM abundance solver with SQUAREM acceleration.

Faithful port of the reference's single_abundance / next_prob / prob_diff
(hisatgenotype_typing_common.py:1267-1410): read-class EM over
equivalence-class counts, SQUAREM step (Varadhan & Roland 2008, as in
Sailfish), convergence diff < 1e-4, <=1000 iterations, optional length
normalization and low-abundance pruning.

The shipped solver (`single_abundance`) runs vectorized NumPy over a
dense [C, A] class-membership matrix; `em_solve_dense` is its float32
device twin (hgtpu's jitted `_em_dense`), on torch.  The reference's
dict-literal SQUAREM lives in `tests/reference_em.py` as the parity
oracle.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..utils.trace import TRACE


def prob_diff(prob1: dict, prob2: dict) -> float:
    diff = 0.0
    for allele in prob1:
        if allele in prob2:
            diff += abs(prob1[allele] - prob2[allele])
        else:
            diff += prob1[allele]
    return diff


def _single_abundance_np(cmpt_counts: dict, remove_low: bool,
                         lengths: dict):
    """Vectorized float64 re-expression of the dict EM below: same
    initialization, SQUAREM step, pruning schedule, and tie ordering
    (allele first-appearance order; stable sort).  Differences are
    limited to float summation order (<1e-15/step).  The dict's classes
    become masks over its alleles in first-appearance order."""
    with TRACE.stage("em.build"):
        alleles = []
        index = {}
        rows, cols = [], []
        counts = []
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
        M = np.zeros((len(counts), len(alleles)), dtype=bool)
        M[rows, cols] = True
        names = np.empty(len(alleles), dtype=object)
        names[:] = alleles
    return _abundance(M, counts, names, remove_low, lengths)


def class_abundance(level, remove_low: bool = False, lengths: dict = None):
    """single_abundance over a `counting.ClassLevel` (None for a level
    not computed): the classes as masks, columns in name order, so the
    solver's alleles come in the order the level's joined names would
    give them."""
    if not level:
        return []
    TRACE.count("em.stages.masks", 1)
    return _abundance(level.M, level.counts, level.names.sorted_names,
                      remove_low, lengths or {})


def _abundance(M, counts, names, remove_low: bool, lengths: dict):
    """The solver over classes as masks: M bool [C, K], counts [C],
    names [K] the columns' allele names.  The alleles are the columns
    some class holds, ordered by the first class holding each, then by
    column."""
    TRACE.count("em.stages", 1)
    with TRACE.stage("em.build"):
        first = M.argmax(axis=0)
        held = np.flatnonzero(M.any(axis=0))
        order = held[np.argsort(first[held], kind="stable")]
        alleles = names[order].tolist()
        # C order, as the products' summation order depends on it
        M = M.take(order, axis=1).astype(np.float64)
        cnt = np.asarray(counts, dtype=np.float64)
        A = len(alleles)
        use_len = bool(lengths)
        inv_len = (np.array([1.0 / lengths[a] for a in alleles])
                   if use_len else None)
    with TRACE.stage("em.solve"):
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


def single_abundance(cmpt_counts: dict,
                     remove_low_abundance_allele: bool = False,
                     lengths: dict = None):
    """cmpt_counts: {'A1-A2-A3': count} (allele names joined by '-').
    Returns [[allele, prob], ...] sorted by prob desc.

    The shipped solver is the vectorized float64 re-expression; the
    reference-literal dict implementation lives in tests/reference_em.py
    as the parity oracle (tests/test_em.py pins them within 1e-6)."""
    if not cmpt_counts:
        return []
    return _single_abundance_np(cmpt_counts, remove_low_abundance_allele,
                                lengths or {})


# --------------------------------------------------------------------------- #
# Dense device EM
# --------------------------------------------------------------------------- #
def _em_dense(M, counts, inv_len, use_len: bool):
    """M: [C, A] bool membership, counts: [C] f32, inv_len: [A] f32, all
    on one device.  Returns the final prob [A] (float32, on that device).
    SQUAREM with L1 diff < 1e-4 and a 1,000-iteration cap; the loop's
    condition is read on the host each iteration, as lax.while_loop
    evaluates it between iterations."""
    Mf = M.to(torch.float32)
    sizes = Mf.sum(1).clamp(min=1.0)

    def norm(p):
        p_len = p * inv_len if use_len else p
        return p_len / p_len.sum().clamp(min=1e-30)

    def nxt(p):
        denom = Mf @ p                                   # [C]
        w = torch.where(denom > 0, counts / denom.clamp(min=1e-30),
                        torch.zeros_like(denom))
        return norm((Mf.T @ w) * p)

    p = norm(Mf.T @ (counts / sizes))
    diff = torch.ones((), dtype=torch.float32, device=p.device)
    it = 0
    while bool(diff > 1e-4) and it < 1000:
        p1 = nxt(p)
        p2 = nxt(p1)
        r = p1 - p
        v = p2 - p1 - r
        ssv = (v * v).sum()
        gamma = -torch.sqrt((r * r).sum() / ssv.clamp(min=1e-30))
        accel = (p - 2 * gamma * r + gamma * gamma * v).clamp(min=0.0)
        p_new = torch.where(ssv > 0.0, nxt(accel), p1)
        diff = (p_new - p).abs().sum()
        p = p_new
        it += 1
    return norm(p)


def em_solve_dense(membership: np.ndarray, counts: np.ndarray,
                   lengths: np.ndarray = None, device=None):
    """Dense EM: membership [C, A] bool, counts [C].  Returns prob [A]
    (numpy float32), computed on `device` (default: the card when there
    is one)."""
    dev = resolve_device(device)
    A = membership.shape[1]
    if lengths is None:
        inv_len = np.ones(A, np.float32)
        use_len = False
    else:
        inv_len = (1.0 / np.asarray(lengths, np.float64)).astype(np.float32)
        use_len = True

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    return _em_dense(t(membership, bool), t(counts, np.float32),
                     t(inv_len, np.float32), use_len).cpu().numpy()
