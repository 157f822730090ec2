# Port of hgtpu/typer/staging.py: expansion_winners is a copy; the staged
# EM takes each level's classes as masks (counting.ClassLevel) where
# hgtpu takes {'A1-A2': count} dicts, and gives the same probabilities.
"""Hierarchical EM staging policy — the ONE home of the
exon-representative -> group-expansion -> full-length abundance
hierarchy (ref: hisatgenotype_typing_core.py:1679-1789).

Three call sites share this module so the expansion constants and the
selection rule exist exactly once (VERDICT r3 item 6):

- the host engine (`typer/engine.type_gene`),
- the device production path (`parallel/production`), which merges
  device class counts with host-rescued reads and then runs the same
  staged EM on the merged classes,
- the pure-device sharded program (`parallel/e2e.ShardedTyper`), whose
  on-device EM consumes `expansion_winners` over its exon-stage
  abundance vector.
"""
from __future__ import annotations

from ..utils.trace import TRACE
from .em import class_abundance

# exon-stage winners are scanned in rank order; expansion stops at the
# first allele past rank EXPANSION_TOP_RANK whose abundance falls below
# EXPANSION_MIN_PROB (ref: typing_core.py:1750-1752 "rank_i >= 10 and
# prob < 0.03")
EXPANSION_TOP_RANK = 10
EXPANSION_MIN_PROB = 0.03


def expansion_winners(ranked, rep_groups):
    """Select the representative groups to expand into the full-length
    EM stage.

    ranked: iterable of (allele_index, prob) in descending-probability
    order (ties already broken by the caller's stable sort).
    rep_groups: {rep allele index: [member allele indices]}.

    Returns (set of member allele indices, summed probability of the
    expanded representatives).  Only groups with more than one member
    expand — a singleton representative IS its group and needs no
    full-length disambiguation (ref: typing_core.py:1750-1765).
    """
    sel = set()
    prob_sum = 0.0
    for prob_i, (idx, p) in enumerate(ranked):
        if prob_i >= EXPANSION_TOP_RANK and p < EXPANSION_MIN_PROB:
            break
        group = rep_groups.get(idx)
        if not group or len(group) <= 1:
            continue
        prob_sum += p
        sel.update(group)
    return sel, prob_sum


def class_levels(*stats):
    """Each StatAccumulator's classes (None for a level not computed)
    and their {'A1-A2': count} dicts ({} for none), for the staged EM
    and the result."""
    with TRACE.stage("em.build"):
        levels = [None if st is None else st.classes() for st in stats]
        return levels, [{} if lv is None else lv.cmpt() for lv in levels]


def _restrict(level, alleles):
    with TRACE.stage("em.build"):
        return level and level.restrict(alleles)


def staged_abundance(gene, opts, full, exon, primary,
                     rep_groups, primary_rep_groups, lengths):
    """Full hierarchical abundance over the three class levels.

    gene: GeneRef; opts: TypingOptions; full, exon, primary: the
    classes (`counting.ClassLevel`, or None for a level not computed)
    at full / exon / primary-exon projection levels; *_rep_groups:
    {rep allele index: [member indices]}.  Returns [[allele, prob], ...]
    descending — exactly the reference's hierarchy: (optional)
    primary-exon stage, exon-representative stage, expansion of winning
    groups, full-length length-normalized stage restricted to the
    expanded set (typing_core.py:1679-1789).
    """
    if opts.family != "hla":
        if len(full) <= 1:
            return [[next(iter(full.cmpt())), 1.0]] if full else []
        return class_abundance(full)

    name2idx = full.names.index

    if opts.type_primary_exons and primary:
        # stage 0 (ref: the type_primary_exons branch,
        # typing_core.py:1684-1730): primary-exon reps first, then
        # expand winning groups into the exon-level EM
        primary_prob = class_abundance(primary)
        px = set()
        px_sum = 0.0
        for allele, prob in primary_prob:
            group = primary_rep_groups.get(name2idx[allele], [])
            if len(group) <= 1:
                continue
            px_sum += prob
            px.update(group)
        if px:
            sub = class_abundance(_restrict(exon, px),
                                  opts.remove_low_abundance_alleles)
            px_alleles = {gene.allele_names[i] for i in px}
            merged = {a: p for a, p in primary_prob
                      if a not in px_alleles}
            for a, p in sub:
                merged[a] = p * px_sum
            exon_prob = sorted(([a, p] for a, p in merged.items()),
                               key=lambda x: x[1], reverse=True)
        else:
            exon_prob = primary_prob
    else:
        exon_prob = class_abundance(exon,
                                    opts.remove_low_abundance_alleles)

    sel, exon_prob_sum = expansion_winners(
        ((name2idx[a], p) for a, p in exon_prob), rep_groups)

    if sel:
        # full-length stage always prunes in the reference
        # (typing_core.py:1767-1769) — unless the user kept low-
        # abundance alleles explicitly
        full_prob = class_abundance(
            _restrict(full, sel), opts.remove_low_abundance_alleles,
            lengths)
        exon_alleles = {gene.allele_names[i] for i in sel}
        combined = {a: p for a, p in exon_prob if a not in exon_alleles}
        for a, p in full_prob:
            combined[a] = p * exon_prob_sum
        return sorted(([a, p] for a, p in combined.items()),
                      key=lambda x: x[1], reverse=True)
    return exon_prob
