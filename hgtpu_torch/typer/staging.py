# Copy of hgtpu/typer/staging.py; the imports and restrict_cmpt's TRACE
# stage differ.
"""Hierarchical EM staging policy — the ONE home of the
exon-representative -> group-expansion -> full-length abundance
hierarchy (ref: hisatgenotype_typing_core.py:1679-1789).

Three call sites share this module so the expansion constants and the
selection rule exist exactly once (VERDICT r3 item 6):

- the host engine (`typer/engine.type_gene`),
- the device production path (`parallel/production`), which merges
  device class counts with host-rescued reads and then runs the same
  staged EM on the merged cmpt dicts,
- the pure-device sharded program (`parallel/e2e.ShardedTyper`), whose
  on-device EM consumes `expansion_winners` over its exon-stage
  abundance vector.
"""
from __future__ import annotations

from ..utils.trace import TRACE
from .em import single_abundance

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


def restrict_cmpt(cmpt, alleles):
    """Project a class-count dict onto an allele subset (the reference
    re-keys Gene_cmpt rows onto the expanded set before the full-length
    EM, typing_core.py:1767-1780)."""
    out = {}
    with TRACE.stage("em.build"):
        for cls, value in cmpt.items():
            kept = [a for a in cls.split("-") if a in alleles]
            if kept:
                k = "-".join(kept)
                out[k] = out.get(k, 0) + value
    return out


def staged_abundance(gene, opts, full_cmpt, exon_cmpt, primary_cmpt,
                     rep_groups, primary_rep_groups, lengths):
    """Full hierarchical abundance over the three cmpt levels.

    gene: GeneRef; opts: TypingOptions; *_cmpt: {'A1-A2': count} class
    dicts at full / exon / primary-exon projection levels; *_rep_groups:
    {rep allele index: [member indices]}.  Returns [[allele, prob], ...]
    descending — exactly the reference's hierarchy: (optional)
    primary-exon stage, exon-representative stage, expansion of winning
    groups, full-length length-normalized stage restricted to the
    expanded set (typing_core.py:1679-1789).
    """
    if opts.family != "hla":
        if len(full_cmpt) <= 1:
            return [[list(full_cmpt.keys())[0], 1.0]] if full_cmpt else []
        return single_abundance(full_cmpt)

    name2idx = {n: i for i, n in enumerate(gene.allele_names)}

    if opts.type_primary_exons and primary_cmpt:
        # stage 0 (ref: the type_primary_exons branch,
        # typing_core.py:1684-1730): primary-exon reps first, then
        # expand winning groups into the exon-level EM
        primary_prob = single_abundance(primary_cmpt)
        px_alleles = set()
        px_sum = 0.0
        for allele, prob in primary_prob:
            group = primary_rep_groups.get(name2idx[allele], [])
            if len(group) <= 1:
                continue
            px_sum += prob
            px_alleles |= {gene.allele_names[i] for i in group}
        if px_alleles:
            sub = single_abundance(
                restrict_cmpt(exon_cmpt, px_alleles),
                opts.remove_low_abundance_alleles)
            merged = {a: p for a, p in primary_prob
                      if a not in px_alleles}
            for a, p in sub:
                merged[a] = p * px_sum
            exon_prob = sorted(([a, p] for a, p in merged.items()),
                               key=lambda x: x[1], reverse=True)
        else:
            exon_prob = primary_prob
    else:
        exon_prob = single_abundance(exon_cmpt,
                                     opts.remove_low_abundance_alleles)

    sel, exon_prob_sum = expansion_winners(
        ((name2idx[a], p) for a, p in exon_prob), rep_groups)
    exon_alleles = {gene.allele_names[i] for i in sel}

    if exon_alleles:
        # full-length stage always prunes in the reference
        # (typing_core.py:1767-1769) — unless the user kept low-
        # abundance alleles explicitly
        full_prob = single_abundance(
            restrict_cmpt(full_cmpt, exon_alleles),
            opts.remove_low_abundance_alleles, lengths)
        combined = {a: p for a, p in exon_prob if a not in exon_alleles}
        for a, p in full_prob:
            combined[a] = p * exon_prob_sum
        return sorted(([a, p] for a, p in combined.items()),
                      key=lambda x: x[1], reverse=True)
    return exon_prob
