# Copy of hgtpu/validate.py.
"""Opt-in runtime sanity checks.

Equivalent of hisatgenotype_validation_check.py (368 LoC), gated the same
way the reference gates via devel/settings.json -> sanity_check
(typing_core.py:36-42): set HGTPU_SANITY_CHECK=1 or edit
devel/settings.json to enable assertions inside the hot paths.
"""
from __future__ import annotations

import json
import os

import numpy as np


def sanity_enabled() -> bool:
    if os.environ.get("HGTPU_SANITY_CHECK"):
        return os.environ["HGTPU_SANITY_CHECK"] not in ("0", "false", "")
    settings = os.path.join(os.path.dirname(__file__), "..", "devel",
                            "settings.json")
    try:
        with open(settings) as f:
            return bool(json.load(f).get("sanity_check", False))
    except OSError:
        return False


SANITY_CHECK = sanity_enabled()


def validate_variants_sorted(gene):
    """Variant table must be key_varKey-sorted (ref: validate_variants)."""
    assert np.all(np.diff(gene.var_pos) >= 0), "variants out of order"


def validate_constructs(gene, msa_rows=None, names=None):
    """Sequence reconstruction round trip (ref: validate_constructs:157):
    backbone + variants must rebuild every allele sequence."""
    if msa_rows is None:
        # internal consistency: reconstruction must at least be acyclic and
        # non-empty per allele
        for name in gene.allele_names:
            seq = gene.allele_seq(name)
            assert len(seq) > 0, name
        return
    for name in gene.allele_names:
        i = names.index(name)
        stripped = msa_rows[i].replace(".", "").replace("~", "")
        assert gene.allele_seq(name) == stripped, \
            "reconstruction mismatch for %s" % name


def validate_haplotypes(gene):
    """Haplotype windows sorted and covering freq-passing variants
    (ref: validate_haplotype:29)."""
    prev = (-1, -1)
    covered = set()
    for left, right, vidxs in gene.haplotypes:
        assert left <= right
        for v in vidxs:
            covered.add(v)
    passing = {i for i in range(gene.n_vars)
               if gene.var_freq[i] >= gene.min_var_freq}
    assert passing <= covered, "haplotypes miss variants"


def check_amb_uniqueness(cmp_list, cmp_left, cmp_right, left_alts,
                         right_alts):
    """Alt end spellings must be unique (ref: check_amb_uniqueness:313)."""
    assert len(set(left_alts)) == len(left_alts)
    assert len(set(right_alts)) == len(right_alts)
    assert 0 <= cmp_left <= len(cmp_list)
    assert cmp_right < len(cmp_list)


def check_allele_validity(gene, seqs_by_name):
    """Allele dictionary equality vs the sequences file
    (ref: check_allele_validity:357)."""
    for name, seq in seqs_by_name.items():
        assert gene.allele_seq(name) == seq, name


def allele_exon_seq(gene, name):
    """Reconstruct one allele's exonic sequence from the GeneRef:
    backbone bases over each exon window with the allele's catalog
    variants applied — SNPs substitute, deletions skip, an insertion
    anchored at backbone position p (occupying the gap before p)
    contributes when l < p <= r.  This is the reconstruction the
    reference's validate_exons diffs against `_nuc.fasta`
    (hisatgenotype_validation_check.py:234-312)."""
    from .db.catalog import VT_DELETION, VT_INSERTION, VT_SINGLE

    a = list(gene.allele_names).index(name)
    carried = np.flatnonzero(gene.links[:, a])
    out = []
    for l, r in gene.exons:
        seq = list(gene.backbone[l:r + 1])
        skip = np.zeros(r - l + 1, bool)
        ins_at = {}
        for v in carried:
            p = int(gene.var_pos[v])
            t = int(gene.var_type[v])
            if t == VT_SINGLE:
                if l <= p <= r:
                    seq[p - l] = gene.var_data[v]
            elif t == VT_DELETION:
                for q in range(p, p + int(gene.var_len[v])):
                    if l <= q <= r:
                        skip[q - l] = True
            elif t == VT_INSERTION:
                if l < p <= r:
                    ins_at.setdefault(p, []).append(gene.var_data[v])
        parts = []
        for q in range(l, r + 1):
            for ins in ins_at.get(q, ()):
                parts.append(ins)
            if not skip[q - l]:
                parts.append(seq[q - l])
        out.append("".join(parts))
    return "".join(out)


def validate_exons(gene, nuc_names=None, nuc_rows=None):
    """Exon consistency (ref: validate_exons:234-312).

    Structural check always: exons within the backbone, primaries a
    subset.  With a nuc (exon-only) alignment supplied, additionally
    reconstruct each shared allele's exonic sequence from the GeneRef
    and diff it against the gap-stripped nuc row — the check that
    catches exon-boundary off-by-ones and partial-grafting drift."""
    for l, r in gene.exons:
        assert 0 <= l <= r < len(gene.backbone)
    assert {tuple(e) for e in gene.primary_exons} \
        <= {tuple(e) for e in gene.exons}
    if nuc_names is None or nuc_rows is None:
        return
    lookup = dict(zip(nuc_names, nuc_rows))
    for name in gene.allele_names:
        row = lookup.get(name)
        if row is None:
            continue
        expect = row.replace(".", "").replace("-", "").replace("~", "")
        got = allele_exon_seq(gene, name)
        assert got == expect, \
            "exon sequence mismatch for %s: %d vs %d nt" % (
                name, len(got), len(expect))


def validate_gene(gene, msa_rows=None, names=None, nuc_names=None,
                  nuc_rows=None):
    """Run the full suite on one GeneRef."""
    validate_variants_sorted(gene)
    validate_constructs(gene, msa_rows, names)
    validate_haplotypes(gene)
    validate_exons(gene, nuc_names, nuc_rows)
