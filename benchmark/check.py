"""The comparison that decides `correct`.

Each number is a gap between what the program returned for a sample and
what the plain reference works out for the same reads, taken over every
gene of the sample; a run's reading of a number is its largest over the
checked samples.  The limits sit between the readings of sound runs and
those of the control (PERF.md gives both):

- full_gap, exon_gap, primary_gap: the share of the sample's pairs that
  sit in another class at that level (L1 distance of the class counts
  over twice the reference's pairs);
- counts_gap: the largest gap, over alleles, of the per-allele counts
  (pairs whose class holds the allele), over the gene's pairs;
- abundance_gap: the largest gap, over alleles, of the EM's abundance in
  pairs (prob times the pairs typed), over the gene's pairs.

Each configuration's file states its limits (`limits`); a number it
gives no limit is not compared (the production path, for one, computes
no primary-exon level unless asked to type primary exons first).
"""
from __future__ import annotations

NAMES = ("full_gap", "exon_gap", "primary_gap", "counts_gap",
         "abundance_gap")


def _l1(a: dict, b: dict) -> float:
    return float(sum(abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b)))


def as_dict(res) -> dict:
    """The compared fields of one gene's result: a GeneTypingResult of
    the program, or a reference dict (None: the gene was not typed)."""
    if res is None:
        return dict(num_pairs=0, cmpt={}, exon_cmpt={}, primary_exon_cmpt={},
                    counts={}, prob=[])
    if isinstance(res, dict):
        return res
    return dict(num_pairs=int(res.num_pairs), cmpt=dict(res.cmpt),
                exon_cmpt=dict(res.exon_cmpt),
                primary_exon_cmpt=dict(res.primary_exon_cmpt),
                counts=dict(res.counts), prob=[list(p) for p in res.prob])


def numbers(prog: dict, ref: dict) -> dict:
    """Gaps of one sample: prog and ref map gene -> compared fields."""
    pairs = max(sum(r["num_pairs"] for r in ref.values()), 1)
    out = dict.fromkeys(NAMES, 0.0)
    for g, r in ref.items():
        p = as_dict(prog.get(g))
        for key, name in (("cmpt", "full_gap"), ("exon_cmpt", "exon_gap"),
                          ("primary_exon_cmpt", "primary_gap")):
            out[name] += _l1(p[key], r[key]) / (2.0 * pairs)
        n = max(r["num_pairs"], 1)
        out["counts_gap"] = max(out["counts_gap"],
                                _max_gap(p["counts"], r["counts"]) / n)
        pa = {a: v * p["num_pairs"] for a, v in p["prob"]}
        ra = {a: v * r["num_pairs"] for a, v in r["prob"]}
        out["abundance_gap"] = max(out["abundance_gap"],
                                   _max_gap(pa, ra) / n)
    return out


def _max_gap(a: dict, b: dict) -> float:
    return max((abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b)),
               default=0.0)


def verdict(readings: dict, limits: dict) -> bool:
    """Every number the configuration limits is within its limit."""
    return all(readings[k] <= v for k, v in limits.items())


def lines(readings: dict, limits: dict) -> list:
    """'name value limit' per compared number, as the run prints them."""
    return ["%s %r limit %r" % (k, readings[k], v)
            for k, v in limits.items()]
