"""Family-level alignment: assign reads across a multi-gene catalog (port
of hgtpu/align/family.py).

The reference aligns each family's extracted reads against one graph
index containing all of that family's genes, and downstream drops NH>1
(multi-gene) alignments (typing_core.py:846-848).  Here one
concatenated-panel placement product (kernel K1) scores every (read,
gene) pair
(align.panel.PanelRouter), full variant-graph alignment runs on each
read's candidate genes only, and a read is kept only when exactly one
gene attains its best cost — the NH==1 uniqueness rule.

The router's candidates are the genes whose best ungapped diagonal lies
within a slack of the read's best over all genes.  A read that carries a
catalogued indel of its own gene scores below a paralog's ungapped
diagonal there, so its own gene may not be a candidate: a read that its
candidates leave with no alignment, or only with a positive cost, gets a
second round in every gene above the `min_seed_frac` floor it has not
tried, and the NH==1 rule runs over the genes of both rounds.  So the
router types the pairs the exhaustive path types, HISAT-genotype's
semantics, where hgtpu's router drops such reads.

For small families (< 3 genes) the exhaustive per-gene path is used —
the panel dispatch saves nothing there.  `device` (in **kw) reaches
every GeneAligner and the router.

TRACE: `family.route` (the router's product and fetch), `family.align`
(the per-gene alignment, both rounds) and `family.nh1` (the uniqueness
rule); counters `route.reads`, `route.candidates` (genes tried in the
first round), `route.second_reads` and `route.second_genes` (reads
aligned in the second round, and the genes tried there).
"""
from __future__ import annotations

import numpy as np

from ..db.catalog import Catalog
from ..utils.trace import TRACE
from .aligner import GeneAligner
from .panel import PanelRouter


class FamilyAligner:
    # the router's rounds: the slack rule's candidates, then the second
    # round above (hgtpu's router, and this one before it, had one)
    ROUNDS = 2

    def __init__(self, catalog: Catalog, num_editdist: int = 2,
                 route: str = "auto", min_seed_frac: float = 0.3, **kw):
        self.catalog = catalog
        self.aligners = {g: GeneAligner(ref, num_editdist=num_editdist, **kw)
                         for g, ref in catalog.genes.items()}
        self.genes = list(catalog.genes)
        self.min_seed_frac = min_seed_frac
        self.router = None
        if route == "on" or (route == "auto" and len(self.genes) >= 3):
            self.router = PanelRouter(
                [(g, catalog.genes[g]) for g in self.genes],
                device=kw.get("device"))
            # see pipeline.extract.ReadExtractor for the window rationale
            self.slack = max(2 * num_editdist + 8, 16)

    def align_batch(self, read_ids, seqs, mate: str):
        """Returns {gene: [ReadAln | None]} keeping only reads uniquely
        best in that gene (others set to None)."""
        n = len(seqs)
        per_gene = {g: [None] * n for g in self.genes}
        if self.router is None:
            self._align(per_gene, np.ones((n, len(self.genes)), bool),
                        read_ids, seqs, mate)
        else:
            with TRACE.stage("family.route"):
                gm, lens = self.router.gene_max(seqs)
            best = gm.max(axis=1) if n else np.zeros(0)
            above = gm >= (self.min_seed_frac * lens)[:, None]
            cand = above & (gm >= (best - self.slack)[:, None])
            self._align(per_gene, cand, read_ids, seqs, mate)
            redo = ~(self._costs(per_gene, n).min(axis=1, initial=np.inf)
                     <= 0)
            second = above & ~cand & redo[:, None]
            self._align(per_gene, second, read_ids, seqs, mate)
            TRACE.count("route.reads", n)
            TRACE.count("route.candidates", int(cand.sum()))
            TRACE.count("route.second_reads", int(second.any(axis=1).sum()))
            TRACE.count("route.second_genes", int(second.sum()))
        with TRACE.stage("family.nh1"):
            costs = self._costs(per_gene, n)
            best_c = costs.min(axis=1, initial=np.inf)
            at_best = costs == best_c[:, None]
            keep = np.where(np.isfinite(best_c) & (at_best.sum(axis=1) == 1),
                            at_best.argmax(axis=1), -1)
            for e, g in enumerate(self.genes):
                res = per_gene[g]
                for i in np.flatnonzero(keep != e).tolist():
                    res[i] = None
        return per_gene

    def _align(self, per_gene, take, read_ids, seqs, mate):
        """Align read i in gene e where take[i, e], into per_gene."""
        with TRACE.stage("family.align"):
            for e, g in enumerate(self.genes):
                rows = np.flatnonzero(take[:, e])
                if not len(rows):
                    continue
                alns = self.aligners[g].align_batch(
                    [read_ids[i] for i in rows],
                    [seqs[i] for i in rows], mate)
                res = per_gene[g]
                for i, aln in zip(rows.tolist(), alns):
                    res[i] = aln

    def _costs(self, per_gene, n):
        """[n, genes] edit cost of each read's alignment, inf where none."""
        out = np.full((n, len(self.genes)), np.inf)
        for e, g in enumerate(self.genes):
            for i, a in enumerate(per_gene[g]):
                if a is not None:
                    out[i, e] = a.nm
        return out
