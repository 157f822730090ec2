# Copy of hgtpu/typer/report.py.
"""Report writer mirroring the reference's .report text structure
(typing_core.py:302-325 header, :1592-1677 counts, :2076-2122 abundance).
The header keeps hgtpu's text, so the two packages' reports compare line
for line.
"""
from __future__ import annotations

import sys

from .. import __version__
from .engine import GeneTypingResult


class ReportWriter:
    def __init__(self, path=None, echo=False, aligner_label="hgtpu graph"):
        self.file = open(path, "w") if path else None
        self.echo = echo
        self.aligner_label = aligner_label

    def _out(self, line=""):
        if self.file:
            print(line, file=self.file)
        if self.echo:
            print(line, file=sys.stderr)

    def header(self, dbversion="NONE", command=""):
        self._out("# VERSIONS:")
        self._out("# hgtpu - %s" % __version__)
        self._out("# Database - %s" % dbversion)
        self._out("# COMMAND:\n%s" % command)

    def begin_aligner(self):
        self._out("\n\t\t%s" % self.aligner_label)

    def gene_result(self, res: GeneTypingResult, simulation=False,
                    true_alleles=(), output_allele_counts=False,
                    best_alleles=False):
        self._out("\t\t\t%d reads and %d pairs are aligned"
                  % (res.num_reads, res.num_pairs))
        # ranked counts (ref: typing_core.py:1650-1677)
        for i, (allele, count) in enumerate(res.counts):
            if simulation:
                if allele in true_alleles:
                    self._out("\t\t\t*** %d ranked %s (count: %d)"
                              % (i + 1, allele, count))
                elif i < 5:
                    self._out("\t\t\t\t%d %s (count: %d)"
                              % (i + 1, allele, count))
            else:
                self._out("\t\t\t\t%d %s (count: %d)" % (i + 1, allele, count))
                if i >= 9 and not output_allele_counts:
                    break
        self._out("\n")
        # abundance (ref: typing_core.py:2076-2122)
        ranks_of_true = {}
        for i, (allele, prob) in enumerate(res.prob):
            if prob < 0.01:
                break
            if simulation and allele in true_alleles:
                self._out("\t\t\t*** %d ranked %s (abundance: %.2f%%)"
                          % (i + 1, allele, prob * 100.0))
                ranks_of_true[allele] = i
            else:
                self._out("\t\t\t\t%d ranked %s (abundance: %.2f%%)"
                          % (i + 1, allele, prob * 100.0))
                if best_alleles and i < 2:
                    self._out("SingleModel %s (abundance: %.2f%%)"
                              % (allele, prob * 100.0))
            if not simulation and i >= 9:
                break
            if i >= 19:
                break
        return ranks_of_true

    def assembly_detail(self, contigs):
        """Per-contig comparison section (ref: typing_core.py:2032-2063:
        'Genomic:' node lines with Known/Novel classification)."""
        if not contigs:
            return
        self._out("\t\tNumber of contigs: %d" % len(contigs))
        for key, seq in contigs.items():
            parts = key.rsplit(" ", 1)
            node_name, call = parts[0], parts[-1]
            self._out("\tGenomic: %s" % node_name)
            self._out("\t\tassembled sequence (%d bps)" % len(seq))
            if call == "Novel":
                self._out("\tNovel allele")
            else:
                self._out("\tKnown allele")

    def assembly_calls(self, calls_by_gene):
        """Ref: typing_core.py:2147-2159."""
        self._out("\t\tAssembly Coloring Allele Collapse:")
        for genename, call in calls_by_gene.items():
            if call:
                alleles, score = call
                self._out("\t\t\t%s: %s (Group score: %.5f)"
                          % (genename, " : ".join(alleles), 10 ** score))
            else:
                self._out("\t\t\t%s: NONE (Group score: NA)" % genename)

    def close(self):
        if self.file:
            self.file.close()
