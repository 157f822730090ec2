"""One gene typed as the --bamfile flow types a locus: the program's
type_reads with a GeneAligner on the card, the production path ("auto"
on CUDA)."""
from __future__ import annotations


def catalog(cfg, specs):
    from hgtpu_torch.db import build_gene_ref

    (g, spec), = specs.items()
    ref, _ = build_gene_ref(
        g, spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"],
        min_var_freq=cfg["min_var_freq"],
        partial_names=sorted(spec["partial"]))
    return ref


class System:
    def __init__(self, ref, cfg, device):
        from hgtpu_torch.align import GeneAligner
        from hgtpu_torch.typer import TypingOptions

        self.ref = ref
        self.opts = TypingOptions()
        self.aligner = GeneAligner(ref, device=device)

    def __call__(self, reads_1, reads_2):
        from hgtpu_torch.pipeline import type_reads

        return {self.ref.gene: type_reads(self.ref, reads_1, reads_2,
                                          self.opts, aligner=self.aligner)}
