"""A gene family typed from one FASTQ read set as `hisatgenotype --base
hla -1 ... -2 ...` types it: the program's type_family with a
FamilyAligner on the card (the panel router on K1 from three genes on,
each gene's GeneAligner, the NH==1 rule), then the host engine per gene,
on one thread, as the command line calls it."""
from __future__ import annotations


def _require_second_round():
    """This deployment's NH==1 typing holds only where the panel router
    gives a read that its first candidates leave unaligned a second
    round in the other genes (`FamilyAligner.ROUNDS`).  A program whose
    router has one round loses paralogs' indel reads, so its outputs
    cannot match the reference: the run stops here, with exit code 1,
    before the catalogue is built."""
    from hgtpu_torch.align.family import FamilyAligner

    if getattr(FamilyAligner, "ROUNDS", 1) < 2:
        raise SystemExit("benchmark: the program's panel router has one "
                         "round and drops paralogs' indel reads; it "
                         "cannot run a gene family cell")


_require_second_round()


def catalog(cfg, specs):
    from hgtpu_torch.db import build_catalog_from_msa

    return build_catalog_from_msa(cfg["family"], {g: dict(
        names=s["names"], rows=s["rows"], ref_allele=s["ref_allele"],
        exons=s["exons"], primary_exon_idx=s["primary_exon_idx"],
        partial_names=sorted(s["partial"])) for g, s in specs.items()},
        min_var_freq=cfg["min_var_freq"])


class System:
    def __init__(self, catalog, cfg, device):
        from hgtpu_torch.align.family import FamilyAligner
        from hgtpu_torch.typer import TypingOptions

        self.catalog = catalog
        self.opts = TypingOptions()
        self.aligner = FamilyAligner(catalog, device=device)

    def __call__(self, reads_1, reads_2):
        from hgtpu_torch.pipeline import type_family

        return type_family(self.catalog, reads_1, reads_2, opts=self.opts,
                           family_aligner=self.aligner, threads=1)
