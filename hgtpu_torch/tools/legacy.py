# Copy of hgtpu/tools/legacy.py; extraction and typing run on `device`.
"""Legacy one-call pipeline.

Equivalent of hisatgenotype_tools/hisatgenotype_legacy.py
(perform_genotyping:252): the original monolithic flow — extract reads
from a raw sample against all families, then type every extracted family
— in one function call.
"""
from __future__ import annotations

from ..pipeline.extract import ReadExtractor
from ..pipeline.genotype import type_family
from ..typer.engine import TypingOptions


def perform_genotyping(catalogs: dict, reads_1, reads_2=None, opts=None,
                       device=None):
    """catalogs: {family: Catalog}.  Returns
    {family: {gene: GeneTypingResult}}.  `device` as for ReadExtractor
    and type_family (None means the card)."""
    opts = opts or TypingOptions()
    extractor = ReadExtractor(catalogs, num_editdist=opts.num_editdist,
                              device=device)
    routed = extractor.extract(reads_1, reads_2)
    out = {}
    for family, (r1, r2) in routed.items():
        fam_opts = TypingOptions(**{**opts.__dict__, "family": family})
        out[family] = type_family(catalogs[family], r1, r2 or None,
                                  opts=fam_opts, device=device)
    return out
