from .catalog import (GeneRef, Catalog, VT_SINGLE, VT_DELETION, VT_INSERTION,
                      gene_from_fields, load_npz, save_npz)
from .build import build_gene_ref, build_catalog_from_msa
from .genome import build_genotype_genome, region_gene, liftover
from .msf import read_msf
