from .catalog import (GeneRef, Catalog, VT_SINGLE, VT_DELETION, VT_INSERTION,
                      gene_from_fields, load_npz, save_npz)
from .build import build_gene_ref
