from .genotype import (type_reads, type_family, type_from_sam,
                       type_reads_linear, simulation_sweep)
from .extract import ReadExtractor
from .extract_genome import GenomeExtractor, write_block_fastqs
