from .graph import AsmNode, AssemblyGraph, viterbi_path
from .nodes import allele_node, read_nodes_from_hts
