from .dna import encode_seq, decode_seq, revcomp, revcomp_encoded, BASES
