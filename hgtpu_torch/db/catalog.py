# Copy of hgtpu/db/catalog.py, without the text exporters (no caller
# here), plus gene_from_fields.
"""Graph-reference catalog: the in-memory / on-disk database for one family.

Everything lives as packed numpy arrays (host) that upload directly as
device tensors; ``save_npz`` / ``load_npz`` keep a family in one file,
in the same layout as hgtpu's, so either package reads the other's.

Variant model (ref: typing_common.py:339-368 read_variants):
  type in {single, deletion, insertion}; pos is a 0-based backbone
  coordinate; data is the alternative base (single), deletion length
  (deletion) or inserted sequence (insertion).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from ..utils.dna import encode_seq

VT_SINGLE = 0
VT_DELETION = 1
VT_INSERTION = 2


@dataclasses.dataclass
class GeneRef:
    """All reference data for one gene (locus) of a family."""

    gene: str                      # e.g. "A"
    backbone_name: str             # e.g. "A*BACKBONE"
    backbone: str                  # consensus sequence, no gaps
    allele_names: list             # allele names (no backbone), DB order
    # --- variant table (sorted by key_varKey; ids "hv<N>" family-global) ---
    var_ids: list                  # "hv0", "hv1", ...
    var_type: np.ndarray           # int8 [V]
    var_pos: np.ndarray            # int32 [V] 0-based backbone coordinate
    var_len: np.ndarray            # int32 [V] 1 / del len / ins len
    var_data: list                 # str: alt base / str(len) / inserted seq
    var_freq: np.ndarray           # float32 [V] percentage 0..100
    links: np.ndarray              # bool [V, A] allele<->variant membership
    # --- annotations ---
    exons: list                    # [(left, right)] inclusive backbone coords
    primary_exons: list            # subset of exons
    haplotypes: list               # [(left, right, [var index, ...])]
    partial: set = dataclasses.field(default_factory=set)
    # locus placement on the host genome (chromosome coordinates)
    chrom: str = "chrU"
    chrom_left: int = 0
    chrom_right: int = 0
    strand: str = "+"
    min_var_freq: float = 0.0

    # ------------------------------------------------------------------ #
    # derived, cached
    # ------------------------------------------------------------------ #
    def __post_init__(self):
        self._id2idx = {v: i for i, v in enumerate(self.var_ids)}
        self._allele_idx = {a: i for i, a in enumerate(self.allele_names)}
        self.backbone_enc = encode_seq(self.backbone)
        # position-sorted order == storage order (sorted by key_varKey which
        # leads with pos); var_pos is non-decreasing.
        assert np.all(np.diff(self.var_pos) >= 0), "variants must be pos-sorted"
        # right ends (inclusive): pos for single/ins, pos+len-1 for deletions
        self.var_right = self.var_pos + np.where(
            self.var_type == VT_DELETION, self.var_len - 1, 0
        ).astype(np.int32)
        # running max of right end, used for overlap scans
        # (ref: gene_var_maxrights, typing_core.py:393-401)
        self.var_maxright = (
            np.maximum.accumulate(self.var_right)
            if len(self.var_pos)
            else np.zeros(0, np.int32)
        )

    # ------------------------------------------------------------------ #
    @property
    def n_vars(self) -> int:
        return len(self.var_ids)

    @property
    def n_alleles(self) -> int:
        return len(self.allele_names)

    def var_index(self, var_id: str) -> int:
        return self._id2idx[var_id]

    def allele_index(self, name: str) -> int:
        return self._allele_idx[name]

    def allele_var_indices(self, name: str) -> np.ndarray:
        """Sorted variant indices belonging to an allele."""
        return np.flatnonzero(self.links[:, self._allele_idx[name]])

    # ------------------------------------------------------------------ #
    def allele_seq(self, name: str) -> str:
        """Reconstruct an allele's sequence from backbone + its variants.

        Ref: read_Gene_alleles_from_vars (typing_core.py:2199-2237).
        """
        if name == self.backbone_name:
            return self.backbone
        out = []
        cur = 0
        for vi in self.allele_var_indices(name):
            pos = int(self.var_pos[vi])
            vt = int(self.var_type[vi])
            if pos > cur:
                out.append(self.backbone[cur:pos])
                cur = pos
            if vt == VT_SINGLE:
                out.append(self.var_data[vi])
                cur = pos + 1
            elif vt == VT_DELETION:
                cur = pos + int(self.var_len[vi])
            else:  # insertion attaches before backbone[pos]
                out.append(self.var_data[vi])
        out.append(self.backbone[cur:])
        return "".join(out)

    def exclude_alleles(self, names) -> "GeneRef":
        """Panel with the given alleles removed (variant table intact —
        the aligner still knows every catalog variant, as the reference
        keeps its index when excluding alleles for novel-allele
        experiments, etc/hisatgenotype_hla_cyp.py:552,1154)."""
        drop = set(names)
        keep = [i for i, a in enumerate(self.allele_names)
                if a not in drop]
        return dataclasses.replace(
            self,
            allele_names=[self.allele_names[i] for i in keep],
            links=self.links[:, keep],
            partial={a for a in self.partial if a not in drop})

    def allele_lengths(self) -> dict:
        """Allele sequence lengths, vectorized from the link matrix:
        len(backbone) + sum(insertion lens) - sum(deletion lens)."""
        if getattr(self, "_lengths", None) is None:
            delta = np.where(
                self.var_type == VT_INSERTION, self.var_len,
                np.where(self.var_type == VT_DELETION, -self.var_len, 0),
            ).astype(np.int64)
            lens = len(self.backbone) + delta @ self.links
            self._lengths = {name: int(lens[i])
                             for i, name in enumerate(self.allele_names)}
            self._lengths[self.backbone_name] = len(self.backbone)
        return self._lengths

    # ------------------------------------------------------------------ #
    def exonic_var_mask(self, exons) -> np.ndarray:
        """Boolean mask of variants fully inside any of `exons`.

        Ref: get_exonic_vars (typing_core.py:67-78).
        """
        mask = np.zeros(self.n_vars, dtype=bool)
        for left, right in exons:
            mask |= (self.var_pos >= left) & (self.var_right <= right)
        return mask


def gene_from_fields(fields: dict) -> GeneRef:
    """A GeneRef of this package from its constructor fields as plain
    Python and numpy values, e.g. another implementation's gene taken
    apart with ``{f.name: getattr(g, f.name) for f in
    dataclasses.fields(g)}``.  The values are deep-copied, and the derived
    arrays are rebuilt by ``__post_init__``, so the result equals a gene
    this package built itself and shares no state with the source."""
    names = {f.name for f in dataclasses.fields(GeneRef)}
    extra = sorted(set(fields) - names)
    if extra:
        raise TypeError("not GeneRef fields: %s" % extra)
    return GeneRef(**copy.deepcopy(dict(fields)))


@dataclasses.dataclass
class Catalog:
    """A family database: a set of genes plus family-level metadata."""

    family: str                    # "hla", "cyp", "codis", ...
    genes: dict                    # gene -> GeneRef
    version: str = "NONE"

    def gene(self, g: str) -> GeneRef:
        return self.genes[g]


def save_npz(cat: Catalog, path: str) -> None:
    """Single packed binary artifact: all genes' arrays in one npz,
    loadable straight into device memory."""
    import json

    blobs = {}
    meta = {"family": cat.family, "version": cat.version, "genes": {}}
    for g, ref in cat.genes.items():
        meta["genes"][g] = {
            "backbone_name": ref.backbone_name,
            "backbone": ref.backbone,
            "allele_names": ref.allele_names,
            "var_ids": ref.var_ids,
            "var_data": ref.var_data,
            "exons": [list(e) for e in ref.exons],
            "primary_exons": [list(e) for e in ref.primary_exons],
            "haplotypes": [[l, r, list(v)] for l, r, v in ref.haplotypes],
            "partial": sorted(ref.partial),
            "chrom": ref.chrom,
            "chrom_left": ref.chrom_left,
            "chrom_right": ref.chrom_right,
            "strand": ref.strand,
            "min_var_freq": ref.min_var_freq,
        }
        blobs["%s/var_type" % g] = ref.var_type
        blobs["%s/var_pos" % g] = ref.var_pos
        blobs["%s/var_len" % g] = ref.var_len
        blobs["%s/var_freq" % g] = ref.var_freq
        blobs["%s/links" % g] = np.packbits(ref.links, axis=1)
    blobs["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **blobs)


def load_npz(path: str) -> Catalog:
    import json

    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    genes = {}
    for g, m in meta["genes"].items():
        A = len(m["allele_names"])
        links = np.unpackbits(z["%s/links" % g], axis=1)[:, :A].astype(bool)
        genes[g] = GeneRef(
            gene=g,
            backbone_name=m["backbone_name"],
            backbone=m["backbone"],
            allele_names=m["allele_names"],
            var_ids=m["var_ids"],
            var_type=z["%s/var_type" % g],
            var_pos=z["%s/var_pos" % g],
            var_len=z["%s/var_len" % g],
            var_data=m["var_data"],
            var_freq=z["%s/var_freq" % g],
            links=links,
            exons=[tuple(e) for e in m["exons"]],
            primary_exons=[tuple(e) for e in m["primary_exons"]],
            haplotypes=[(l, r, list(v)) for l, r, v in m["haplotypes"]],
            partial=set(m["partial"]),
            chrom=m["chrom"],
            chrom_left=m["chrom_left"],
            chrom_right=m["chrom_right"],
            strand=m["strand"],
            min_var_freq=m["min_var_freq"],
        )
    return Catalog(family=meta["family"], genes=genes,
                   version=meta["version"])


def _read_fasta(path: str) -> dict:
    seqs = {}
    name = None
    parts = []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(parts)
            name = line[1:].split()[0]
            parts = []
        else:
            parts.append(line)
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs
