"""Traffic generation: the catalogs' MSAs and the samples typed in a run.

`hla_msa` renders one gene's catalog as an MSF-style matrix ('.' for
gaps) the way IPD-IMGT/HLA and HISAT-genotype's builder present it:

- the reference allele's own layout (its length and exon coordinates,
  from the configuration) on a random ancestral backbone;
- lineages: each first-field allele group has a founder that carries
  its own draw of the lineage events (SNPs, deletions, insertions),
  every allele of the group inherits them and adds a few private ones;
  group sizes fall off as 1 / rank;
- exon-only (partial) alleles are the majority: an exon-only allele is
  known over the configuration's `partial_exons` alone, and its row
  elsewhere is the column consensus of the full-length alleles, as
  HISAT-genotype's builder grafts it (typing_process.py:646-730);
- no two alleles have the same row, as no two catalogued alleles have
  the same sequence.

A configuration's genes share its top-level layout; an entry of its
`genes` list may carry any layout key of its own (LAYOUT), which then
replaces the top-level one for that gene alone, so a panel can give its
class II genes their own lengths, exons and allele counts.

Paralogs: an entry may name `paralog_of`, an earlier gene of the list,
and a `divergence` in [0, 1).  Its ancestral backbone is then the named
gene's, cut to its own length or extended with bases drawn from its own
seed, with that share of its positions substituted from its own seed;
its events, lineages and alleles are drawn from its own seed as any
gene's are.  This models HLA class I (A, B, C) and the class II beta
chains (DQB1, DRB1) as duplicates of one ancestral gene that have
drifted apart: a read from one of them may match another exactly,
which is what makes a router send it to several genes and the NH==1
rule (reference.py) decide between them.  Without `paralog_of` a gene's
draws are made in the order they always were, so a configuration
without it gives the same catalog as before the key existed.

Samples are tiled from the MSA rows themselves, never from a built
catalog, so the yardstick does not depend on the program under test.
"""
from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_DOT = ord(".")


def _events(rng, length, n_snp, n_del, n_ins, anc):
    """Non-overlapping events [(kind, pos, payload)] at uniform
    positions, one base apart at least."""
    taken = np.zeros(length, bool)

    def claim(span):
        for _ in range(50):
            p = int(rng.integers(10, length - 10 - span))
            if not taken[p - 1:p + span + 1].any():
                taken[p:p + span] = True
                return p
        return -1

    events = []
    for _ in range(n_snp):
        p = claim(1)
        if p >= 0:
            events.append(("S", p, int((anc[p] + rng.integers(1, 4)) % 4)))
    for _ in range(n_del):
        ln = int(rng.integers(1, 7))
        p = claim(ln)
        if p >= 0:
            events.append(("D", p, ln))
    for _ in range(n_ins):
        ln = int(rng.integers(1, 5))
        p = claim(1)
        if p >= 0:
            events.append(("I", p, "".join(
                "ACGT"[i] for i in rng.integers(0, 4, ln))))
    return events


def _render(anc, events, carry):
    """(matrix [A, columns] of ASCII codes, column of each backbone
    base)."""
    length = len(anc)
    ins_at = {p: ei for ei, (k, p, _) in enumerate(events) if k == "I"}
    col_of = np.zeros(length, np.int64)
    ins_cols = {}
    col = 0
    for p in range(length):
        if p in ins_at:
            ins_cols[ins_at[p]] = col
            col += len(events[ins_at[p]][2])
        col_of[p] = col
        col += 1
    mat = np.full((carry.shape[0], col), _DOT, np.uint8)
    mat[:, col_of] = _BASES[anc][None, :]
    for ei, (k, p, payload) in enumerate(events):
        rows = carry[:, ei]
        if k == "S":
            mat[rows, col_of[p]] = _BASES[payload]
        elif k == "D":
            mat[np.ix_(rows, col_of[p:p + payload])] = _DOT
        else:
            c0 = ins_cols[ei]
            mat[np.ix_(rows, np.arange(c0, c0 + len(payload)))] = \
                np.frombuffer(payload.encode(), np.uint8)[None, :]
    return mat, col_of


def _graft(mat, full, spans):
    """Rows of the exon-only alleles outside `spans` (column ranges)
    set to the column consensus of the full-length rows."""
    codes = np.frombuffer(b"ACGT.", np.uint8)
    counts = np.stack([(mat[full] == c).sum(axis=0) for c in codes])
    cons = codes[np.argmax(counts, axis=0)]
    keep = np.zeros(mat.shape[1], bool)
    for c0, c1 in spans:
        keep[c0:c1 + 1] = True
    out = mat.copy()
    part = np.flatnonzero(~full)
    out[np.ix_(part, np.flatnonzero(~keep))] = cons[~keep][None, :]
    return out


def backbone(seed, length, parent=None, divergence=0.0):
    """(ancestral backbone as codes 0-3, the gene's generator after
    drawing it).  `parent` is the backbone of the gene this one is a
    paralog of (module doc), None for a gene of its own."""
    rng = np.random.default_rng(seed)
    if parent is None:
        return rng.integers(0, 4, length), rng
    if not 0.0 <= divergence < 1.0:
        raise ValueError("divergence %r is not in [0, 1)" % divergence)
    anc = np.concatenate([parent[:length], rng.integers(
        0, 4, max(length - len(parent), 0))])
    n = int(round(divergence * length))
    pos = rng.choice(length, n, replace=False)
    anc[pos] = (anc[pos] + rng.integers(1, 4, n)) % 4
    return anc, rng


def hla_msa(gene, length, exons, primary_exons, groups, n_alleles,
            full_frac, n_snp, n_del, n_ins, lineage_frac, private_mean,
            partial_exons, seed, parent=None, divergence=0.0):
    """dict(names, rows, ref_allele, exons, primary_exon_idx, partial)
    of one gene; the arguments are a configuration's (module doc), and
    `parent`, `divergence` those of `backbone`."""
    anc, rng = backbone(seed, length, parent, divergence)
    events = _events(rng, length, n_snp, n_del, n_ins, anc)
    E, G, A = len(events), len(groups), n_alleles
    lineage = rng.random(E) < lineage_frac
    founders = (rng.random((G, E)) < rng.uniform(0.05, 0.5, E)[None, :]) \
        & lineage[None, :]
    founders[0] = False              # the reference allele's group
    size = 1.0 / (1 + rng.permutation(G))
    group = np.concatenate([[0], rng.choice(G, A - 1, p=size / size.sum())])
    carry = founders[group]
    private = np.flatnonzero(~lineage)
    k = rng.poisson(private_mean, A)
    k[0] = 0                         # the reference allele: the ancestor
    carry[np.repeat(np.arange(A), k),
          private[rng.integers(0, len(private), k.sum())]] = True
    full = rng.random(A) < full_frac
    full[0] = True
    pos = np.array([p for _, p, _ in events])
    in_exon = np.zeros(E, bool)
    for i in partial_exons:
        in_exon |= (pos >= exons[i][0]) & (pos <= exons[i][1])
    exon_private = np.flatnonzero(in_exon & ~lineage)
    for _ in range(100):
        mat, col_of = _render(anc, events, carry)
        mat = _graft(mat, full, [(col_of[exons[i][0]], col_of[exons[i][1]])
                                 for i in partial_exons])
        seen = set()
        dup = []
        for a in range(A):
            row = mat[a].tobytes()
            if row in seen:
                dup.append(a)
            seen.add(row)
        if not dup:
            break
        # a repeated row takes one more private event, exonic where
        # the allele is known over its exons alone
        for a in dup:
            pick = exon_private if not full[a] and len(exon_private) \
                else private
            carry[a, pick[rng.integers(0, len(pick))]] = True
    else:
        raise ValueError("%s: could not make the rows distinct" % gene)

    count = {}
    names = []
    for a in range(A):
        j = count.get(group[a], 0)
        count[group[a]] = j + 1
        names.append("%s*%02d:%02d:%02d:%02d" % (
            gene, groups[group[a]], j // 100 + 1, (j // 10) % 10 + 1,
            j % 10 + 1))
    order = sorted(range(A), key=names.__getitem__)
    rows = [mat[a].tobytes().decode("ascii") for a in order]
    return dict(names=[names[a] for a in order], rows=rows,
                ref_allele=names[0], exons=[tuple(e) for e in exons],
                primary_exon_idx=tuple(primary_exons),
                partial={names[a] for a in range(A) if not full[a]})


LAYOUT = ("length", "exons", "primary_exons", "partial_exons", "groups",
          "n_alleles", "full_frac", "n_snp", "n_del", "n_ins",
          "lineage_frac", "private_mean")


def catalog_specs(cfg):
    """{gene: MSA spec} for a configuration file's `genes` list: each
    gene's layout keys from its own entry, else from the top level."""
    out, anc = {}, {}
    for g in cfg["genes"]:
        name = g["name"]
        layout = {k: g[k] if k in g else cfg[k] for k in LAYOUT}
        parent = g.get("paralog_of")
        if parent is not None and parent not in anc:
            raise ValueError("%s: paralog_of %r names no earlier gene"
                             % (name, parent))
        kw = dict(parent=anc.get(parent), divergence=g.get("divergence", 0.0))
        anc[name] = backbone(g["seed"], layout["length"], **kw)[0]
        out[name] = hla_msa(name, seed=g["seed"], **layout, **kw)
    return out


def sample_rng(seed, index, salt=0):
    """The generator of sample `index` of a run seeded `seed`: the same
    (seed, index) always gives the same sample, whatever else ran."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(index), salt]))


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def tile(seq: str, interval: int, offset: int, read_len: int,
         frag_len: int):
    """Fragments of frag_len every `interval` bases from `offset`: the
    forward first mate and the reverse-complemented second mate, as the
    reference's simulator cuts them (--simulate-interval, --read-len,
    --fragment-len).  Returns two lists of str."""
    starts = range(offset, len(seq) - frag_len + 1, interval)
    rc = revcomp(seq)
    n = len(seq)
    r1 = [seq[i:i + read_len] for i in starts]
    r2 = [rc[n - i - frag_len:n - i - frag_len + read_len] for i in starts]
    return r1, r2


def draw_sample(specs, mix, seed, index, salt=0):
    """One sample: a heterozygous pair of full-length alleles per gene,
    each allele tiled from its own offset in [0, interval).  Returns
    (truth {gene: (allele, allele)}, reads_1, reads_2); read names are
    fragment numbers and carry no truth."""
    rng = sample_rng(seed, index, salt)
    truth = {}
    r1, r2 = [], []
    for g, spec in specs.items():
        full = [i for i, n in enumerate(spec["names"])
                if n not in spec["partial"]]
        pair = rng.choice(len(full), 2, replace=False)
        truth[g] = tuple(spec["names"][full[i]] for i in pair)
        for i in pair:
            seq = spec["rows"][full[i]].replace(".", "")
            a, b = tile(seq, mix["interval"],
                        int(rng.integers(0, mix["interval"])),
                        mix["read_len"], mix["frag_len"])
            r1 += a
            r2 += b
    n1 = [("%d" % i, s) for i, s in enumerate(r1)]
    n2 = [("%d" % i, s) for i, s in enumerate(r2)]
    return truth, n1, n2


class Pool:
    """The run's samples in order: sample i is the i-th distinct draw
    of (seed, index), so a run and a replay of it agree."""

    def __init__(self, specs, mix, seed):
        self.args = (specs, mix, seed)
        self.samples = []
        self._seen = set()
        self._next = 0

    def fill(self, n):
        """Draw until the pool holds n samples."""
        specs, mix, seed = self.args
        while len(self.samples) < n:
            truth, r1, r2 = draw_sample(specs, mix, seed, self._next)
            self._next += 1
            ident = (tuple(sorted(truth.items())), r1[0][1], r2[-1][1])
            if ident not in self._seen:
                self._seen.add(ident)
                self.samples.append((r1, r2))
