# Twin of the edge-case genes of hgtpu's tests (test_fuzz.py,
# test_haplotype_paths.py, test_partial.py, test_error_correction.py,
# test_options.py), built with the port's db and typed with its pipeline.
"""Edge-case genes and read sets for typing, on both of the port's paths.

hgtpu's own tests pin these shapes, and the campaign and the golden runs
never build them: random MSAs with gaps and collapsed alleles, a gene
whose alleles miss their first and last bases, a gene with no variants,
a gene whose two indels never co-occur (the haplotype-window constraint),
grafted partial alleles, errored reads, and the typing options that
change the path.  Each gene is given as plain data (an MSA and its build
arguments, or a GeneRef's fields), so a parity test builds hgtpu's gene
from the same data.
"""
import random

from . import use_synth

FUZZ_SEED = 99
FUZZ_GENES = 4


def random_msa(rng, n_alleles, length, gapiness=0.1):
    """tests/test_fuzz.py's _random_msa: an ancestral sequence and alleles
    with up to 7 substitutions or 1-3 base gaps each."""
    anc = "".join(rng.choice("ACGT") for _ in range(length))
    rows = []
    names = []
    for a in range(n_alleles):
        row = list(anc)
        for _ in range(rng.randrange(0, 8)):
            p = rng.randrange(length)
            op = rng.random()
            if op < 0.6:
                row[p] = rng.choice("ACGT")
            elif op < 0.6 + gapiness * 3:
                for q in range(p, min(length, p + rng.randint(1, 4))):
                    row[q] = "."
        names.append("F*%02d:01" % (a + 1))
        rows.append("".join(row))
    return names, rows


def _msa_spec(gene, names, rows, ref_allele, **kw):
    return {"args": (gene, names, rows, ref_allele), "kw": kw}


def specs():
    """{name: spec}: spec["args"] and spec["kw"] are build_gene_ref's
    positional and keyword arguments (the same for hgtpu's build), or
    spec["fields"] a GeneRef's fields."""
    out = {}
    # the random-MSA fuzz of tests/test_fuzz.py:31 at 3-12 alleles and
    # 400-900 bp, so that 100-bp reads fit
    rng = random.Random(FUZZ_SEED)
    for k in range(FUZZ_GENES):
        n = rng.randint(3, 12)
        L = rng.randint(400, 900)
        names, rows = random_msa(rng, n, L)
        out["fuzz%d" % k] = _msa_spec("F", names, rows, names[0],
                                      min_var_freq=0.0)
    # tests/test_fuzz.py:55 grown to 600 bp: alleles missing their first
    # and last four bases, one four-base substitution
    bb = "ACGT" * 150
    rows = [bb, "...." + bb[4:], bb[:-4] + "....",
            bb[:100] + "TTTT" + bb[104:]]
    out["gaps"] = _msa_spec("X", ["X*01", "X*02", "X*03", "X*04"], rows,
                            "X*01", min_var_freq=0.0, collapse=False,
                            leftshift=False)
    # the same shape on a random backbone: the repeat above places no
    # read uniquely, so this one is what types
    bb = "".join(random.Random(FUZZ_SEED).choice("ACGT") for _ in range(600))
    rows = [bb, "...." + bb[4:], bb[:-4] + "....",
            bb[:100] + "TTTT" + bb[104:]]
    out["gaps_random"] = _msa_spec("X", ["X*01", "X*02", "X*03", "X*04"],
                                   rows, "X*01", min_var_freq=0.0,
                                   collapse=False, leftshift=False)
    # tests/test_fuzz.py:46: five identical alleles, no variant
    rows = ["ACGTACGTACGTACGTACGT" * 10] * 5
    out["identical"] = _msa_spec("X", ["X*%02d" % i for i in range(5)],
                                 rows, "X*00", min_var_freq=0.0,
                                 collapse=False)
    # tests/test_haplotype_paths.py:15
    out["two_indels"] = {"fields": two_indel_fields()}
    # tests/test_partial.py's grafted partial alleles, at 900 bp
    use_synth()
    from synth import make_gene_msa, make_nuc_msa

    spec = make_gene_msa(seed=11, n_alleles=20, length=900)
    out["partial"] = _msa_spec(
        "A", spec["names"], spec["rows"], spec["ref_allele"],
        exons_ref_coords=spec["exons"],
        primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0,
        partial_msa=make_nuc_msa(spec, n_partial=3))
    # tests/test_error_correction.py's and test_options.py's genes, at
    # 900 bp
    for name, seed in (("errors", 11), ("options", 21)):
        spec = make_gene_msa(seed=seed, length=900)
        out[name] = _msa_spec(
            "A", spec["names"], spec["rows"], spec["ref_allele"],
            exons_ref_coords=spec["exons"],
            primary_exon_idx=spec["primary_exon_idx"], min_var_freq=0.0)
    return out


def two_indel_fields():
    """tests/test_haplotype_paths.py's gene: a deletion (allele B) and a
    nearby insertion (allele C) that never co-occur, one haplotype row
    each over the span."""
    import numpy as np

    from ..db.catalog import VT_DELETION, VT_INSERTION

    bb = "ACGTACGTAGGCTTACGATCGGATCCGTACGTTAGCATCGATCGGTACCGTA" * 2
    links = np.zeros((2, 3), dtype=bool)
    links[0, 1] = True
    links[1, 2] = True
    return dict(
        gene="X", backbone_name="X*BB", backbone=bb,
        allele_names=["X*A", "X*B", "X*C"], var_ids=["hv0", "hv1"],
        var_type=np.array([VT_DELETION, VT_INSERTION], np.int8),
        var_pos=np.array([20, 34], np.int32),
        var_len=np.array([2, 2], np.int32), var_data=["2", "TT"],
        var_freq=np.array([10.0, 10.0], np.float32), links=links,
        exons=[(0, len(bb) - 1)], primary_exons=[(0, len(bb) - 1)],
        haplotypes=[(18, 40, [0]), (18, 40, [1])])


def recombinant_read(backbone):
    """A read that uses both indels of the two-indel gene (never seen
    together in an allele), and its backbone start."""
    return backbone[10:20] + backbone[22:34] + "TT" + backbone[34:60], 10


def build(spec):
    """The port's GeneRef of one spec."""
    from ..db import build_gene_ref
    from ..db.catalog import GeneRef

    if "fields" in spec:
        return GeneRef(**spec["fields"])
    return build_gene_ref(*spec["args"], **spec["kw"])[0]


# (case, gene, reads, options): reads are simulate_reads arguments with
# "alleles" as allele indices; options are TypingOptions fields beside
# simulation=True.  One option set per gene, as the campaign does.
CASES = [
    ("fuzz0", "fuzz0", dict(alleles=(0,), err=0.0, seed=5, interval=2),
     {}),
    ("fuzz1", "fuzz1", dict(alleles=(0, 1), err=1.0, seed=7, interval=2),
     {}),
    ("fuzz1-keep-low", "fuzz1",
     dict(alleles=(0, 1), err=1.0, seed=7, interval=2),
     dict(remove_low_abundance_alleles=False)),
    ("fuzz2", "fuzz2", dict(alleles=(1, 3), err=0.0, seed=9, interval=3),
     dict(type_primary_exons=True)),
    ("fuzz3", "fuzz3", dict(alleles=(2,), err=2.0, seed=11, interval=3),
     {}),
    ("gaps", "gaps", dict(alleles=(3,), err=0.0, seed=3, interval=2), {}),
    ("gaps-random", "gaps_random",
     dict(alleles=(1, 2), err=0.0, seed=3, interval=2), {}),
    ("identical", "identical",
     dict(alleles=(0,), err=0.0, seed=3, interval=2, read_len=60,
          frag_len=150), {}),
    ("two-indels", "two_indels",
     dict(alleles=(1, 2), err=0.0, seed=3, interval=1, read_len=40,
          frag_len=80, recombinant=True), {}),
    ("partial", "partial", dict(alleles=("partial",), err=0.0, seed=1,
                                interval=3), {}),
    ("errors", "errors", dict(alleles=(5,), err=2.0, seed=9, interval=2),
     {}),
    ("use-alts-off", "options", dict(alleles=(4,), err=0.0, seed=13,
                                     interval=3), dict(use_alts=False)),
    ("no-error-correction", "options",
     dict(alleles=(6,), err=1.0, seed=15, interval=3),
     dict(error_correction=False)),
    ("exclude-allele", "options",
     dict(alleles=(3,), err=0.0, seed=17, interval=3, exclude=True), {}),
    ("snprate", "options",
     dict(alleles=(2,), err=0.0, snprate=0.2, seed=33, interval=3), {}),
    ("primary-exons", "options",
     dict(alleles=(8, 9), err=0.0, seed=41, interval=3),
     dict(type_primary_exons=True)),
]


def truths(gene, reads):
    """The case's truth allele names."""
    return [sorted(gene.partial)[0] if a == "partial"
            else gene.allele_names[a] for a in reads["alleles"]]


def case_reads(simulate_reads, gene, reads):
    """([(name, seq)], [(name, seq)]) of one case from `simulate_reads`
    (either package's: the same reads from the same seed)."""
    r1, r2, _ = simulate_reads(
        gene, truths(gene, reads), simulate_interval=reads["interval"],
        read_len=reads.get("read_len", 100),
        frag_len=reads.get("frag_len", 250), seed=reads["seed"],
        perbase_errorrate=reads["err"],
        perbase_snprate=reads.get("snprate", 0.0))
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    if reads.get("recombinant"):
        from ..utils.dna import revcomp

        seq, start = recombinant_read(gene.backbone)
        R1.append(("999|L_%d_recombinant" % start, seq))
        R2.append(("999|R_60_40M", revcomp(gene.backbone[60:100])))
    return R1, R2


def panel(gene, reads):
    """The typed panel: the gene, or the gene without its truth for an
    exclude case (tests/test_options.py:61)."""
    if reads.get("exclude"):
        return gene.exclude_alleles(truths(gene, reads))
    return gene


# ---- the kernels at degenerate shapes ---- #

# (N, m, P1): no read, one read, one diagonal and none, fewer diagonals
# than one 128-wide tile, a read width of 1 and of 0
K1_SHAPES = ((0, 16, 50), (1, 16, 50), (1, 100, 1), (3, 1, 127),
             (1, 100, 127), (2, 0, 9), (2, 16, 0), (1, 1, 0))
# (V+1, W, H, K): no haplotype, one, one word per row, one row (the
# sentinel alone), no index and one
K2_SHAPES = ((1, 1, 0, 1), (1, 1, 1, 0), (1, 1, 1, 1), (1, 1, 1, 3),
             (5, 1, 1, 3), (1, 4, 3, 2), (2, 1, 257, 17), (41, 1, 1, 33))
# (gene spec, E, W, budget): no entry, one, reads one base wide, on the
# 104-bp two-indel gene and the variant-free gene
DP_SHAPES = (("two_indels", 0, 8, 2), ("two_indels", 1, 1, 2),
             ("two_indels", 1, 40, 2), ("two_indels", 5, 1, 0),
             ("two_indels", 3, 60, 7), ("identical", 1, 1, 2),
             ("identical", 4, 100, 2))


def k1_operands(n, m, P1, seed=0):
    """(pwm_ext [P1 + m - 1, 5] float32, reads [n, m] int8): a 0/1 PWM
    with a few second bases, codes 0-5 and one out of range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = P1 + m - 1
    pwm = np.zeros((rows, 5), np.float32)
    pwm[np.arange(rows), rng.integers(0, 4, rows)] = 1.0
    pwm[rng.random(rows) < 0.2, 4] = 1.0
    reads = rng.integers(0, 6, (n, m)).astype(np.int8)
    if n and m:
        reads[0, 0] = 9
    return pwm, reads


def k2_operands(V1, W, H, K, seed=0):
    """(links [V1, W] int32 bit patterns with the all-ones sentinel row
    last, vars [H, K] int32 with indices out of range on both sides)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    links = rng.integers(0, 2**32, (V1, W), dtype=np.uint64) \
        .astype(np.uint32)
    links[V1 - 1] = 0xFFFFFFFF
    vars_ = rng.integers(-V1 - 2, V1 + 2, (H, K)).astype(np.int32)
    return links.view(np.int32), vars_


def dp_operands(gene, E, W, seed=0):
    """(reads [E, W] int8, lens [E], starts [E]): backbone windows with a
    substitution, ragged lengths, starts at both ends of the gene."""
    import numpy as np

    from ..utils.dna import encode_seq

    rng = np.random.default_rng(seed)
    P = len(gene.backbone)
    reads = np.full((E, W), 4, np.int8)
    lens = np.zeros(E, np.int32)
    starts = np.zeros(E, np.int32)
    for i in range(E):
        s = int(rng.integers(0, P)) if i else 0
        seq = encode_seq(gene.backbone[s:s + W])
        L = len(seq) if i % 2 == 0 else max(1, len(seq) - 1)
        reads[i, :L] = seq[:L]
        if L > 2:
            reads[i, L // 2] = (reads[i, L // 2] + 1) % 4
        lens[i], starts[i] = L, s
    return reads, lens, starts


# ---- the host contract ---- #

def host_contract(dev, host, k=2):
    """tests/test_production.py's contract between a production result
    and the host engine's: cmpt, exon cmpt, read and pair counts exact,
    the same alleles with prob within 1e-9, the same top-k ranking."""
    pd, ph = dict(dev.prob), dict(host.prob)
    return (dev.cmpt == host.cmpt and dev.exon_cmpt == host.exon_cmpt
            and (dev.num_reads, dev.num_pairs)
            == (host.num_reads, host.num_pairs)
            and set(pd) == set(ph)
            and all(abs(pd[a] - ph[a]) < 1e-9 for a in pd)
            and [a for a, _ in dev.prob[:k]] == [a for a, _ in host.prob[:k]])
