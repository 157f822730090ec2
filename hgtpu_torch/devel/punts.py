# Twin of devel/measure_punts.py: the same gene builds, truths, seed and
# prints, over a mesh of the port's shards; a function returns the numbers.
"""Punt/excl rates and tier distribution of the production program.

    python -m hgtpu_torch.devel.punts [scale|toy] [--shards N]
        [--device DEV]

Builds the scale panel (3,600 alleles / 3.5 kb) or the toy gene
(60 alleles / 3 kb) at min_var_freq 0.1, simulates the heterozygous pair
allele_names[123 % n] and [2047 % n] at interval 1 (seed 1), and runs
`ShardedTyper(gene, mesh=make_mesh(shards, device)).count_classes` once:
the punt and exclusion rates, the punted mates' causes [amb, trim, tie,
trunc], the tier-1-certified punt mates, the window candidate tiers of
the catalog indels, and the punted reads' truth anatomy (indel operations
in the truth CIGAR by punt cause).  It evaluates the pair hypothesis and
the tiering without a typing run.

One shard on the card by default; --device (or HGTPU_TORCH_DEVICE) puts
every shard on that device, `cpu` included.  hgtpu's script ran 8 virtual
CPU devices as a stand-in for a TPU slice.
"""
import argparse
import time
from collections import Counter

import numpy as np

from . import use_synth

CAUSES = ("amb", "trim", "tie", "trunc")


def build(which="scale"):
    """(gene, reads_1, reads_2) of the scale panel or the toy gene."""
    use_synth()
    from synth import make_gene_msa, make_hla_scale_msa

    from ..db import build_gene_ref
    from ..sim import simulate_reads

    if which == "scale":
        spec = make_hla_scale_msa(n_alleles=3600, length=3500)
    else:
        spec = make_gene_msa(seed=0, n_alleles=60, length=3000)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"],
                            exons_ref_coords=spec.get("exons"),
                            min_var_freq=0.1)
    truths = [ref.allele_names[123 % ref.n_alleles],
              ref.allele_names[2047 % ref.n_alleles]]
    r1, r2, _ = simulate_reads(ref, truths, simulate_interval=1, seed=1)
    return ref, r1, r2


def punt_stats(ref, r1, r2, mesh):
    """count_classes of the read pairs on `mesh`, and what the punts are
    made of.  Returns a dict: pairs, punt, excl, wall (s), causes (mates
    per cause bit, CAUSES order), tier1 (certified punt mates), indels,
    max_shift, window (fractions of start positions whose read window
    meets 0, 1 and 2+ catalog indels) and anatomy ({(truth indel ops,
    cause bits): mates})."""
    from ..db.catalog import VT_DELETION, VT_INSERTION
    from ..parallel.e2e import ShardedTyper
    from ..sim import parse_truth_name

    st = ShardedTyper(ref, mesh=mesh)
    c1 = st.encode([r.seq for r in r1])
    c2 = st.encode([r.seq for r in r2])
    t0 = time.perf_counter()
    out = st.count_classes(c1, c2)
    wall = time.perf_counter() - t0
    punted = out["punt"]
    causes = np.zeros(4, np.int64)
    for mi in range(2):
        cz = out["winner"][mi]["causes"][punted]
        for b in range(4):
            causes[b] += int(((cz >> b) & 1).sum())
    tier1 = int(out["winner"][0]["tier1"][punted].sum()
                + out["winner"][1]["tier1"][punted].sum())

    # tier distribution (wide candidate window, per mate)
    idx = np.flatnonzero((ref.var_type == VT_DELETION)
                         | (ref.var_type == VT_INSERTION))
    pos = np.sort(ref.var_pos[idx])
    ms = int(ref.var_len[idx].max()) if len(idx) else 0
    W = 100
    # approximate s0 by truth positions: uniform over backbone
    P = len(ref.backbone)
    s = np.arange(P - W)
    lo = np.searchsorted(pos, s - 2 * ms)
    hi = np.searchsorted(pos, s + W + ms, side="right")
    cnt = hi - lo
    frac0 = float((cnt == 0).mean())
    frac1 = float((cnt == 1).mean())

    # punted-read truth anatomy: how many indel operations does each
    # punted mate's TRUTH CIGAR hold, and which punt cause fired?
    anat = Counter()
    for mi, reads in enumerate((r1, r2)):
        cz = out["winner"][mi]["causes"]
        for i in np.flatnonzero(punted):
            cig = parse_truth_name(reads[i].name)["cigar"]
            nd = cig.count("D") + cig.count("I")
            anat[(nd, int(cz[i]))] += 1
    return dict(pairs=len(r1), punt=int(punted.sum()),
                excl=int(out["excl"].sum()), wall=wall,
                causes=causes.tolist(), tier1=tier1, indels=len(idx),
                max_shift=ms, window=(frac0, frac1, 1 - frac0 - frac1),
                anatomy=dict(sorted(anat.items())))


def report(which, ref, stats, device):
    """hgtpu's prints of one punt_stats result."""
    n = stats["pairs"]
    punt, excl = stats["punt"], stats["excl"]
    print(f"{which}: {ref.n_alleles} alleles, {n} pairs")
    print(f"punt {punt}/{n} = {punt/n:.3%}  excl {excl}/{n} = {excl/n:.3%}"
          f"  (wall {stats['wall']:.1f}s {device})")
    print("punt mate-causes [amb, trim, tie, trunc]:", stats["causes"])
    print(f"tier1-certified punt mates: {stats['tier1']} / {2*punt}")
    f0, f1, f2 = stats["window"]
    print(f"indels={stats['indels']} max_shift={stats['max_shift']}; window "
          f"cand count: 0:{f0:.2%} 1:{f1:.2%} 2+:{f2:.2%}")
    for (nd, cause), c in stats["anatomy"].items():
        tags = [t for b, t in enumerate(CAUSES) if (cause >> b) & 1] \
            or ["none"]
        print(f"  truth_indel_ops={nd} cause={'+'.join(tags)}: {c}")


def main(argv=None):
    from ..cli.main import pick_device
    from ..parallel.sharded import make_mesh

    p = argparse.ArgumentParser(prog="hgtpu_torch.devel.punts")
    p.add_argument("which", nargs="?", default="scale",
                   choices=("scale", "toy"))
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="the shards' device (default: HGTPU_TORCH_DEVICE, "
                        "else the card)")
    args = p.parse_args(argv)
    device = pick_device(args.device)
    ref, r1, r2 = build(args.which)
    stats = punt_stats(ref, r1, r2, make_mesh(args.shards, device))
    report(args.which, ref, stats, device)
    return stats


if __name__ == "__main__":
    main()
