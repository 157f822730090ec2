# Twin of devel/profile_scale.py: the same regimes, warm-up and report,
# through the port's type_reads on the card (--cpu for the CPU).
"""cProfile the scale-bench typing path (host-side hot spots).

    python -m hgtpu_torch.devel.profile [--cpu] [--sort tottime] [--top 45]
        [--toy]

Replicates the bench's 3,600-allele heterozygous-pair regime (--toy: the
60-allele gene with 4 truths), types it once to warm up, then types it
again under cProfile and prints the top functions by --sort, so host work
(verify.prep, device verify's host side, the rescue, pileup, counting
prep) can be attributed line by line.  cProfile's cost falls on Python
calls and not on native or device work, so it shifts the proportions:
find candidates here, measure with the bench.  Runs on the card; --cpu
is the only way onto the CPU.
"""
import argparse
import cProfile
import io
import pstats
import sys
import time

import torch


def profile(device, toy=False):
    """(pstats.Stats of one warm typing run on `device`, its wall in s,
    the reads typed)."""
    from ..align import GeneAligner
    from ..pipeline import type_reads
    from ..sim import simulate_reads
    from .bench import SCALE, TOY, _build, scale_truths

    if toy:
        ref = _build("A", *TOY)
        truths = ref.allele_names[:4]
        seed = None
    else:
        ref = _build("A", *SCALE, scale=True)
        truths = scale_truths(ref)
        seed = 1
    aligner = GeneAligner(ref, device=device)
    kw = {} if seed is None else {"seed": seed}
    r1, r2, _ = simulate_reads(ref, truths, simulate_interval=1, **kw)
    reads_1 = [(r.name, r.seq) for r in r1]
    reads_2 = [(r.name, r.seq) for r in r2]
    n = len(reads_1) + len(reads_2)
    print("[profile] %d reads, %d alleles, device=%s"
          % (n, ref.n_alleles, device), file=sys.stderr)

    cuda = device.type == "cuda"
    type_reads(ref, reads_1, reads_2, aligner=aligner)     # warm-up
    if cuda:
        torch.cuda.synchronize(device)
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    type_reads(ref, reads_1, reads_2, aligner=aligner)
    if cuda:
        torch.cuda.synchronize(device)
    pr.disable()
    dt = time.time() - t0
    return pstats.Stats(pr, stream=io.StringIO()), dt, n


def top_lines(stats, sort="tottime", top=45):
    """The report's text: stats sorted by `sort`, the first `top` rows."""
    buf = io.StringIO()
    stats.stream = buf
    stats.sort_stats(sort).print_stats(top)
    return buf.getvalue()


def main(argv=None):
    from ..cli.main import pick_device

    ap = argparse.ArgumentParser(prog="hgtpu_torch.devel.profile")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sort", default="tottime")
    ap.add_argument("--top", type=int, default=45)
    ap.add_argument("--toy", action="store_true")
    args = ap.parse_args(argv)
    device = pick_device("cpu" if args.cpu else "cuda")
    stats, dt, n = profile(device, toy=args.toy)
    print("[profile] measured wall %.3f s (%.1f reads/s)" % (dt, n / dt),
          file=sys.stderr)
    print(top_lines(stats, args.sort, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
