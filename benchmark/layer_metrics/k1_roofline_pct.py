"""ops.placement_kernel (K1): the least time of every K1 launch of the
profiled samples, from its shape (peaks.k1_work), over K1's kernel time
in the profiler's trace, in %."""
from peaks import k1_work, least_time


def read(ctx):
    prof, peak = ctx["profile"], ctx["peak"]
    if prof is None or peak is None or not ctx["k1"]:
        return None
    dev = sum(b - a for name, a, b in prof["kernels"]
              if "placement_scores_kernel" in name) / 1e6
    if dev <= 0:
        return None
    least = sum(least_time(*k1_work(n, m, rows), peak)
                for n, m, rows in ctx["k1"] if n and m and rows - m + 1 > 0)
    return 100.0 * least / dev
