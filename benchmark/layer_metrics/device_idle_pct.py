"""device: the share of the profiled span in which no kernel ran, in %
(busy time is the union of the kernel events, devtrace.reduce)."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
