"""align.aligner verify: every TRACE stage under verify. that no other
verify stage encloses (native and device verify), ms per sample."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("verify.",), *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
