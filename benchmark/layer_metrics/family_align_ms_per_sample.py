"""align.family: each gene's alignment of its routed reads, both rounds
(TRACE stage family.align; verify runs inside it), ms per sample. None
for a program that has no such stage."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("family.align",), *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
