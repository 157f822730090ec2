"""typer.engine: the host engine's typing of each gene, every TRACE
stage under type. that no other type. stage encloses (pileup, read
haplotypes, the fold, the class statistics, the staged EM), ms per
sample."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("type.",), *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
