"""typer.em: the staged EM, TRACE stage type.em, ms per sample."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("type.em",), *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
