"""align.panel: the family router's encode, K1 product over every gene's
PWM, segment max and fetch (TRACE stage family.route), ms per sample.
None for a program whose router has no such stage."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("family.route",), *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
