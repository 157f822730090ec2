"""parallel.production: the host rescue and the class merge, TRACE
stages device.rescue and device.merge, ms per sample of the window."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"], ("device.rescue", "device.merge"),
                          *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
