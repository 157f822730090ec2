"""parallel.e2e: the place, spell and count passes, TRACE stages
device.place, device.spell and device.countB, ms per sample."""
from spans import top_level_seconds


def read(ctx):
    s = top_level_seconds(ctx["spans"],
                          ("device.place", "device.spell", "device.countB"),
                          *ctx["window"])
    return 1e3 * s / ctx["samples"] if s and ctx["samples"] else None
