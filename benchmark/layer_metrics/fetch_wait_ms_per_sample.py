"""device to host: the host blocked on a device-to-host fetch, the copy
included (TRACE stage sync.fetch), ms per sample, from the program's
own calls over the window."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None or not ctx["samples"]:
        return None
    s = sum(c["stages"]["sync.fetch"]["s"] for c in calls(*ctx["window"])
            if "sync.fetch" in c["stages"])
    return 1e3 * s / ctx["samples"] if s else None
