"""typer.em: the SQUAREM iterations and pruning (TRACE stage em.solve),
ms per sample, from the program's own calls over the window."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None or not ctx["samples"]:
        return None
    s = sum(c["stages"]["em.solve"]["s"] for c in calls(*ctx["window"])
            if "em.solve" in c["stages"])
    return 1e3 * s / ctx["samples"] if s else None
