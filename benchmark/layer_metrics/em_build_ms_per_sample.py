"""typer.em: turning the accumulators' classes into the solver's input
(TRACE stage em.build: cmpt_names, restrict_cmpt, the class matrix), ms
per sample, from the program's own calls over the window."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None or not ctx["samples"]:
        return None
    s = sum(c["stages"]["em.build"]["s"] for c in calls(*ctx["window"])
            if "em.build" in c["stages"])
    return 1e3 * s / ctx["samples"] if s else None
