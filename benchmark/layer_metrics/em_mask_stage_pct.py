"""typer.em: the share of the staged EM's solver stages fed the classes
as allele masks (TRACE counters 100 * em.stages.masks / em.stages), from
the program's own calls over the window.  None for a program whose
calls keep no counters, or whose solver counts no stages."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None:
        return None
    total = dict.fromkeys(("em.stages", "em.stages.masks"), 0.0)
    for c in calls(*ctx["window"]):
        got = c.get("counters", {})
        for k in total:
            total[k] += got.get(k, 0.0)
    if not total["em.stages"]:
        return None
    return 100.0 * total["em.stages.masks"] / total["em.stages"]
