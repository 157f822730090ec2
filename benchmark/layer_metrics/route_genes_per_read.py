"""align.panel: genes a read is aligned in, over the router's reads
(TRACE counters (route.candidates + route.second_genes) / route.reads,
both rounds), from the program's own calls over the window.  None for a
program whose calls keep no counters, or whose router counts none."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None:
        return None
    total = dict.fromkeys(("route.reads", "route.candidates",
                           "route.second_genes"), 0.0)
    for c in calls(*ctx["window"]):
        got = c.get("counters", {})
        for k in total:
            total[k] += got.get(k, 0.0)
    if not total["route.reads"]:
        return None
    return (total["route.candidates"] + total["route.second_genes"]) \
        / total["route.reads"]
