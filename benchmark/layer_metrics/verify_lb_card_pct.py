"""align.aligner verify: the share of the verify prep's proposal entries
whose lower bound ran on the card (TRACE counters 100 * verify.lb.card /
verify.lb.entries), from the program's own calls over the window.  None
for a program whose calls keep no counters, or whose aligner counts no
bounded entries."""


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None:
        return None
    total = dict.fromkeys(("verify.lb.entries", "verify.lb.card"), 0.0)
    for c in calls(*ctx["window"]):
        got = c.get("counters", {})
        for k in total:
            total[k] += got.get(k, 0.0)
    if not total["verify.lb.entries"]:
        return None
    return 100.0 * total["verify.lb.card"] / total["verify.lb.entries"]
