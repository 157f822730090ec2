"""parallel.e2e: the share of the passes' dispatches (TRACE stage
pass.dispatch) that replayed a CUDA graph rather than capturing one (a
pass.capture inside the dispatch), in %, from the program's own calls
over the window. None where no pass was dispatched, and for a program
that has no pass graphs (no hgtpu_torch.parallel.graphs)."""
import importlib.util


def read(ctx):
    from hgtpu_torch.utils.trace import TRACE

    calls = getattr(TRACE, "calls", None)   # a TRACE of flat totals only
    if calls is None or \
            importlib.util.find_spec("hgtpu_torch.parallel.graphs") is None:
        return None
    dispatched = captured = 0
    for c in calls(*ctx["window"]):
        st = c["stages"]
        dispatched += st.get("pass.dispatch", {"n": 0})["n"]
        captured += st.get("pass.capture", {"n": 0})["n"]
    if not dispatched:
        return None
    return 100.0 * (1.0 - captured / dispatched)
