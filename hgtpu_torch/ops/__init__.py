"""The port's device operations and its hand-written kernels."""
import contextlib
import threading

_capture = threading.local()


def count_launch(fn):
    """One launch of the hand kernel `fn`: counted on ``fn.launches``, or,
    while this thread captures a CUDA graph (``launch_tape``), noted for
    the graph's replays to count."""
    tape = getattr(_capture, "tape", None)
    if tape is None:
        fn.launches += 1
    else:
        tape.append(fn)


@contextlib.contextmanager
def launch_tape():
    """Inside, this thread's hand-kernel launches are captured, not run:
    they are noted in the list it yields, and each replay of the capture
    counts them with ``count_launches``."""
    prev = getattr(_capture, "tape", None)
    _capture.tape = tape = []
    try:
        yield tape
    finally:
        _capture.tape = prev


def count_launches(tape):
    """Count the launches a replayed capture holds (``launch_tape``)."""
    for fn in tape:
        fn.launches += 1


def launch_counts():
    """Each hand kernel's launches since its counter was last set to 0:
    K1 (placement_scores), K2's two variants, the two banded DP kernels,
    the verify prep's proposal bound."""
    from .banded_dp import banded_costs_bits, banded_costs_warp
    from .compat_kernel import and_reduce_slab, and_reduce_wide
    from .placement_kernel import placement_scores
    from .proposal_bound import proposal_bound

    return {"placement_scores": placement_scores.launches,
            "and_reduce_slab": and_reduce_slab.launches,
            "and_reduce_wide": and_reduce_wide.launches,
            "banded_dp_bits": banded_costs_bits.launches,
            "banded_dp_warp": banded_costs_warp.launches,
            "proposal_bound": proposal_bound.launches}
