"""Spans of the program's TRACE stages, recorded in traced runs only.

The program's TRACE keeps flat per-stage totals; this wraps its `stage`
method so that each stage also leaves a span (name, start, end, depth,
enclosing stage names) and, while the profiler runs, a profiler range of
the same name.  The readers then count a stage once where stages of one
metric nest.  `record_k1` wraps the K1 entry the program calls
(ops.placement.placement_scores) to keep each launch's shape.
"""
from __future__ import annotations

import contextlib
import threading
import time


class Recorder:
    def __init__(self):
        self.spans = []          # (name, t0, t1, tuple of enclosing names)
        self.k1 = []             # (n, m, pwm rows) per K1 call
        self.k1_on = False
        self.profiling = False
        self._local = threading.local()
        self._undo = []

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def install(self, trace, placement_module):
        real_stage = trace.stage
        rec = self

        @contextlib.contextmanager
        def stage(name):
            st = rec._stack()
            outer = tuple(st)
            st.append(name)
            rf = None
            if rec.profiling:
                import torch
                rf = torch.profiler.record_function(name)
                rf.__enter__()
            t0 = time.perf_counter()
            try:
                with real_stage(name):
                    yield
            finally:
                t1 = time.perf_counter()
                if rf is not None:
                    rf.__exit__(None, None, None)
                st.pop()
                rec.spans.append((name, t0, t1, outer))

        trace.stage = stage
        self._undo.append(lambda: setattr(trace, "stage", real_stage))
        real_k1 = placement_module.placement_scores

        def k1(pwm_ext, reads):
            if rec.k1_on:
                rec.k1.append((int(reads.shape[0]), int(reads.shape[1]),
                               int(pwm_ext.shape[0])))
            return real_k1(pwm_ext, reads)

        placement_module.placement_scores = k1
        self._undo.append(
            lambda: setattr(placement_module, "placement_scores", real_k1))

    def uninstall(self):
        while self._undo:
            self._undo.pop()()


def top_level_seconds(spans, names, t0=None, t1=None):
    """Seconds of the spans named in `names` that no other span of
    `names` encloses (a prefix ending in '.' names every stage under
    it), between t0 and t1 when given."""
    def hit(n):
        return any(n == k or (k.endswith(".") and n.startswith(k))
                   for k in names)

    total = 0.0
    for name, a, b, outer in spans:
        if not hit(name) or any(hit(o) for o in outer):
            continue
        if t0 is not None and (a < t0 or b > t1):
            continue
        total += b - a
    return total
