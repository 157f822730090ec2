# Port of hgtpu/utils/trace.py: the flat totals and counters are a copy;
# the spans, calls and profiler ranges are the port's own.
"""Per-stage wall-time tracing.

The typing path interleaves host numpy/C++ stages with device
launches, so the only way to know where reads/s go is to time each
stage.  This TRACE is the port's own: hgtpu's runs keep theirs.

Usage:

    from hgtpu_torch.utils.trace import TRACE
    with TRACE.stage("place.dispatch"):
        ...
    TRACE.summary()   # {stage: {"s": total, "n": calls}}
    TRACE.report(sys.stderr)
    TRACE.calls()     # per call: {stage: {"s", "self", "n"}}, spans,
                      # counters

Besides the flat totals, every stage is a span (name, start, end,
parent) on its thread's stack.  A stage opened with no stage open on
its thread starts a *call* under a fresh integer id (typing one sample
through `pipeline.type_reads` is one call, under its root stage
`call.type_reads`); the spans of the last MAX_CALLS finished calls are
kept, at most MAX_SPANS each.  All stamps are `time.perf_counter()`.
`TRACE.count` adds to the flat counters and, inside a stage, to the
open call's own counters too, so a reader can count over a window's
calls (the family router's `route.*` counters, `align/family.py`).
While a torch.profiler session records, each stage also opens a
`torch.profiler.record_function` range of its own name, so the
profiler's timeline carries the stages, nested as the spans are.

Collection cost is two perf_counter calls, a few appends and a dict
update per block — stages are chunk-granular, never per-read, so it
stays on by default.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from array import array
from collections import deque

MAX_CALLS = 1024      # finished calls kept
MAX_SPANS = 1024      # spans kept per call; later ones count as dropped


class _Call:
    """One call's spans: their names, and per span three doubles in
    `times`: start, end (0.0 while open) and the index of the enclosing
    span (-1 at the root); and the counters counted inside it."""

    __slots__ = ("id", "t0", "t1", "names", "times", "dropped", "counters")

    def __init__(self, cid, t0):
        self.id = cid
        self.t0 = t0
        self.t1 = None
        self.names = []
        self.times = array("d")
        self.dropped = 0
        self.counters = {}

    def spans(self):
        t = self.times
        return [(name, t[3 * i], t[3 * i + 1], int(t[3 * i + 2]))
                for i, name in enumerate(self.names)]

    def stages(self):
        """{name: {"s": inclusive seconds, a span nested in one of the
        same name counted once, "self": seconds less the children's,
        "n": spans}}."""
        spans = self.spans()
        child = [0.0] * len(spans)
        for _name, a, b, p in spans:
            if p >= 0 and b:
                child[p] += b - a
        out = {}
        for i, (name, a, b, p) in enumerate(spans):
            if not b:
                continue
            d = out.get(name)
            if d is None:
                d = out[name] = {"s": 0.0, "self": 0.0, "n": 0}
            d["n"] += 1
            d["self"] += b - a - child[i]
            while p >= 0 and spans[p][0] != name:
                p = spans[p][3]
            if p < 0:
                d["s"] += b - a
        return out

    def record(self):
        return {"id": self.id, "t0": self.t0, "t1": self.t1,
                "stages": self.stages(), "spans": self.spans(),
                "dropped": self.dropped, "counters": dict(self.counters)}


# torch.autograd._profiler_enabled once torch has loaded; this module
# never imports torch itself
_PROFILER_ON = [None]


class _Stage:
    """The context manager of one `StageTimer.stage` block."""

    __slots__ = ("timer", "name", "t0", "call", "idx", "depth", "rf")

    def __init__(self, timer, name):
        self.timer = timer
        self.name = name

    def __enter__(self):
        # the span holds the stage's own bookkeeping and profiler range:
        # a wrapper timing the stage from outside reads nearly the same
        t0 = self.t0 = time.perf_counter()
        local = self.timer._local
        stack = local.__dict__.get("stack")
        if stack is None:
            stack = local.stack = []
        if stack:
            call = self.call = local.call
            parent = stack[-1]
        else:
            call = self.call = local.call = _Call(next(self.timer._ids), t0)
            parent = -1
        self.depth = len(stack)
        names = call.names
        if len(names) < MAX_SPANS:
            self.idx = len(names)
            names.append(self.name)
            call.times.extend((t0, 0.0, parent))
            stack.append(self.idx)
        else:
            # a dropped span's children hang under its nearest kept
            # ancestor
            self.idx = -1
            call.dropped += 1
            stack.append(parent)
        on = _PROFILER_ON[0]
        if on is None:
            on = _PROFILER_ON[0] = getattr(sys.modules.get("torch.autograd"),
                                           "_profiler_enabled", None)
        if on is not None and on():
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        timer = self.timer
        name = self.name
        dt = time.perf_counter() - self.t0
        with timer._lock:
            timer._s[name] = timer._s.get(name, 0.0) + dt
            timer._n[name] = timer._n.get(name, 0) + 1
        call = self.call
        local = timer._local
        ends_call = False
        if local.call is call:
            # truncating, not popping, also closes a stage entered inside
            # this one and never left
            stack = local.stack
            del stack[self.depth:]
            ends_call = not stack
        # the span ends last, its own bookkeeping inside it
        t1 = time.perf_counter()
        if self.idx >= 0:
            call.times[3 * self.idx + 1] = t1
        if ends_call:
            call.t1 = t1
            timer._calls.append(call)
            local.call = None
        return False


class StageTimer:
    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._calls = deque(maxlen=MAX_CALLS)
        self.reset()

    def reset(self):
        with self._lock:
            self._s = {}
            self._n = {}
            self._c = {}
            self._calls.clear()

    def count(self, name, value):
        """Accumulate a named scalar counter (e.g. dispatched FLOPs), in
        the flat totals and in the call open on this thread, if any."""
        with self._lock:
            self._c[name] = self._c.get(name, 0.0) + value
        call = self._local.__dict__.get("call")
        if call is not None:
            call.counters[name] = call.counters.get(name, 0.0) + value

    def counters(self):
        with self._lock:
            return dict(self._c)

    def stage(self, name):
        """A context manager timing one block as the stage `name`."""
        return _Stage(self, name)

    def add(self, name, dt, n=1):
        with self._lock:
            self._s[name] = self._s.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + n

    def calls(self, t0=None, t1=None):
        """The kept calls that started at or after t0 and ended at or
        before t1 (perf_counter seconds; None is unbounded), oldest
        first: {"id", "t0", "t1", "stages": {name: {"s", "self",
        "n"}}, "spans": [(name, start, end, parent index)], "dropped",
        "counters": {name: total counted inside the call}}.
        """
        return [c.record() for c in list(self._calls)
                if (t0 is None or c.t0 >= t0)
                and (t1 is None or c.t1 <= t1)]

    def summary(self):
        with self._lock:
            return {k: {"s": self._s[k], "n": self._n[k]}
                    for k in sorted(self._s)}

    def total(self, prefix=""):
        """Sum of stage seconds under a dotted prefix ("" = all)."""
        with self._lock:
            return sum(v for k, v in self._s.items()
                       if not prefix or k == prefix
                       or k.startswith(prefix + "."))

    def report(self, file=None, min_s=0.0):
        file = file or sys.stderr
        summ = self.summary()
        if not summ:
            return
        width = max(len(k) for k in summ)
        grand = sum(v["s"] for v in summ.values())
        print("[trace] %-*s %10s %8s %6s" % (width, "stage", "seconds",
                                             "calls", "share"), file=file)
        for k, v in sorted(summ.items(), key=lambda kv: -kv[1]["s"]):
            if v["s"] < min_s:
                continue
            print("[trace] %-*s %10.3f %8d %5.1f%%"
                  % (width, k, v["s"], v["n"],
                     100.0 * v["s"] / grand if grand else 0.0), file=file)


TRACE = StageTimer()


def to_host(t):
    """A device tensor (or a mesh's sharded output) on the host as a
    numpy array: the host's wait on the device plus the copy, timed as
    the stage sync.fetch."""
    with TRACE.stage("sync.fetch"):
        return t.cpu().numpy()
