"""CUDA graphs of the production passes (``e2e.ShardedTyper.count_classes``).

Each pass program (place, spell, count) is a fixed chain of kernels for
a given input shape: it never waits on the host, and on a mesh of one
shard its psums are the identity.  Issued eagerly, its thousands of
small launches cost the host far more than the card's work takes.  So
``PassGraphs`` captures each program once per program key and padded
input shape as CUDA graphs and replays them after that.

An entry holds its replay, a static tensor for each host input and the
outputs the program returned while it was captured.  A call copies its
host inputs into the static tensors and replays.  Device inputs (the
spell pass's state, which feeds the count pass) are captured by
address: a call must pass the very tensors the entry captured, else the
entry is captured anew.

K1 stays out of the graphs (``outside_graph``): a capture ends before
each K1 call and starts again after it, and a replay calls K1 from
Python between the two graphs, through ``ops.placement``, so that every
K1 launch is a call of ``ops.placement.placement_scores`` with its
shape, as on the eager path.

Memory.  The caller names a pool for each program, and graphs of one
pool must never run in one call (``begin()`` starts a call): the place
pass, each spell tier and the count pass each take their own.  A replay
writes only its own pool, so it never touches the outputs of a graph
that runs in the same call, and a pass's outputs stay valid until the
call ends.  Graphs of one pool share its memory (a capture reuses what
the pool's earlier captures freed), so a pool holds about its largest
pass, not one copy per shape.  Every typer's cache on one card shares
that card's ``Card``: the pools of all of them stay under a share of the
card's memory (``BUDGET_SHARE``), counted from the caching allocator's
own segments of each pool.  A call that starts past it first gives the
least recently used pools of caches not in a call back to the card,
with their graphs and the graphs that read their outputs.  The card's
lock keeps captures, replays and releases of different threads apart.
"""
from __future__ import annotations

import threading
import warnings
import weakref

import numpy as np
import torch

from ..ops import count_launches, launch_tape
from ..utils.trace import TRACE

BUDGET_SHARE = 8     # the graphs' pools stay under 1/8 of the card's memory

_local = threading.local()      # .capture: what this thread is capturing


def outside_graph(fn, *args):
    """``fn(*args)``, never inside a pass graph: while this thread
    captures one, the capture ends before the call and starts again
    after it, and each replay makes the call between the two graphs,
    its result copied into the tensor the capture handed on."""
    cap = getattr(_local, "capture", None)
    return fn(*args) if cap is None else cap.island(fn, args)


def _flat(outputs):
    return list(outputs) if isinstance(outputs, (tuple, list)) else [outputs]


class _Warmup:
    """The eager warm-up: calls kept out of the graphs run, and their
    results' shapes are noted for the capture."""

    def __init__(self):
        self.shapes = []

    def island(self, fn, args):
        out = fn(*args)
        self.shapes.append((out.shape, out.dtype))
        return out


class _Segments:
    """One capture: graphs between the calls kept out of them.  `steps`
    replays it: each graph, and each call with its result copied into
    the buffer the next graph reads."""

    def __init__(self, pool, shapes, stream):
        self.pool = pool
        self.shapes = iter(shapes)
        self.stream = stream        # the replays' stream, which owns buffers
        self.steps = []
        self.graphs = []            # each graph holds the pool while it lives
        self.nbytes = 0             # the buffers, outside the pool
        self.graph = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self):
        graph, self.graph = self.graph, None
        self.graphs.append(graph)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in seen:
            if "empty" in str(w.message):
                empty = True        # nothing ran since the last call
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if not empty:
            self.steps.append(graph.replay)

    def abort(self):
        if self.graph is not None:
            try:
                self.graph.capture_end()
            except RuntimeError:
                pass                # the first error says why
            self.graph = None

    def island(self, fn, args):
        self.end()
        shape, dtype = next(self.shapes)
        with torch.cuda.stream(self.stream):
            buf = torch.empty(shape, dtype=dtype, device=args[0].device)
        self.nbytes += buf.numel() * buf.element_size()

        def call():
            buf.copy_(fn(*args))

        self.steps.append(call)
        self.begin()
        return buf


class CudaCapture:
    """CUDA graph capture on one card.  Every warm-up and capture runs on
    one side stream: the caching allocator hands a pool's freed memory
    only to allocations on the stream that freed it, so a pool's graphs
    share its memory only when they are captured on one stream."""

    def __init__(self, device):
        self.device = device
        self.side = torch.cuda.Stream(device)

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    def capture(self, run, args, pool):
        """Capture ``run(*args)`` into `pool`: one eager warm-up on the
        side stream (lazy initialisation stays out of the capture), then
        the capture.  Returns (replay, the captured outputs, the bytes
        the capture holds outside the pool).  A replay counts the hand
        kernels' launches it holds."""
        dev, side = self.device, self.side
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream()
            side.wait_stream(cur)
            warm = _Warmup()
            with torch.cuda.stream(side):
                _local.capture = warm
                try:
                    run(*args)
                finally:
                    _local.capture = None
            cur.wait_stream(side)
            seg = _Segments(pool, warm.shapes, cur)
            with torch.cuda.stream(side), launch_tape() as tape:
                _local.capture = seg
                try:
                    seg.begin()
                    outputs = run(*args)
                    seg.end()
                except BaseException:
                    seg.abort()
                    raise
                finally:
                    _local.capture = None
            cur.wait_stream(side)
        steps, graphs = seg.steps, seg.graphs

        def replay(graphs=graphs):
            with torch.cuda.device(dev):
                for step in steps:
                    step()
            count_launches(tape)

        return replay, outputs, seg.nbytes

    def pool_bytes(self, pool):
        """The card memory the caching allocator holds for `pool`."""
        index = torch.device(self.device).index or 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if s["device"] == index
                   and tuple(s.get("segment_pool_id", ())) == tuple(pool))

    @staticmethod
    def release():
        """Give the memory of pools no graph holds back to the card."""
        torch.cuda.empty_cache()


class Card:
    """What the graph caches of one card share: the budget in bytes, the
    capturer (`backend`: ``pool()``, ``capture(run, args, pool) ->
    (replay, outputs, bytes outside the pool)``, ``pool_bytes(pool)`` and
    ``release()``, as ``CudaCapture`` has them), the lock, and the
    caches themselves."""

    _of = {}
    _of_lock = threading.Lock()

    def __init__(self, budget, backend):
        self.budget = budget
        self.backend = backend
        self.lock = threading.RLock()
        self.caches = weakref.WeakSet()
        self._tick = 0

    @classmethod
    def of(cls, device):
        """The card of CUDA device `device`, its budget from its memory."""
        device = torch.device(device)
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        with cls._of_lock:
            card = cls._of.get(index)
            if card is None:
                total = torch.cuda.get_device_properties(index).total_memory
                card = cls._of[index] = cls(
                    total // BUDGET_SHARE,
                    CudaCapture(torch.device("cuda", index)))
        return card

    @property
    def bytes(self):
        """The memory the graphs of every cache on the card hold."""
        with self.lock:
            return sum(c.bytes for c in list(self.caches))

    def tick(self):
        self._tick += 1
        return self._tick


class _Entry:
    __slots__ = ("replay", "inputs", "outputs", "pool", "deps", "nbytes")


class PassGraphs:
    """The graph cache of one typer (see the module's docstring), on
    `card`."""

    def __init__(self, card):
        self.card = card
        self._entries = {}               # signature -> _Entry
        self._pools = {}                 # name -> [handle, bytes, last use]
        self._in_call = False
        with card.lock:
            card.caches.add(self)

    @classmethod
    def for_mesh(cls, mesh):
        """The cache for `mesh` where graphs are valid, one local CUDA
        shard and one rank, on that card's ``Card``; None elsewhere (the
        passes run eagerly)."""
        dev = mesh.devices[0]
        if dev.type != "cuda" or mesh.n_local != 1 or mesh.world != 1:
            return None
        return cls(Card.of(dev))

    def __len__(self):
        return len(self._entries)

    @property
    def budget(self):
        return self.card.budget

    @property
    def bytes(self):
        """The memory this cache's pools and buffers hold."""
        return (sum(p[1] for p in self._pools.values())
                + sum(e.nbytes for e in self._entries.values()))

    def begin(self):
        """Start a call.  Past the card's budget, the least recently used
        pools of the card's caches that are not in a call go, with their
        graphs and the graphs that read their outputs, and their memory
        goes back to the card."""
        card = self.card
        with card.lock:
            self._in_call = True
            gone = False
            while card.bytes > card.budget:
                pools = [(p[2], id(c), c, name)
                         for c in list(card.caches)
                         if c is self or not c._in_call
                         for name, p in c._pools.items()]
                if not pools:
                    break
                _t, _i, cache, name = min(pools)
                cache._drop_pool(name)
                gone = True
            if gone:
                card.backend.release()

    def end(self):
        """End a call: its graphs' outputs may go from now on."""
        with self.card.lock:
            self._in_call = False

    def run(self, key, pool, prog, tables, inputs):
        """``prog(*tables, *inputs)``, replayed from pool `pool`: `inputs`
        are host arrays or device tensors an entry of this cache
        returned in the current call."""
        sig = (key,) + tuple((tuple(a.shape), str(a.dtype)) for a in inputs)
        with self.card.lock:
            e = self._entries.get(sig)
            if e is not None and not all(
                    isinstance(a, np.ndarray) or a is s
                    for a, s in zip(inputs, e.inputs)):
                self._evict(sig)
                e = None
            if e is None:
                with TRACE.stage("pass.capture"):
                    e = self._add(sig, pool, prog, tables, inputs)
            else:
                for a, s in zip(inputs, e.inputs):
                    if isinstance(a, np.ndarray):
                        s.copy_(torch.from_numpy(np.ascontiguousarray(a)),
                                non_blocking=True)
                e.replay()
            self._pools[pool][2] = self.card.tick()
        return e.outputs

    def _add(self, sig, pool, prog, tables, inputs):
        dev = tables[0].device
        backend = self.card.backend
        e = _Entry()
        # a copy even on the CPU, where .to() would share the array
        e.inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, copy=True) if isinstance(a, np.ndarray) else a
            for a in inputs]
        p = self._pools.get(pool)
        if p is None:
            p = self._pools[pool] = [backend.pool(), 0, 0]
        e.replay, e.outputs, e.nbytes = backend.capture(
            prog, tuple(tables) + tuple(e.inputs), p[0])
        p[1] = backend.pool_bytes(p[0])
        e.pool = pool
        e.deps = {s for s, other in self._entries.items()
                  if any(o is a for o in _flat(other.outputs)
                         for a in e.inputs)}
        e.replay()
        self._entries[sig] = e
        return e

    def _drop_pool(self, name):
        """Drop pool `name` with its graphs and the graphs that read their
        outputs (``_evict`` drops the pools left with no graph)."""
        for sig in [s for s, e in self._entries.items() if e.pool == name]:
            self._evict(sig)
        self._pools.pop(name, None)

    def _evict(self, sig):
        """Drop an entry and every entry that captured its outputs, and
        its pool once no graph holds it (a capture cannot share a pool
        whose graphs are gone: it takes a new one)."""
        e = self._entries.pop(sig, None)
        if e is None:
            return
        for s in [s for s, o in self._entries.items() if sig in o.deps]:
            self._evict(s)
        if all(o.pool != e.pool for o in self._entries.values()):
            self._pools.pop(e.pool, None)
