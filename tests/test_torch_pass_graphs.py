"""The passes' graph cache (hgtpu_torch.parallel.graphs) on the CPU, with
a stub capturer in place of CUDA graph capture: a stub "graph" keeps the
outputs of its first run and rewrites them in place on each replay, as a
replayed CUDA graph does.

The cache's bookkeeping (a miss, then hits; one key per padded shape;
past the byte budget, the least recently used pools given back at the
start of a call, with the entries that read their outputs, over every
cache of one card but never a cache in a call; a stale device input
captured anew; one pass.capture span per miss, inside pass.dispatch;
calls kept out of a graph; hand-kernel launches a capture notes for its
replays to count), then count_classes
through the cache bit for bit against the eager passes: tiered and fused,
single and paired, the A, B, A key sequence and the class-cap overflow.
A CPU mesh and a two-shard mesh never take the graphed path."""
import numpy as np
import pytest
import torch

from hgtpu_torch.parallel import graphs
from hgtpu_torch.parallel.graphs import Card, PassGraphs
from hgtpu_torch.utils.trace import TRACE
from tests.torch_threads import _torch_threads  # noqa: F401


class Stub:
    """A capturer whose graph reruns the program into its first outputs;
    `log` lists (program, pool) per capture, a pool holds `nbytes` a
    capture, `released` counts the times the cache gave pools back."""

    def __init__(self, nbytes=100):
        self.nbytes = nbytes
        self.log = []
        self.pools = 0
        self.released = 0

    def pool(self):
        self.pools += 1
        return self.pools

    def capture(self, run, args, pool):
        outs = run(*args)
        flat = list(outs) if isinstance(outs, tuple) else [outs]
        self.log.append((run, pool))

        def replay():
            new = run(*args)
            for o, n in zip(flat, list(new) if isinstance(new, tuple)
                            else [new]):
                o.copy_(n)
        return replay, outs, 0

    def pool_bytes(self, pool):
        return self.nbytes * sum(p == pool for _r, p in self.log)

    def release(self):
        self.released += 1


TABLES = (torch.arange(4, dtype=torch.int32),)


def double(tab, x):
    return x * 2 + tab[0]


def both(tab, x, y):
    return x + y, x - y


def call(cache, key, prog, *inputs, pool=None):
    """One cache call inside pass.dispatch, as count_classes makes it (by
    default each key in a pool of its own); returns (outputs, the call's
    TRACE record)."""
    with TRACE.stage("test.root"):
        with TRACE.stage("pass.dispatch"):
            out = cache.run(key, key if pool is None else pool, prog,
                            TABLES, inputs)
    return out, TRACE.calls()[-1]


def test_a_miss_then_hits_for_the_same_key():
    cap = Stub()
    g = PassGraphs(Card(10 ** 6, cap))
    a = np.arange(6, dtype=np.int32)
    out, _ = call(g, "p", double, a)
    assert torch.equal(out, torch.from_numpy(a * 2))
    first = out
    for k in range(3):
        b = np.arange(6, dtype=np.int32) + k
        out, _ = call(g, "p", double, b)
        assert out is first                       # the captured outputs
        assert torch.equal(out, torch.from_numpy(b * 2))
    assert len(cap.log) == 1 and len(g) == 1
    assert np.array_equal(a, np.arange(6))        # the input untouched


def test_distinct_keys_for_distinct_padded_shapes_and_programs():
    cap = Stub()
    g = PassGraphs(Card(10 ** 6, cap))
    for n in (4, 8, 4, 8):
        call(g, "p", double, np.zeros(n, np.int32))
    call(g, "q", double, np.zeros(4, np.int32))
    call(g, "p", double, np.zeros(4, np.int64))
    assert len(cap.log) == 4 and len(g) == 4
    # one pool per name: the shapes of "p" share one
    assert [p for _r, p in cap.log] == [1, 1, 2, 1]


def test_one_capture_span_per_miss_inside_pass_dispatch():
    g = PassGraphs(Card(10 ** 6, Stub()))
    for n, miss in ((4, True), (4, False), (8, True), (4, False)):
        _, rec = call(g, "p", double, np.zeros(n, np.int32))
        names = {name: p for name, _a, _b, p in rec["spans"]}
        if miss:
            assert rec["stages"]["pass.capture"]["n"] == 1
            parent = rec["spans"][names["pass.capture"]][0]
            assert parent == "pass.dispatch"
        else:
            assert "pass.capture" not in rec["stages"]


def test_least_recently_used_pools_go_past_the_budget():
    """Each key in a pool of its own, 100 bytes each: a call that starts
    past 250 gives back the least recently used pools first."""
    cap = Stub(nbytes=100)
    g = PassGraphs(Card(250, cap))

    def go(n):
        return call(g, "p%d" % n, double, np.zeros(n, np.int32))

    for n in (1, 2, 1):                             # 1 is now the newest
        g.begin()
        go(n)
    g.begin()
    go(3)
    assert len(g) == 3 and g.bytes == 300 and cap.released == 0
    g.begin()                                       # 300 > 250: 2 goes
    assert len(g) == 2 and g.bytes == 200 and cap.released == 1
    go(1)
    assert len(cap.log) == 3                        # 1 stayed
    go(2)
    assert len(cap.log) == 4 and g.bytes == 300


def test_a_pool_goes_whole_and_never_inside_a_call():
    """Shapes of one pool share it: the bytes stay until the pool goes,
    and a call keeps every graph it ran however far past the budget."""
    cap = Stub(nbytes=100)
    g = PassGraphs(Card(150, cap))
    g.begin()
    outs = [call(g, "p%d" % n, double, np.zeros(n, np.int32),
                 pool="one")[0] for n in (1, 2, 3)]
    assert len(g) == 3 and g.bytes == 300 and cap.released == 0
    assert [o.shape[0] for o in outs] == [1, 2, 3]
    assert [p for _r, p in cap.log] == [1, 1, 1]
    g.begin()
    assert len(g) == 0 and g.bytes == 0 and cap.released == 1
    call(g, "p4", double, np.zeros(4, np.int32), pool="one")
    assert cap.log[-1][1] == 2 and g.bytes == 100    # a new pool


def test_a_consumer_goes_with_its_producer_and_stale_inputs_recapture():
    cap = Stub(nbytes=100)
    g = PassGraphs(Card(10 ** 6, cap))
    x = np.arange(5, dtype=np.int32)
    s, _ = call(g, "spell", double, x)
    c, _ = call(g, "count", both, s, s)
    assert torch.equal(c[0], torch.from_numpy(4 * x))
    # the consumer replays on the producer's new outputs
    s2, _ = call(g, "spell", double, x + 1)
    c2, _ = call(g, "count", both, s2, s2)
    assert s2 is s and c2 is c and len(cap.log) == 2
    assert torch.equal(c2[0], torch.from_numpy(4 * (x + 1)))
    # a device input that is not the captured tensor: captured anew,
    # into a new pool, as no graph holds the old one any more
    other = torch.from_numpy(x.copy())
    c3, _ = call(g, "count", both, other, other)
    assert len(cap.log) == 3 and c3 is not c
    assert cap.log[2][1] != cap.log[1][1] and len(g._pools) == 2
    assert torch.equal(c3[1], torch.zeros(5, dtype=torch.int32))
    # evicting the producer takes the consumers that captured its outputs
    c4, _ = call(g, "count", both, s, s)
    assert len(cap.log) == 4 and len(g) == 2
    g._evict(next(k for k in g._entries if k[0] == "spell"))
    assert len(g) == 0


def test_the_caches_of_one_card_share_its_budget():
    """Two typers' caches on one card of 250 bytes, 100 bytes a pool: the
    least recently used pool of the card goes first, whichever cache
    holds it, and a cache in a call keeps every pool."""
    cap = Stub(nbytes=100)
    card = Card(250, cap)
    a, b = PassGraphs(card), PassGraphs(card)

    def go(g, name):
        g.begin()
        call(g, name, double, np.zeros(3, np.int32))
        g.end()

    go(a, "a1")
    go(b, "b1")
    go(a, "a2")
    assert (a.bytes, b.bytes, card.bytes) == (200, 100, 300)
    go(b, "b1")                          # 300 > 250: a's a1 goes
    assert (a.bytes, b.bytes) == (100, 100) and cap.released == 1
    go(a, "a1")
    assert card.bytes == 300
    b.begin()                            # past the budget: a2 goes
    assert (a.bytes, b.bytes) == (100, 100) and cap.released == 2
    call(b, "b2", double, np.zeros(3, np.int32))
    assert card.bytes == 300
    a.begin()                            # b is in a call: a's own a1 goes
    assert (a.bytes, b.bytes) == (0, 200) and cap.released == 3
    call(a, "a3", double, np.zeros(3, np.int32))
    a.end()
    b.end()
    a.begin()                            # b1 is now the oldest pool
    assert (a.bytes, b.bytes) == (100, 100) and cap.released == 4
    a.end()
    assert set(card.caches) == {a, b}
    del a
    assert set(card.caches) == {b} and card.bytes == 100


def test_calls_kept_out_of_a_graph():
    """Outside a capture ``outside_graph`` makes the call; inside one the
    capture takes it (a CUDA capture ends its graph there and replays
    the call from Python between two graphs)."""
    x = torch.arange(3)
    assert torch.equal(graphs.outside_graph(double, TABLES[0], x),
                       double(TABLES[0], x))

    class Capture:
        def __init__(self):
            self.calls = []

        def island(self, fn, args):
            self.calls.append((fn, args))
            return "buffer"

    cap = Capture()
    graphs._local.capture = cap
    try:
        assert graphs.outside_graph(double, TABLES[0], x) == "buffer"
    finally:
        graphs._local.capture = None
    assert cap.calls == [(double, (TABLES[0], x))]
    warm = graphs._Warmup()
    out = warm.island(double, (TABLES[0], x))
    assert torch.equal(out, double(TABLES[0], x))
    assert warm.shapes == [(out.shape, out.dtype)]


def test_a_capture_notes_launches_for_its_replays():
    from hgtpu_torch.ops import count_launch, count_launches, launch_tape

    def kernel():
        pass

    kernel.launches = 0
    count_launch(kernel)
    with launch_tape() as tape:
        count_launch(kernel)              # captured, not run
        count_launch(kernel)
        with launch_tape() as inner:
            count_launch(kernel)
        count_launch(kernel)
    assert kernel.launches == 1 and tape == [kernel] * 3
    assert inner == [kernel]
    for _replay in range(2):
        count_launches(tape)
    assert kernel.launches == 7
    count_launch(kernel)
    assert kernel.launches == 8


def test_no_graphs_on_the_cpu_or_on_two_shards():
    from hgtpu_torch.parallel.sharded import Mesh, make_mesh

    assert PassGraphs.for_mesh(Mesh(["cpu"])) is None
    assert PassGraphs.for_mesh(make_mesh(2, "cpu")) is None
    # decided from the mesh before any card is asked for
    assert PassGraphs.for_mesh(Mesh(["cuda:0", "cuda:0"])) is None


# ------------------------------------------------------------------ #
# count_classes through the cache against the eager passes
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def gene():
    from hgtpu_torch.db import build_gene_ref
    from synth import make_gene_msa

    spec = make_gene_msa(seed=3, n_alleles=40)
    g, _ = build_gene_ref("A", spec["names"], spec["rows"],
                          spec["ref_allele"], min_var_freq=8.0)
    return g


@pytest.fixture(scope="module")
def samples(gene):
    """Two read sets of different sizes (keys A and B), 5 % errors."""
    from hgtpu_torch.sim import simulate_reads

    out = []
    for interval, seed in ((3, 11), (7, 12)):
        r1, r2, _ = simulate_reads(gene, gene.allele_names[:2],
                                   simulate_interval=interval, read_len=100,
                                   frag_len=250, seed=seed,
                                   perbase_errorrate=5.0)
        out.append(([r.seq for r in r1], [r.seq for r in r2]))
    return out


def same(got, want):
    assert list(got["levels"]) == list(want["levels"])
    for name, parts in want["levels"].items():
        for g, w in zip(got["levels"][name], parts):
            assert np.array_equal(g, w), name
        assert np.array_equal(got["order"][name], want["order"][name])
    for k in ("pileup", "punt", "excl"):
        assert np.array_equal(got[k], want[k]), k
    assert (got["n_reads"], got["n_pairs"]) == (want["n_reads"],
                                                want["n_pairs"])
    for gw, ww in zip(got["winner"], want["winner"]):
        for k in ww:
            assert np.array_equal(gw[k], ww[k]), k


@pytest.mark.parametrize("spell", ["auto", "off"])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("cap", [2048, 8])
def test_count_classes_through_graphs_equals_eager(gene, samples,
                                                   monkeypatch, spell,
                                                   paired, cap):
    """A, B, A: B's passes replay between A's capture and A's replay; the
    second A captures nothing.  A class cap of 8 takes the overflow
    refetch from the count graph's outputs."""
    from hgtpu_torch.parallel.e2e import ShardedTyper

    monkeypatch.setenv("HGTPU_FUSED_SPELL", spell)
    eager = ShardedTyper(gene, "cpu", class_cap=cap)
    graphed = ShardedTyper(gene, "cpu", class_cap=cap)
    assert eager._graphs is None
    stub = Stub()
    graphed._graphs = PassGraphs(Card(10 ** 9, stub))

    def codes(st, k):
        r1, r2 = samples[k]
        return st.encode(r1), st.encode(r2) if paired else None

    want = [eager.count_classes(*codes(eager, k)) for k in (0, 1)]
    for step, k in enumerate((0, 1, 0)):
        n_before = len(stub.log)
        with TRACE.stage("test.root"):
            got = graphed.count_classes(*codes(graphed, k))
        same(got, want[k])
        st = TRACE.calls()[-1]["stages"]
        assert st["pass.dispatch"]["n"] >= 2
        if step == 0:
            assert st["pass.capture"]["n"] == st["pass.dispatch"]["n"]
        elif step == 1:
            assert st["pass.capture"]["n"] >= 1    # B's shapes are new
        else:
            assert "pass.capture" not in st and len(stub.log) == n_before
    # place, each spell tier and count in pools of their own, whatever
    # the shapes: a pool per pass of one call, and count's graphs of A and
    # B in one
    pools = {}
    for k, e in graphed._graphs._entries.items():
        pools.setdefault(e.pool, []).append(k[0])
    assert stub.pools == len(pools)
    assert len(pools["count"]) == 2 and len(graphed._graphs) > len(pools)


def test_eager_paths_record_no_capture(gene, samples):
    from hgtpu_torch.parallel.e2e import ShardedTyper
    from hgtpu_torch.parallel.sharded import make_mesh

    for st in (ShardedTyper(gene, "cpu"),
               ShardedTyper(gene, mesh=make_mesh(2, "cpu"))):
        assert st._graphs is None
        r1, r2 = samples[1]
        with TRACE.stage("test.root"):
            st.count_classes(st.encode(r1), st.encode(r2))
        st_ = TRACE.calls()[-1]["stages"]
        assert st_["pass.dispatch"]["n"] >= 2 and "pass.capture" not in st_
