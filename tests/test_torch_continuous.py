"""The port's twin of ``tests/test_continuous.py``, over
``repro_torch`` on the CPU (``device="cpu"``), plus a parity stream
against the JAX package.

Continuous batching: a query spliced into an in-flight superstep
loop at any step t must be bit-identical to a solo ``Engine.run`` (state,
superstep count, message count); steady-state slot recycling must
re-trace nothing; the service-level scheduler must retire finished
queries mid-flight, serve the result cache, and shed infeasible
deadlines. Plus regression pins: ``drain()`` keeps the
between-supersteps admission window open (lock released between pumps),
compile walls are accounted to ``compile_time_s`` instead of polluting
``busy_time_s``, and the linear-interpolation ``percentile`` fix.

Adapted from the reference: ``backend="pallas"`` is the port's
``backend="kernel"`` (its plain path on the CPU); the threaded tests hand
off with events (``_torch_twins.wait_for_arrival``) instead of joining in
a loop; the compile-time test holds the port's own contract (a step that
builds goes to ``compile_time_s``), not that building dwarfs execution.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine
from repro_torch.service import (AdmissionError, GraphQueryService, QueryClass,
                           QueryRequest, ServiceStats, percentile)


@pytest.fixture(scope="module")
def deep_graph():
    # ladder: BFS depth varies strongly with the root's rank, so lanes
    # genuinely retire at different supersteps
    return G.ladder(2, 30, 1, seed=0)


@pytest.fixture(scope="module")
def graph():
    return G.uniform(500, 8.0, seed=11, weighted=True).symmetrized()


def drive_continuous(eng, width, arrivals, cap=100_000):
    """Host-drive a LaneStepper: ``arrivals`` is a list of
    (join_at_global_superstep, query_kwargs); queries join the in-flight
    loop at (or after, when no slot is free) their step. Returns results
    in arrival order."""
    st = eng.make_stepper(width)
    lanes = [None] * width          # arrival index or None
    results = {}
    qkw = None
    carry = None
    pending = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    gstep = 0
    for _ in range(10_000):
        # admit everything due whose slot exists
        fresh = np.zeros(width, bool)
        for slot in range(width):
            if lanes[slot] is not None or not pending:
                continue
            if arrivals[pending[0]][0] > gstep:
                break
            idx = pending.pop(0)
            kw = arrivals[idx][1]
            if qkw is None:
                qkw = {p: np.full((width,), v, np.int32)
                       for p, v in kw.items()}
            for p, v in kw.items():
                qkw[p][slot] = v
            lanes[slot] = idx
            fresh[slot] = True
        if fresh.any():
            carry, act, steps = (st.init(qkw) if carry is None
                                 else st.admit(carry, qkw, fresh))
        occupied = np.array([ln is not None for ln in lanes], bool)
        if not occupied.any():
            if not pending:
                break
            gstep += 1
            continue
        act, steps = st.probe(carry)
        done = occupied & (~act | (steps >= cap))
        if done.any():
            host = st.fetch(carry)
            for slot in np.nonzero(done)[0]:
                results[lanes[slot]] = eng.lane_result(host, int(slot))
                lanes[slot] = None
            continue   # freed slots admit before the next step
        alive = occupied & act
        carry, act, steps = st.step(carry, alive)
        gstep += 1
    assert len(results) == len(arrivals), "scheduler failed to drain"
    return [results[i] for i in range(len(arrivals))]


# ---------------------------------------------------------------------------
# mid-flight join == solo run, across modes and backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gravfm", "gravf"])
def test_join_midflight_matches_solo_ref(deep_graph, mode):
    pg = PT.partition_graph(deep_graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode=mode, backend="ref", device="cpu")
    n = deep_graph.num_vertices
    # root 0 runs ~31 supersteps; the others join at steps 3/7/15 with
    # varying depths (roots near the far end quiesce almost immediately)
    arrivals = [(0, {"root": 0}), (3, {"root": n - 1}),
                (7, {"root": n // 2}), (15, {"root": 5})]
    outs = drive_continuous(eng, 3, arrivals)
    for (_, kw), res in zip(arrivals, outs):
        ref = Engine(ALG.bfs(int(kw["root"])), pg, mode=mode,
                     backend="ref", device="cpu").run()
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps
        assert res.messages == ref.messages


def test_join_midflight_matches_solo_kernel(deep_graph):
    pg = PT.partition_graph(deep_graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="kernel",
                 tile_e=64, tile_r=32, device="cpu")
    n = deep_graph.num_vertices
    arrivals = [(0, {"root": 0}), (4, {"root": n - 2}), (9, {"root": 17})]
    outs = drive_continuous(eng, 2, arrivals)
    for (_, kw), res in zip(arrivals, outs):
        ref = Engine(ALG.bfs(int(kw["root"])), pg, mode="gravfm",
                     backend="kernel", tile_e=64, tile_r=32,
                         device="cpu").run()
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps


def test_join_midflight_sssp_carry(graph):
    """The argmin carry path (SSSP parent pointers) through the stepper."""
    pg = PT.partition_graph(graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.sssp(), pg, mode="gravfm", backend="ref", device="cpu")
    arrivals = [(0, {"root": 0}), (2, {"root": 250}), (4, {"root": 77})]
    outs = drive_continuous(eng, 2, arrivals)
    for (_, kw), res in zip(arrivals, outs):
        ref = Engine(ALG.sssp(int(kw["root"])), pg, mode="gravfm",
                     backend="ref", device="cpu").run()
        assert np.array_equal(res.state["dist"].view(np.int32),
                              ref.state["dist"].view(np.int32))
        assert np.array_equal(res.state["parent"], ref.state["parent"])


def test_join_midflight_property(deep_graph):
    """Property form: random roots joining at random in-flight steps."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st_

    pg = PT.partition_graph(deep_graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    n = deep_graph.num_vertices
    solo_cache = {}

    def solo(root):
        if root not in solo_cache:
            solo_cache[root] = Engine(ALG.bfs(int(root)), pg, mode="gravfm",
                                      backend="ref", device="cpu").run()
        return solo_cache[root]

    @settings(max_examples=10, deadline=None)
    @given(st_.lists(
        st_.tuples(st_.integers(0, 25), st_.integers(0, n - 1)),
        min_size=1, max_size=5))
    def check(joins):
        arrivals = [(t, {"root": r}) for t, r in sorted(joins)]
        outs = drive_continuous(eng, 2, arrivals)
        for (_, kw), res in zip(arrivals, outs):
            ref = solo(kw["root"])
            assert np.array_equal(res.state["parent"], ref.state["parent"])
            assert res.supersteps == ref.supersteps
            assert res.messages == ref.messages

    check()


def test_steady_state_slot_recycling_zero_retrace(graph):
    """After the first full admit/step/retire cycle, recycling slots
    through arbitrarily many queries must re-trace nothing."""
    pg = PT.partition_graph(graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    drive_continuous(eng, 2, [(0, {"root": 0}), (1, {"root": 9})])
    traces0 = eng.traces
    assert traces0 >= 3   # init + admit + step
    drive_continuous(eng, 2, [(0, {"root": 3}), (2, {"root": 88}),
                              (5, {"root": 123}), (6, {"root": 200})])
    assert eng.traces == traces0


# ---------------------------------------------------------------------------
# service-level continuous scheduling
# ---------------------------------------------------------------------------

def test_service_continuous_end_to_end(graph):
    pg = PT.partition_graph(graph, 4, method="greedy", pad_multiple=16)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=4, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": int(r)}))
            for r in range(10)]
    svc.flush()
    for r, f in enumerate(futs):
        ref = Engine(ALG.bfs(r), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        res = f.result(timeout=0)
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps
    snap = svc.stats_snapshot()
    assert snap["queries_completed"] == 10
    assert snap["scheduling"] == "continuous"


def test_service_continuous_zero_retrace_and_mixed_retire(graph):
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=4, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    svc.warm("g", "bfs")
    traces0 = svc.stats_snapshot()["plan_traces"]
    for wave in range(3):
        futs = [svc.submit(QueryRequest("g", "bfs",
                                        {"root": wave * 16 + r}))
                for r in range(8)]
        svc.flush()
        assert all(f.done() for f in futs)
    snap = svc.stats_snapshot()
    assert snap["plan_traces"] == traces0    # acceptance: zero re-traces
    assert snap["queries_completed"] == 24


def test_service_continuous_retires_midflight_and_admits(deep_graph):
    """Short queries must resolve while a deep query is still in
    flight, and the freed slots must take queued work."""
    pg = PT.partition_graph(deep_graph, 4, method="greedy", pad_multiple=16)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2, device="cpu")
    svc.add_graph("g", deep_graph, pad_multiple=16)
    n = deep_graph.num_vertices
    deep_f = svc.submit(QueryRequest("g", "bfs", {"root": 0}))
    short_f = svc.submit(QueryRequest("g", "bfs", {"root": n - 1}))
    queued_f = svc.submit(QueryRequest("g", "bfs", {"root": n - 3}))
    # pump a few supersteps: the short query retires, the deep one
    # doesn't, and the queued query takes the freed slot
    for _ in range(8):
        svc.poll()
    assert short_f.done() and not deep_f.done()
    svc.flush()
    for root, f in ((0, deep_f), (n - 1, short_f), (n - 3, queued_f)):
        ref = Engine(ALG.bfs(int(root)), pg, mode="gravfm",
                     backend="ref", device="cpu").run()
        assert np.array_equal(f.result().state["parent"],
                              ref.state["parent"])


def test_service_continuous_respects_superstep_cap(deep_graph):
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2,
                            max_supersteps=3, device="cpu")
    svc.add_graph("g", deep_graph, pad_multiple=16)
    f = svc.submit(QueryRequest("g", "bfs", {"root": 0}))
    svc.flush()
    assert f.result().supersteps == 3


def test_service_continuous_step_failure_fails_futures(graph):
    """A device/program error mid-pump must resolve every affected
    Future with the exception (bucketed-batch contract), not strand
    them or kill the scheduler."""
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    splan = svc.plans.get_stepper(svc._plan_key("g", "bfs", "gravfm", 2))

    def boom(carry, alive):
        raise RuntimeError("injected step failure")

    orig = splan.stepper.step
    splan.stepper.step = boom
    try:
        f1 = svc.submit(QueryRequest("g", "bfs", {"root": 0}))
        f2 = svc.submit(QueryRequest("g", "bfs", {"root": 1}))
        svc.poll()
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(timeout=0)
        with pytest.raises(RuntimeError, match="injected"):
            f2.result(timeout=0)
        assert svc.pending() == 0
    finally:
        splan.stepper.step = orig
    # the class recovers on the next submit
    f3 = svc.submit(QueryRequest("g", "bfs", {"root": 2}))
    svc.flush()
    assert f3.result() is not None


# ---------------------------------------------------------------------------
# scheduler-lock + stats-accounting regressions (fake stepper harness,
# shared with tests/test_preempt.py)
# ---------------------------------------------------------------------------

from _fake_stepper_torch import fake_scheduler as _fake_scheduler  # noqa: E402
from _fake_stepper_torch import submit_fake as _submit_fake  # noqa: E402
from _torch_twins import (COUNTERS, assert_same_result,  # noqa: E402
                          jax_service, serve_waves, wait_for_arrival)


def test_cancelled_straggler_does_not_livelock_class():
    """Regression: a queued request cancelled before admission must be
    purged by the next admission window — not pin pending() above zero
    forever, and not starve another tenant's live query behind the
    stride pick of an all-cancelled queue."""
    sched, qclass = _fake_scheduler(slots=1)
    dead = _submit_fake(sched, qclass, depth=3, tenant="a")
    assert dead.cancel()
    live = _submit_fake(sched, qclass, depth=2, tenant="b")
    sched.drain(max_pumps=1_000)
    assert live.result(timeout=0).supersteps == 2
    assert sched.pending() == 0 and not sched.has_work()


def test_drain_keeps_admission_window_open():
    """A submit raced with drain() lands in the very drain it raced with:
    the lock is released between supersteps, and a submit waiting for it
    enters before the next superstep takes it again. The submit reaches
    the lock while superstep 1 holds it; the drain must have answered it
    when it returns."""
    go = threading.Event()
    in_step = threading.Event()

    def hook():                      # holds superstep 1 (lock held)
        in_step.set()
        go.wait(5)

    sched, qclass = _fake_scheduler(step_hook=hook)
    fut1 = _submit_fake(sched, qclass, depth=6)
    fut2 = Future()
    seen = {}

    def drainer():
        sched.drain()
        seen["fut2_done"] = fut2.done()

    t = threading.Thread(target=drainer, daemon=True)
    t.start()
    assert in_step.wait(5)           # superstep 1 in progress
    s = threading.Thread(target=_submit_fake, args=(sched, qclass, 2),
                         kwargs={"fut": fut2}, daemon=True)
    s.start()
    wait_for_arrival(sched)          # the submit waits for the lock
    go.set()
    s.join(5)
    t.join(5)
    assert not s.is_alive(), "submit never landed while draining"
    assert not t.is_alive(), "drain never finished"
    assert seen["fut2_done"], "the raced submit missed the drain"
    assert fut1.result(timeout=0).supersteps == 6
    assert fut2.result(timeout=0).supersteps == 2   # the same drain


def test_two_drainers_and_a_raced_submit_all_finish():
    """Two threads drain at once (a started service's loop and a client's
    flush) while a third submits: the submit waits for the lock during
    superstep 1, the second drainer arrives behind it, and every thread
    finishes once the superstep is let go. No pump may wait for a
    wakeup another pump has taken."""
    go = threading.Event()
    in_step = threading.Event()

    def hook():                      # holds superstep 1 (lock held)
        in_step.set()
        go.wait(5)

    sched, qclass = _fake_scheduler(step_hook=hook)
    fut1 = _submit_fake(sched, qclass, depth=6)
    fut2 = Future()
    drainers = [threading.Thread(target=sched.drain, daemon=True)
                for _ in range(2)]
    drainers[0].start()
    assert in_step.wait(5)           # superstep 1 in progress
    s = threading.Thread(target=_submit_fake, args=(sched, qclass, 2),
                         kwargs={"fut": fut2}, daemon=True)
    s.start()
    wait_for_arrival(sched)          # the submit waits for the lock
    drainers[1].start()
    go.set()
    for t in (s, *drainers):
        t.join(5)
        assert not t.is_alive(), "a pump or the submit hung"
    assert fut1.result(timeout=0).supersteps == 6
    assert fut2.result(timeout=0).supersteps == 2
    assert sched.pending() == 0 and not sched.has_work()


def test_query_from_done_callback_while_submit_waits():
    """A done-callback runs under the scheduler lock. One that queries
    another class (submit, then drain that class) while another thread's
    submit waits for the lock must not wait for that submit to enter: it
    cannot before the callback returns. The nested query, the outer
    drain and the waiting submit all finish."""
    sched, qclass = _fake_scheduler()
    other = QueryClass("h", "fake", "gravfm", 4, "ref", 1)
    fut1 = Future()
    fut2 = Future()
    s = threading.Thread(target=_submit_fake, args=(sched, qclass, 2),
                         kwargs={"fut": fut2}, daemon=True)
    nested = {}

    def on_done(_):                  # lock held: the submit queues on it
        s.start()
        wait_for_arrival(sched)
        f = _submit_fake(sched, other, depth=4)
        sched.drain(other)
        nested["supersteps"] = f.result(timeout=0).supersteps

    fut1.add_done_callback(on_done)
    _submit_fake(sched, qclass, depth=3, fut=fut1)
    t = threading.Thread(target=sched.drain, daemon=True)
    t.start()
    t.join(5)
    assert not t.is_alive(), "the drain hung in its own callback"
    s.join(5)
    assert not s.is_alive(), "the submit never entered"
    assert nested["supersteps"] == 4
    sched.drain()
    assert fut1.result(timeout=0).supersteps == 3
    assert fut2.result(timeout=0).supersteps == 2
    assert sched.pending() == 0 and not sched.has_work()


def test_compile_wall_excluded_from_busy_time():
    """Regression: a traced step's wall must land in compile_time_s, not
    busy_time_s (which feeds qps_busy/TEPS) — only the EWMA was guarded
    before."""

    class _RecordingStats:
        def __init__(self):
            self.busy, self.compile, self.superstep = [], [], []
            self.pump_steps = 0

        def record_busy(self, w, class_key=None):
            self.busy.append(w)

        def record_compile(self, w):
            self.compile.append(w)

        def record_pump_step(self):
            self.pump_steps += 1

        def record_superstep_time(self, ck, w, n_steps=1):
            self.superstep.append((ck, w))

        def record_retire(self, messages, latency_ms, class_key=None):
            pass

        def record_carry_fetch(self, nbytes):
            pass

        def record_deadline_miss(self, n=1):
            pass

        def record_query_depth(self, ck, supersteps):
            pass

        def record_depth_error(self, ck, abs_err):
            pass

        def record_preempt(self, wall_s):
            pass

        def record_restore(self, wall_s):
            pass

        def class_cost_model(self, ck):
            return (None, None)

        def depth_residual(self, ck):
            return None

        def record_tenant(self, tenant, **kw):
            pass

        def record_queue_wait(self, wait_ms):
            pass

    stats = _RecordingStats()
    sched, qclass = _fake_scheduler(stats=stats, trace_on_first_step=True)
    fut = _submit_fake(sched, qclass, depth=3)
    sched.pump()                     # first step traces
    assert len(stats.compile) == 1
    assert stats.busy == [] and stats.superstep == []
    sched.pump()                     # steady-state step
    assert len(stats.busy) == 1 and len(stats.superstep) == 1
    assert len(stats.compile) == 1
    assert stats.pump_steps == 2
    sched.drain()
    assert fut.result().supersteps == 3


def test_service_compile_time_surfaced_in_stats(graph):
    """End to end: the first continuous dispatch builds its programs; the
    wall of each step that built (``eng.traces`` changed) goes to
    compile_time_s and busy_time_s holds only steps that built nothing.
    The reference also asserts that JAX's tracing dwarfs the executed
    supersteps; the port builds in milliseconds, so which of the two is
    larger is not its contract."""
    svc = GraphQueryService(device="cpu", num_shards=4, max_batch=4,
                            scheduling="continuous", slots=4)
    svc.add_graph("g", graph, pad_multiple=16)
    walls = {"compile": [], "busy": []}
    record_compile, record_busy = (svc.stats.record_compile,
                                   svc.stats.record_busy)

    def compile_(wall_s):
        walls["compile"].append(wall_s)
        record_compile(wall_s)

    def busy(wall_s, **kw):
        walls["busy"].append(wall_s)
        record_busy(wall_s, **kw)

    svc.stats.record_compile, svc.stats.record_busy = compile_, busy
    svc.query("g", "bfs", root=0, deadline_ms=60_000)
    snap = svc.stats_snapshot()
    assert walls["compile"] and walls["busy"]
    assert snap["compile_time_s"] > 0.0
    assert snap["busy_time_s"] > 0.0
    assert snap["compile_time_s"] == pytest.approx(sum(walls["compile"]))
    assert snap["busy_time_s"] == pytest.approx(sum(walls["busy"]))
    # the warm class builds nothing more: every later step is busy time
    n_compile = len(walls["compile"])
    svc.query("g", "bfs", root=7, deadline_ms=60_000)
    assert len(walls["compile"]) == n_compile
    assert svc.stats_snapshot()["compile_time_s"] == snap["compile_time_s"]


def test_backlog_pending_lock_consistent():
    """backlog()/pending() take the scheduler lock: while a pump is
    mid-superstep (lock held), a stats read blocks instead of observing
    a half-spliced slot array."""
    go = threading.Event()
    in_step = threading.Event()

    def hook():                      # holds the superstep, lock held
        in_step.set()
        go.wait(5)

    sched, qclass = _fake_scheduler(step_hook=hook)
    futs = [_submit_fake(sched, qclass, depth=3) for _ in range(3)]
    t = threading.Thread(target=sched.pump, daemon=True)
    t.start()
    assert in_step.wait(5)
    got = {}

    def reader():
        got["pending"] = sched.pending()
        got["backlog"] = sched.backlog(qclass)

    r = threading.Thread(target=reader, daemon=True)
    r.start()
    r.join(0.3)
    # the read must NOT complete while the pump holds the lock
    assert r.is_alive(), "pending() returned mid-pump (racy read)"
    go.set()
    t.join(5)
    r.join(5)
    assert not t.is_alive() and not r.is_alive()
    # post-pump state is consistent: 2 in flight (slots) + 1 queued
    assert got["pending"] == 3
    assert got["backlog"] == 1
    sched.drain()
    assert all(f.result().supersteps == 3 for f in futs)


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------

def test_result_cache_partitioned_by_tenant(graph):
    """One tenant's burst must not evict another tenant's hot results,
    and per-tenant hit counts surface in the stats endpoint."""
    svc = GraphQueryService(num_shards=4, max_batch=1,
                            result_cache_size=2, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    svc.query("g", "bfs", root=0, tenant="a")       # a's hot result
    # b floods ITS partition well past the bound
    for r in range(1, 6):
        svc.query("g", "bfs", root=r, tenant="b")
    assert len(svc._result_cache["b"]) == 2          # b's LRU bounded
    b0 = svc.stats_snapshot()["batches_dispatched"]
    svc.query("g", "bfs", root=0, tenant="a")        # still cached
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 1
    assert snap["batches_dispatched"] == b0          # no re-execution
    assert snap["tenants"]["a"]["result_cache_hits"] == 1
    assert snap["tenants"]["b"]["result_cache_hits"] == 0
    # partitions are an isolation boundary: b never sees a's entry
    svc.query("g", "bfs", root=0, tenant="b")
    assert svc.stats_snapshot()["batches_dispatched"] == b0 + 1


def test_result_cache_hits_skip_execution(graph):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    for r in range(4):
        svc.submit(QueryRequest("g", "bfs", {"root": r}))
    snap0 = svc.stats_snapshot()
    assert snap0["batches_dispatched"] == 1
    # identical resubmission: resolved from the cache, no dispatch
    f = svc.submit(QueryRequest("g", "bfs", {"root": 2}))
    assert f.done()
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 1
    assert snap["batches_dispatched"] == 1
    assert svc.pending() == 0
    # a different root misses
    f2 = svc.submit(QueryRequest("g", "bfs", {"root": 99}))
    assert not f2.done()
    svc.flush()
    assert svc.stats_snapshot()["result_cache_hits"] == 1


def test_result_cache_hits_do_not_alias(graph, pg=None):
    """A client mutating its result in place must not poison the cache
    or later hits (store and lookup both copy)."""
    svc = GraphQueryService(num_shards=4, max_batch=1, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    r1 = svc.query("g", "bfs", root=3)
    clean = r1.state["parent"].copy()
    r1.state["parent"][:] = -99          # client scribbles on its copy
    f = svc.submit(QueryRequest("g", "bfs", {"root": 3}))
    r2 = f.result(timeout=0)
    assert svc.stats_snapshot()["result_cache_hits"] == 1
    assert np.array_equal(r2.state["parent"], clean)
    # and a hit's mutation doesn't leak back either
    r2.state["parent"][:] = -7
    r3 = svc.submit(QueryRequest("g", "bfs", {"root": 3})).result(timeout=0)
    assert np.array_equal(r3.state["parent"], clean)


def test_result_cache_lru_bound(graph):
    svc = GraphQueryService(num_shards=4, max_batch=1,
                            result_cache_size=2, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    for r in (0, 1, 2):     # evicts root 0
        svc.query("g", "bfs", root=r)
    # the cache is partitioned by tenant; one tenant -> one partition,
    # bounded to result_cache_size entries
    assert sum(len(p) for p in svc._result_cache.values()) == 2
    b0 = svc.stats_snapshot()["batches_dispatched"]
    svc.query("g", "bfs", root=0)   # evicted -> re-executed
    assert svc.stats_snapshot()["result_cache_hits"] == 0
    assert svc.stats_snapshot()["batches_dispatched"] == b0 + 1
    svc.query("g", "bfs", root=2)   # still resident -> hit, no dispatch
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 1
    assert snap["batches_dispatched"] == b0 + 1


def test_result_cache_disabled(graph):
    svc = GraphQueryService(num_shards=4, max_batch=1,
                            result_cache_size=0, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    svc.query("g", "bfs", root=1)
    svc.query("g", "bfs", root=1)   # re-executed, not served from cache
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 0
    assert snap["batches_dispatched"] == 2


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_control_sheds_infeasible_deadline(graph):
    svc = GraphQueryService(num_shards=4, max_batch=4,
                            scheduling="continuous", slots=4,
                            admission_control=True, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    # cold class: no cost model yet -> everything admitted
    f = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                deadline_ms=0.0001))
    svc.flush()
    assert f.result() is not None
    # now the EWMA exists; an impossible deadline is shed immediately
    f2 = svc.submit(QueryRequest("g", "bfs", {"root": 1},
                                 deadline_ms=0.0001))
    with pytest.raises(AdmissionError):
        f2.result(timeout=0)
    snap = svc.stats_snapshot()
    assert snap["queries_shed"] == 1
    # and a feasible one still goes through
    f3 = svc.submit(QueryRequest("g", "bfs", {"root": 1},
                                 deadline_ms=60_000))
    svc.flush()
    assert f3.result() is not None
    assert svc.stats_snapshot()["queries_shed"] == 1


def test_admission_control_bucketed_mode(graph):
    svc = GraphQueryService(num_shards=4, max_batch=4,
                            admission_control=True, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    # two waves: the first dispatch compiles (excluded from the cost
    # model by design), the second feeds the superstep EWMA
    for r in range(8):
        svc.submit(QueryRequest("g", "bfs", {"root": r}))
    f = svc.submit(QueryRequest("g", "bfs", {"root": 9},
                                deadline_ms=0.0001))
    with pytest.raises(AdmissionError):
        f.result(timeout=0)
    assert svc.stats_snapshot()["queries_shed"] == 1


def test_admission_control_off_by_default(graph):
    svc = GraphQueryService(num_shards=4, max_batch=4, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    for r in range(4):
        svc.submit(QueryRequest("g", "bfs", {"root": r}))
    f = svc.submit(QueryRequest("g", "bfs", {"root": 9},
                                deadline_ms=0.0001))
    svc.flush()
    assert f.result() is not None   # late, but served


# ---------------------------------------------------------------------------
# percentile: linear interpolation + p99
# ---------------------------------------------------------------------------

def test_percentile_linear_interpolation():
    assert percentile([], 50) == 0.0
    assert percentile([7.0], 50) == 7.0
    # the banker's-rounding bug made p50 of 2 samples return vs[0];
    # linear interpolation gives the midpoint
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
    assert percentile([1.0, 2.0, 3.0], 50) == pytest.approx(2.0)
    vs = list(map(float, range(1, 101)))
    assert percentile(vs, 0) == 1.0
    assert percentile(vs, 100) == 100.0
    assert percentile(vs, 99) == pytest.approx(99.01)
    assert percentile(vs, 95) == pytest.approx(95.05)


def test_snapshot_has_p99():
    stats = ServiceStats()
    stats.record_batch(n_queries=1, n_pad=0, wall_s=0.01, messages=10,
                       supersteps=2, latencies_ms=[1.0, 2.0, 3.0, 100.0])
    snap = stats.snapshot()
    assert "latency_p99_ms" in snap
    assert snap["latency_p50_ms"] == pytest.approx(2.5)
    assert snap["latency_p99_ms"] <= snap["latency_max_ms"]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_continuous_stream_matches_jax(deep_graph):
    """One seeded BFS stream over the ladder (depths 1 to ~31 by root),
    submitted in three waves between polls at one injected arrival time,
    through the JAX service's continuous scheduler and the port's: every
    answer, the poll after which each query had retired, and the
    counters equal exactly."""
    from repro.service import QueryRequest as JaxRequest
    kw = dict(num_shards=4, scheduling="continuous", slots=3, max_batch=3,
              result_cache_size=0)
    jsvc = jax_service(deep_graph, **kw)
    tsvc = GraphQueryService(device="cpu", **kw)
    tsvc.add_graph("g", deep_graph, pad_multiple=16)
    rng = np.random.default_rng(3)
    roots = rng.integers(0, deep_graph.num_vertices, size=12)
    waves = [[("bfs", {"root": int(r)},
               {"deadline_ms": 600_000.0, "tenant": f"t{i % 2}"})
              for i, r in enumerate(roots[w * 4:(w + 1) * 4])]
             for w in range(3)]
    t0 = time.perf_counter()
    jf, jdone = serve_waves(jsvc, JaxRequest, waves, arrival_s=t0)
    tf, tdone = serve_waves(tsvc, QueryRequest, waves, arrival_s=t0)
    jsvc.flush()
    tsvc.flush()
    assert tdone == jdone
    assert any(not all(d) for d in tdone)   # queries were still in flight
    for j, t in zip(jf, tf):
        assert_same_result(t.result(timeout=0), j.result(timeout=0))
    jsnap, tsnap = jsvc.stats_snapshot(), tsvc.stats_snapshot()
    for name in COUNTERS:
        assert tsnap[name] == jsnap[name], name
