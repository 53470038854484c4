"""The port's twin of ``tests/test_service.py``, over ``repro_torch`` on
the CPU (``device="cpu"``), plus parity with the JAX package.

Query service subsystem: batched execution must be bit-identical to
sequential single-query runs; the plan cache must serve steady state with
zero re-traces; the scheduler must respect batch-size and deadline
triggers for mixed-deadline request streams.

Adapted from the reference: ``backend="pallas"`` is the port's
``backend="kernel"`` (its plain path on the CPU). Parity: one seeded
mixed-deadline BFS/SSSP stream at one injected arrival time, polled at
injected times, through the JAX service and the port's; the batches
each poll dispatches, every answer and the counters are equal.
"""
import time

import numpy as np
import pytest

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine
from repro_torch.service import (Batcher, GraphQueryService, PlanCache,
                                 PlanKey, QueryClass, QueryRequest,
                                 bucket_for)

from _torch_twins import COUNTERS, assert_same_result, jax_service


@pytest.fixture(scope="module")
def graph():
    return G.uniform(600, 8.0, seed=11, weighted=True).symmetrized()


@pytest.fixture(scope="module")
def pg(graph):
    return PT.partition_graph(graph, 4, method="greedy", pad_multiple=16)


# ---------------------------------------------------------------------------
# batched engine execution == sequential single-query runs
# ---------------------------------------------------------------------------

def test_batched_bfs_matches_sequential(graph, pg):
    roots = (np.arange(32, dtype=np.int32) * 13) % graph.num_vertices
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    batch = eng.run_batch(root=roots)
    assert len(batch) == 32
    for i, r in enumerate(roots):
        single = Engine(ALG.bfs(int(r)), pg, mode="gravfm",
                        backend="ref", device="cpu").run()
        assert np.array_equal(batch[i].state["parent"],
                              single.state["parent"])
        assert batch[i].supersteps == single.supersteps
        assert batch[i].messages == single.messages


def test_batched_bfs_matches_sequential_kernel(graph, pg):
    roots = np.array([0, 3, 77, 401], np.int32)
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="kernel",
                 tile_e=64, tile_r=32, device="cpu")
    batch = eng.run_batch(root=roots)
    for i, r in enumerate(roots):
        single = Engine(ALG.bfs(int(r)), pg, mode="gravfm",
                        backend="kernel", tile_e=64, tile_r=32,
                            device="cpu").run()
        assert np.array_equal(batch[i].state["parent"],
                              single.state["parent"])


def test_batched_sssp_matches_sequential(graph, pg):
    roots = (np.arange(8, dtype=np.int32) * 71) % graph.num_vertices
    eng = Engine(ALG.sssp(), pg, mode="gravfm", backend="ref", device="cpu")
    batch = eng.run_batch(root=roots)
    for i, r in enumerate(roots):
        single = Engine(ALG.sssp(int(r)), pg, mode="gravfm",
                        backend="ref", device="cpu").run()
        # bit-identical incl. inf for unreachable
        assert np.array_equal(
            batch[i].state["dist"].view(np.int32),
            single.state["dist"].view(np.int32))
        assert np.array_equal(batch[i].state["parent"],
                              single.state["parent"])


def test_run_query_kwarg_overrides_closure(pg):
    eng = Engine(ALG.bfs(0), pg, mode="gravfm", backend="ref", device="cpu")
    res = eng.run(root=42)
    ref = Engine(ALG.bfs(42), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["parent"], ref.state["parent"])


def test_run_batch_requires_query_arrays(pg):
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    with pytest.raises(ValueError):
        eng.run_batch()


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_hit_miss_and_zero_retrace(graph):
    cache = PlanCache(device="cpu")
    cache.register_graph("g", graph, num_shards=4, pad_multiple=16)
    key = PlanKey(graph_id="g", kernel="bfs", mode="gravfm",
                  num_shards=4, batch_size=8, backend="ref")

    plan = cache.get_plan(key, warm=True)
    assert cache.stats.plan_cache_misses == 1
    traces_after_warm = cache.sync_trace_counters()
    assert traces_after_warm >= 1

    roots = np.arange(8, dtype=np.int32)
    plan2 = cache.get_plan(key)
    assert plan2 is plan
    assert cache.stats.plan_cache_hits == 1
    plan2.execute(root=roots)
    plan2.execute(root=roots + 8)
    # steady state: zero re-traces after the warmup compile
    assert cache.sync_trace_counters() == traces_after_warm

    # different batch size = different plan (miss), same engine (1 trace)
    key16 = PlanKey(graph_id="g", kernel="bfs", mode="gravfm",
                    num_shards=4, batch_size=16, backend="ref")
    cache.get_plan(key16, warm=True)
    assert cache.stats.plan_cache_misses == 2


def test_plan_cache_rejects_unbatchable_kernel(graph):
    cache = PlanCache(device="cpu")
    cache.register_graph("g", graph, num_shards=4, pad_multiple=16)
    with pytest.raises(ValueError):
        cache.get_plan(PlanKey(graph_id="g", kernel="wcc", mode="gravfm",
                               num_shards=4, batch_size=8, backend="ref"))


def test_plan_cache_requires_registered_graph():
    cache = PlanCache(device="cpu")
    with pytest.raises(KeyError):
        cache.get_plan(PlanKey(graph_id="nope", kernel="bfs",
                               mode="gravfm", num_shards=4, batch_size=1,
                               backend="ref"))


# ---------------------------------------------------------------------------
# batcher / scheduler
# ---------------------------------------------------------------------------

def test_bucket_for():
    assert [bucket_for(n, 32) for n in (1, 2, 3, 5, 8, 9, 31, 32, 33)] == \
        [1, 2, 4, 8, 8, 16, 32, 32, 32]


def test_batcher_groups_by_class_and_fills():
    b = Batcher(max_batch=4, slack_ms=0.0)
    qa = QueryClass("g1", "bfs", "gravfm", 4, "ref")
    qb = QueryClass("g2", "bfs", "gravfm", 4, "ref")
    out = []
    for i in range(7):
        r = QueryRequest("g1" if i % 2 == 0 else "g2", "bfs",
                         {"root": i})
        ready = b.add(qa if i % 2 == 0 else qb, (r, None), True)
        if ready is not None:
            out.append(ready)
    # g1 saw 4 requests (i = 0,2,4,6) -> one full batch; g2 still pending
    assert len(out) == 1 and out[0][0] == qa and len(out[0][1]) == 4
    assert len(b) == 3


def test_batcher_mixed_deadlines_flush_order():
    """A class's flush time is the TIGHTEST member deadline; an urgent
    request joining a lazy batch pulls the whole batch forward."""
    b = Batcher(max_batch=32, slack_ms=0.0)
    qc = QueryClass("g", "bfs", "gravfm", 4, "ref")
    now = time.perf_counter()
    lazy = QueryRequest("g", "bfs", {"root": 1}, deadline_ms=10_000)
    b.add(qc, (lazy, None), True)
    assert b.due(now) == []           # nothing due yet
    nxt = b.next_flush_s()
    assert nxt is not None and nxt > now + 5

    urgent = QueryRequest("g", "bfs", {"root": 2}, deadline_ms=1.0)
    b.add(qc, (urgent, None), True)
    assert b.next_flush_s() < now + 1
    due = b.due(urgent.deadline_s + 1e-3)
    assert len(due) == 1 and len(due[0][1]) == 2  # both ride the batch
    assert len(b) == 0


def test_service_end_to_end_batched_correctness(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=8, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": int(r)}))
            for r in range(8)]
    assert all(f.done() for f in futs)  # full batch auto-dispatched
    for r, f in enumerate(futs):
        ref = Engine(ALG.bfs(r), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        assert np.array_equal(f.result().state["parent"],
                              ref.state["parent"])
    snap = svc.stats_snapshot()
    assert snap["queries_completed"] == 8
    assert snap["batches_dispatched"] == 1
    assert snap["avg_batch_size"] == 8


def test_service_steady_state_zero_retrace(graph):
    svc = GraphQueryService(num_shards=4, max_batch=8, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    for wave in range(3):
        for r in range(8):
            svc.submit(QueryRequest("g", "bfs",
                                    {"root": wave * 8 + r}))
        if wave == 0:
            traces0 = svc.stats_snapshot()["plan_traces"]
    snap = svc.stats_snapshot()
    assert snap["plan_traces"] == traces0    # acceptance: zero re-traces
    assert snap["plan_cache_hits"] >= 2
    assert snap["plan_cache_misses"] == 1


def test_service_partial_batch_padding_and_poll(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=32, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    # 3 queries -> bucket 4, one pad lane, dispatched via deadline poll
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                    deadline_ms=5.0)) for r in range(3)]
    assert not any(f.done() for f in futs)
    deadline = time.perf_counter() + 5
    while svc.pending() and time.perf_counter() < deadline:
        svc.poll()
        time.sleep(0.002)
    assert all(f.done() for f in futs)
    for r, f in enumerate(futs):
        ref = Engine(ALG.bfs(r), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        assert np.array_equal(f.result().state["parent"],
                              ref.state["parent"])
    assert svc.stats_snapshot()["batch_pad_queries"] == 1


def test_service_mixed_deadline_async_scheduler(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=32, device="cpu").start()
    svc.add_graph("g", graph, pad_multiple=16)
    try:
        slow_f = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                         deadline_ms=5_000))
        fast_f = svc.submit(QueryRequest("g", "bfs", {"root": 1},
                                         deadline_ms=30))
        # the urgent request drags the lazy one along in the same batch
        res_fast = fast_f.result(timeout=10)
        res_slow = slow_f.result(timeout=10)
    finally:
        svc.stop()
    for r, res in ((0, res_slow), (1, res_fast)):
        ref = Engine(ALG.bfs(r), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        assert np.array_equal(res.state["parent"], ref.state["parent"])
    assert svc.stats_snapshot()["batches_dispatched"] == 1


def test_service_unbatchable_and_sync_query(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=8, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    res = svc.query("g", "wcc")
    ref = Engine(ALG.wcc(), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["label"], ref.state["label"])
    res = svc.query("g", "sssp", root=5)
    ref = Engine(ALG.sssp(5), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["dist"].view(np.int32),
                          ref.state["dist"].view(np.int32))


def test_service_rejects_bad_requests(graph):
    svc = GraphQueryService(num_shards=4, max_batch=8, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    with pytest.raises(KeyError):
        svc.submit(QueryRequest("g", "nope", {"root": 0}))
    with pytest.raises(ValueError):
        svc.submit(QueryRequest("g", "bfs", {"root": 0, "bogus": 1}))
    # missing a declared param must fail at submit, not co-batch-dependent
    with pytest.raises(ValueError, match="missing"):
        svc.submit(QueryRequest("g", "bfs"))


def test_sync_query_flushes_only_its_class(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=32, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    pend = svc.submit(QueryRequest("g", "sssp", {"root": 2},
                                   deadline_ms=60_000))
    res = svc.query("g", "bfs", root=1)
    ref = Engine(ALG.bfs(1), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["parent"], ref.state["parent"])
    # the sssp request's half-filled batch kept accumulating
    assert not pend.done() and svc.pending() == 1
    svc.flush()
    assert pend.done()


def test_engine_rejects_misspelled_query_param(pg):
    """A typo'd kwarg must not be silently swallowed by init_state's
    catch-all (which would run every lane from the default root)."""
    eng = Engine(ALG.bfs(), pg, mode="gravfm", backend="ref", device="cpu")
    with pytest.raises(ValueError, match="roots"):
        eng.run_batch(roots=np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="rot"):
        eng.run(rot=3)


def test_service_cancelled_future_does_not_poison_batch(graph, pg):
    svc = GraphQueryService(num_shards=4, max_batch=32, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    f_cancel = svc.submit(QueryRequest("g", "bfs", {"root": 0}))
    f_keep = svc.submit(QueryRequest("g", "bfs", {"root": 1}))
    assert f_cancel.cancel()
    svc.flush()
    assert f_keep.done() and not f_keep.cancelled()
    ref = Engine(ALG.bfs(1), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(f_keep.result().state["parent"],
                          ref.state["parent"])
    # only the surviving query is accounted
    assert svc.stats_snapshot()["queries_completed"] == 1


def test_service_shares_one_stats_object(graph):
    """Passing both plan_cache and stats must not split the counters
    across two ServiceStats objects (cache hits would vanish from the
    endpoint)."""
    from repro_torch.service import PlanCache, ServiceStats
    cache = PlanCache(device="cpu")
    stats = ServiceStats()
    svc = GraphQueryService(num_shards=4, max_batch=4, plan_cache=cache,
                            stats=stats, device="cpu")
    svc.add_graph("g", graph, pad_multiple=16)
    for wave in range(2):
        for r in range(4):
            svc.submit(QueryRequest("g", "bfs", {"root": wave * 4 + r}))
    snap = svc.stats_snapshot()
    assert snap["plan_cache_misses"] == 1
    assert snap["plan_cache_hits"] == 1
    assert snap["plan_traces"] >= 1


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_deadline_batching_matches_jax(graph):
    """Deadlines of 2 to 400 ms at one injected arrival time, polled at
    injected times 1 ms apart: each poll dispatches the same batches in
    both services, and every answer and counter is equal."""
    from repro.service import QueryRequest as JaxRequest
    kw = dict(num_shards=4, max_batch=4, slack_ms=1.0, result_cache_size=0)
    jsvc = jax_service(graph, **kw)
    tsvc = GraphQueryService(device="cpu", **kw)
    tsvc.add_graph("g", graph, pad_multiple=16)
    rng = np.random.default_rng(9)
    stream = [("bfs" if rng.integers(3) else "sssp",
               int(rng.integers(graph.num_vertices)),
               float(rng.choice([2.0, 10.0, 40.0, 400.0])))
              for _ in range(18)]
    t0 = time.perf_counter()
    seen = []
    for svc, Req in ((jsvc, JaxRequest), (tsvc, QueryRequest)):
        futs = [svc.submit(Req("g", k, {"root": r}, deadline_ms=d,
                               arrival_s=t0)) for k, r, d in stream]
        polls = []
        for i in range(0, 60):
            n = svc.poll(now_s=t0 + i * 1e-3)
            polls.append((n, tuple(f.done() for f in futs)))
        svc.flush()
        seen.append((futs, polls, svc.stats_snapshot()))
    (jf, jpolls, jsnap), (tf, tpolls, tsnap) = seen
    assert tpolls == jpolls
    # deadline-driven batches left at different polls
    assert sum(n for n, _ in tpolls) >= 2 and not all(tpolls[0][1])
    for j, t in zip(jf, tf):
        assert_same_result(t.result(timeout=0), j.result(timeout=0))
    for name in COUNTERS:
        assert tsnap[name] == jsnap[name], name
