"""The port's twin of ``tests/test_trace.py``, over ``repro_torch`` on
the CPU (``device="cpu"``), plus parity with the JAX package.

Query-lifecycle tracing + roofline telemetry.

TraceBus mechanics (bounded ring, disabled no-op), span assembly from
synthetic and real event streams, Chrome-trace export validity, the
superstep events' lane→query attribution, parked intervals under
preemption, roofline_efficiency validated against perfmodel.limits(),
the busy-denominator clamp, the park/restore counter split, per-tenant
deadline-miss accounting, store residency events, and counter
conservation (submitted == completed + shed + in-flight) across the
bucketed, continuous, and preemption paths.

Adapted from the reference: the mixed-depth graph is the port's rebuild
of ``benchmarks.continuous._mixed_graph`` (``_torch_twins``). Parity: one
seeded stream per path (bucketed, continuous, continuous with a
preemption) through the JAX service and the port's; each query's trace
event kinds, in order, and the store's residency events are equal.
"""
import json
import time

import numpy as np
import pytest

from repro_torch.core import graph as G
from repro_torch.core import perfmodel
from repro_torch.service import (GraphQueryService, QueryRequest, ServiceStats,
                           TraceBus, TraceEvent, assemble_spans,
                           chrome_trace, class_key)
from repro_torch.store import GraphStore

from _torch_twins import jax_graph
from _torch_twins import mixed_graph as _mixed_graph


@pytest.fixture(scope="module")
def small_graph():
    return G.uniform(64, 4.0, seed=0).symmetrized()


def _service(small_graph, **kw):
    kw.setdefault("num_shards", 2)
    kw.setdefault("max_batch", 8)
    svc = GraphQueryService(device="cpu", **kw)
    svc.add_graph("g", small_graph)
    return svc


def _run(svc, reqs):
    futs = [svc.submit(r) for r in reqs]
    svc.flush()
    return futs


# ---------------------------------------------------------------------------
# TraceBus mechanics
# ---------------------------------------------------------------------------

def test_bus_is_a_bounded_ring():
    bus = TraceBus(capacity=8)
    for i in range(20):
        bus.emit("submit", qid=i)
    assert len(bus) == 8
    assert bus.emitted == 20
    assert bus.dropped == 12
    # the ring keeps the MOST RECENT events
    assert [e.qid for e in bus.snapshot()] == list(range(12, 20))
    bus.clear()
    assert len(bus) == 0 and bus.emitted == 0


def test_disabled_bus_is_a_noop():
    bus = TraceBus(enabled=False)
    bus.emit("submit", qid=1)
    assert len(bus) == 0 and bus.emitted == 0
    assert bus.chrome_trace()["traceEvents"] == []


def test_unknown_event_kind_rejected():
    bus = TraceBus()
    with pytest.raises(AssertionError):
        bus.emit("frobnicate", qid=1)


# ---------------------------------------------------------------------------
# span assembly (synthetic streams)
# ---------------------------------------------------------------------------

def test_span_assembly_full_lifecycle():
    evs = [
        TraceEvent("submit", 1.0, qid=7, tenant="t", klass="k"),
        TraceEvent("admit", 2.0, qid=7),
        TraceEvent("park", 3.0, qid=7),
        TraceEvent("restore", 5.0, qid=7),
        TraceEvent("retire", 6.0, qid=7,
                   attrs={"reason": "retired", "supersteps": 9,
                          "messages": 123, "deadline_slack_s": 0.25}),
    ]
    sp = assemble_spans(evs)[7]
    assert sp.tenant == "t" and sp.klass == "k"
    assert sp.queued == (1.0, 2.0) and sp.queued_s() == 1.0
    assert sp.active == [(2.0, 3.0), (5.0, 6.0)]
    assert sp.parked == [(3.0, 5.0)] and sp.parks == 1
    assert sp.active_s() == 2.0 and sp.parked_s() == 2.0
    assert sp.outcome == "retired" and sp.retired_s == 6.0
    assert sp.supersteps == 9 and sp.messages == 123
    assert sp.deadline_slack_s == 0.25


def test_span_assembly_outcomes_and_open_intervals():
    evs = [
        TraceEvent("submit", 1.0, qid=1),
        TraceEvent("retire", 1.5, qid=1, attrs={"reason": "cache"}),
        TraceEvent("submit", 2.0, qid=2),
        TraceEvent("shed", 2.5, qid=2, attrs={"reason": "quota"}),
        TraceEvent("submit", 3.0, qid=3),
        TraceEvent("admit", 4.0, qid=3),      # still running at snapshot
    ]
    spans = assemble_spans(evs)
    assert spans[1].outcome == "cache_hit"
    assert spans[1].queued == (1.0, 1.5)      # resolved out of the queue
    assert spans[2].outcome == "shed"
    assert spans[3].outcome is None
    assert spans[3].active == [(4.0, None)]   # open interval


def test_span_assembly_survives_ring_truncation():
    # submit fell off the ring; the admit must still open a span
    evs = [TraceEvent("admit", 5.0, qid=4),
           TraceEvent("retire", 6.0, qid=4, attrs={"reason": "retired"})]
    sp = assemble_spans(evs)[4]
    assert sp.queued == (5.0, 5.0)            # zero-width placeholder
    assert sp.active == [(5.0, 6.0)]
    assert sp.outcome == "retired"


# ---------------------------------------------------------------------------
# end-to-end: continuous scheduling
# ---------------------------------------------------------------------------

def test_continuous_spans_reconstruct_lifecycle(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=4,
                   result_cache_size=0)
    reqs = [QueryRequest("g", "bfs", {"root": int(i)}, deadline_ms=60_000)
            for i in range(6)]
    futs = _run(svc, reqs)
    results = {r.qid: f.result(timeout=30) for r, f in zip(reqs, futs)}
    spans = svc.trace.spans()
    for r in reqs:
        sp = spans[r.qid]
        assert sp.outcome == "retired"
        assert sp.klass is not None and "bfs" in sp.klass
        # queue -> active -> retire, all intervals closed and ordered
        assert sp.queued is not None and sp.queued[1] is not None
        assert sp.active and all(b is not None for _, b in sp.active)
        assert sp.queued[0] <= sp.queued[1] <= sp.active[0][0]
        assert sp.retired_s >= sp.active[-1][1] - 1e-9
        # the retire event carries the query's own result attribution
        assert sp.supersteps == results[r.qid].supersteps
        assert sp.messages == results[r.qid].messages
        assert sp.deadline_slack_s is not None


def test_superstep_events_attribute_lanes_to_queries(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=4,
                   result_cache_size=0)
    reqs = [QueryRequest("g", "bfs", {"root": int(i)}, deadline_ms=60_000)
            for i in range(4)]
    for f in _run(svc, reqs):
        f.result(timeout=30)
    steps = [e for e in svc.trace.snapshot() if e.kind == "superstep"]
    assert steps, "no superstep events emitted"
    qids = {r.qid for r in reqs}
    seen = set()
    for ev in steps:
        assert ev.dur_s > 0.0
        assert ev.klass is not None
        lanes = ev.attrs["lanes"]
        assert ev.attrs["n_alive"] == len(lanes)
        assert set(lanes.values()) <= qids
        seen |= set(lanes.values())
    # every query was attributed to at least one dispatch
    assert seen == qids


def test_chrome_trace_export_is_loadable(tmp_path, small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=4,
                   result_cache_size=0)
    for f in _run(svc, [QueryRequest("g", "bfs", {"root": int(i)},
                                     deadline_ms=60_000)
                        for i in range(4)]):
        f.result(timeout=30)
    path = svc.dump_trace(str(tmp_path / "trace.json"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert path.endswith("trace.json")
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    # every event is a JSON-clean dict with the required trace fields
    for e in evs:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"queued", "active", "superstep"} <= names
    pids = {e["pid"] for e in evs}
    assert {1, 2, 3} <= pids    # queries, scheduler, graph-store


# ---------------------------------------------------------------------------
# preemption: parked intervals
# ---------------------------------------------------------------------------

def test_preempted_query_span_shows_parked_interval():
    g = _mixed_graph(300, 6.0, 40)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2,
                            result_cache_size=0, device="cpu")
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "bfs")
    deep = [QueryRequest("g", "bfs", {"root": 300}, deadline_ms=60_000),
            QueryRequest("g", "bfs", {"root": 339}, deadline_ms=60_000)]
    deep_futs = [svc.submit(r) for r in deep]
    for _ in range(3):
        svc.poll()
    fg = QueryRequest("g", "bfs", {"root": 5}, deadline_ms=25, priority=1)
    fg_fut = svc.submit(fg)
    for _ in range(12):
        svc.poll()
        if fg_fut.done():
            break
    svc.flush()
    for f in deep_futs + [fg_fut]:
        assert f.result(timeout=30) is not None
    assert svc.stats_snapshot()["preemptions"] >= 1
    spans = svc.trace.spans()
    victims = [sp for sp in spans.values() if sp.parks > 0]
    assert victims, "no span recorded a park"
    v = victims[0]
    assert v.qid in {r.qid for r in deep}
    # active -> parked -> active again, every interval closed
    assert v.parked and all(b is not None for _, b in v.parked)
    assert len(v.active) >= 2
    assert v.parked_s() > 0.0
    assert v.outcome == "retired"
    # the park event names its preemptor
    park = next(e for e in svc.trace.snapshot() if e.kind == "park")
    assert park.attrs["by"] == fg.qid
    # the foreground's admit says it preempted
    admits = [e for e in svc.trace.snapshot()
              if e.kind == "admit" and e.qid == fg.qid]
    assert any(e.attrs.get("reason") == "preempt" for e in admits)
    # parked phase survives the Chrome export
    slices = [e for e in chrome_trace(svc.trace.snapshot())["traceEvents"]
              if e.get("ph") == "X" and e["name"] == "parked"]
    assert slices and all(s["dur"] > 0 for s in slices)


# ---------------------------------------------------------------------------
# roofline telemetry
# ---------------------------------------------------------------------------

def test_roofline_efficiency_matches_perfmodel(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=4,
                   result_cache_size=0)
    reqs = [QueryRequest("g", "bfs", {"root": int(i)}, deadline_ms=60_000)
            for i in range(4)]
    for f in _run(svc, reqs):
        f.result(timeout=30)
    snap = svc.stats_snapshot()
    ck = f"g@v1/bfs/gravfm"
    assert ck in snap["roofline"]
    r = snap["roofline"][ck]
    # the projection IS the §5 model's system limit on this workload
    wl = perfmodel.Workload(num_vertices=small_graph.num_vertices,
                            num_edges=small_graph.num_edges)
    want = perfmodel.limits(perfmodel.PAPER_PLATFORM,
                            perfmodel.PAPER_ALGOS["bfs"], wl,
                            n_nodes=2, mode="gravfm")["T_sys"]
    assert r["projected_teps"] == pytest.approx(want)
    # measured TEPS = per-class messages over per-class execution busy
    assert r["busy_s"] > 0.0 and r["completed"] == len(reqs)
    assert r["teps"] == pytest.approx(r["messages"] / r["busy_s"])
    assert r["efficiency"] == pytest.approx(r["teps"] / want)
    assert snap["roofline_efficiency"][ck] == r["efficiency"]
    # an interpreted-CPU run is far below the paper platform's roofline
    assert 0.0 < r["efficiency"] < 1.0


def test_roofline_accounted_on_bucketed_path_too(small_graph):
    svc = _service(small_graph, scheduling="bucketed",
                   result_cache_size=0)
    for f in _run(svc, [QueryRequest("g", "bfs", {"root": int(i)},
                                     deadline_ms=60_000)
                        for i in range(3)]):
        f.result(timeout=30)
    # dispatch once more so a warm (non-compile) wall lands in busy
    for f in _run(svc, [QueryRequest("g", "bfs", {"root": int(i + 8)},
                                     deadline_ms=60_000)
                        for i in range(3)]):
        f.result(timeout=30)
    r = svc.stats_snapshot()["roofline"]["g@v1/bfs/gravfm"]
    assert r["completed"] == 6 and r["busy_s"] > 0.0
    assert r["projected_teps"] > 0.0 and r["efficiency"] > 0.0


def test_roofline_unknown_class_reports_zero_not_garbage():
    stats = ServiceStats()
    stats.record_busy(0.1, class_key="nobody@v1/bfs/gravfm")
    stats.record_retire(100, 1.0, class_key="nobody@v1/bfs/gravfm")
    # no projector installed -> efficiency 0.0, never a bogus ratio
    r = stats.snapshot()["roofline"]["nobody@v1/bfs/gravfm"]
    assert r["projected_teps"] == 0.0 and r["efficiency"] == 0.0
    assert r["teps"] > 0.0


# ---------------------------------------------------------------------------
# satellite: busy clamp + park/restore split
# ---------------------------------------------------------------------------

def test_qps_busy_and_teps_zero_before_any_dispatch():
    stats = ServiceStats()
    snap = stats.snapshot()
    assert snap["qps_busy"] == 0.0 and snap["teps"] == 0.0
    # completions with NO busy time (pure result-cache hits) must not
    # divide by the epsilon clamp either
    stats.record_result_hit(0.1)
    snap = stats.snapshot()
    assert snap["queries_completed"] == 1
    assert snap["qps_busy"] == 0.0 and snap["teps"] == 0.0
    stats.record_busy(0.5)
    assert stats.snapshot()["qps_busy"] == pytest.approx(2.0)


def test_park_and_restore_counters_split():
    stats = ServiceStats()
    stats.record_preempt(0.004)
    stats.record_restore(0.001)
    snap = stats.snapshot()
    assert snap["park_ms"] == pytest.approx(4.0)
    assert snap["restore_ms"] == pytest.approx(1.0)
    # back-compat: the pre-split sum is still published
    assert snap["park_restore_ms"] == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# deadline misses
# ---------------------------------------------------------------------------

def test_deadline_miss_counters_aggregate_and_per_tenant(small_graph):
    svc = _service(small_graph, scheduling="bucketed",
                   result_cache_size=0)
    # an already-expired deadline must retire as a miss, not a shed
    fut = svc.submit(QueryRequest("g", "bfs", {"root": 0},
                                  deadline_ms=0.0, tenant="late"))
    svc.flush()
    fut.result(timeout=30)
    snap = svc.stats_snapshot()
    assert snap["deadline_misses"] == 1
    assert snap["queries_shed"] == 0
    assert snap["tenants"]["late"]["deadline_misses"] == 1
    # the retire event records the (negative) slack
    retired = [sp for sp in svc.trace.spans().values()
               if sp.outcome == "retired"]
    assert retired and retired[0].deadline_slack_s is not None
    assert retired[0].deadline_slack_s <= 0.0


def test_deadline_miss_continuous(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=2,
                   result_cache_size=0)
    fut = svc.submit(QueryRequest("g", "bfs", {"root": 1},
                                  deadline_ms=0.0, tenant="late"))
    svc.flush()
    fut.result(timeout=30)
    snap = svc.stats_snapshot()
    assert snap["deadline_misses"] >= 1
    assert snap["tenants"]["late"]["deadline_misses"] >= 1


# ---------------------------------------------------------------------------
# counter conservation
# ---------------------------------------------------------------------------

def _check_conservation(snap, *, in_flight_ok=False):
    in_flight = snap["pending"]
    if not in_flight_ok:
        assert in_flight == 0
    assert (snap["queries_submitted"]
            == snap["queries_completed"] + snap["queries_shed"]
            + in_flight), snap
    # tenant breakdowns sum to the aggregates (in-flight queries are
    # submitted but not yet completed/shed, hence the slack term above;
    # the per-tenant sums have no such slack — tenants are recorded at
    # the same points as the aggregates)
    tenants = snap["tenants"]
    assert sum(t["submitted"] for t in tenants.values()) \
        == snap["queries_submitted"]
    assert sum(t["shed"] for t in tenants.values()) \
        == snap["queries_shed"]
    assert sum(t["completed"] for t in tenants.values()) \
        == snap["queries_completed"]
    assert sum(t["result_cache_hits"] for t in tenants.values()) \
        == snap["result_cache_hits"]
    assert sum(t["deadline_misses"] for t in tenants.values()) \
        == snap["deadline_misses"]


@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_counter_conservation_with_hits_and_sheds(small_graph, scheduling):
    svc = _service(small_graph, scheduling=scheduling, slots=4)
    # quota: tenant "q" admits exactly one query, sheds the rest
    svc.set_tenant("q", rate_qps=0.001, burst=1)
    reqs = ([QueryRequest("g", "bfs", {"root": int(i)},
                          deadline_ms=60_000, tenant="a")
             for i in range(4)]
            + [QueryRequest("g", "bfs", {"root": 9}, deadline_ms=60_000,
                            tenant="q") for _ in range(3)])
    futs = _run(svc, reqs)
    shed = sum(1 for f in futs if f.exception(timeout=30) is not None)
    assert shed == 2                       # quota burst of 1 admitted 1
    # identical resubmits are result-cache hits (completed, no engine)
    for f in _run(svc, [QueryRequest("g", "bfs", {"root": 0},
                                     deadline_ms=60_000, tenant="a")
                        for _ in range(2)]):
        f.result(timeout=30)
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 2
    assert snap["queries_shed"] == 2
    _check_conservation(snap)


def test_counter_conservation_mid_flight(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=2,
                   result_cache_size=0)
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": int(i)},
                                    deadline_ms=60_000))
            for i in range(5)]
    snap = svc.stats_snapshot()
    assert snap["pending"] == 5            # nothing pumped yet
    _check_conservation(snap, in_flight_ok=True)
    svc.poll()                             # some admitted, none done yet
    _check_conservation(svc.stats_snapshot(), in_flight_ok=True)
    svc.flush()
    for f in futs:
        f.result(timeout=30)
    _check_conservation(svc.stats_snapshot())


def test_counter_conservation_preemption_path():
    g = _mixed_graph(300, 6.0, 40)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2,
                            result_cache_size=0, device="cpu")
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "bfs")
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": 300},
                                    deadline_ms=60_000, tenant="bg")),
            svc.submit(QueryRequest("g", "bfs", {"root": 339},
                                    deadline_ms=60_000, tenant="bg"))]
    for _ in range(3):
        svc.poll()
    _check_conservation(svc.stats_snapshot(), in_flight_ok=True)
    futs.append(svc.submit(QueryRequest("g", "bfs", {"root": 5},
                                        deadline_ms=25, priority=1,
                                        tenant="fg")))
    svc.flush()
    for f in futs:
        f.result(timeout=30)
    snap = svc.stats_snapshot()
    assert snap["preemptions"] >= 1        # the path under test was taken
    _check_conservation(snap)


# ---------------------------------------------------------------------------
# store residency events
# ---------------------------------------------------------------------------

def test_store_emits_residency_transitions(small_graph):
    bus = TraceBus()
    store = GraphStore(num_shards=2, versioned=True)
    store.set_trace(bus)
    store.publish("a", small_graph)
    kinds = [e.kind for e in bus.snapshot()]
    assert kinds == ["publish"]
    ev = bus.snapshot()[0]
    assert ev.attrs["graph_id"] == "a" and ev.attrs["version"] == 1
    assert ev.attrs["num_edges"] == small_graph.num_edges
    # spill (policy evict), then refault on acquire
    assert store.evict("a")
    kinds = [e.kind for e in bus.snapshot()]
    assert kinds == ["publish", "spill"]
    with store.acquire("a"):
        pass
    kinds = [e.kind for e in bus.snapshot()]
    assert kinds == ["publish", "spill", "refault"]
    refault = bus.snapshot()[-1]
    assert refault.attrs["cold"] is False and refault.dur_s >= 0.0
    # forced discard -> evict event
    assert store.evict("a", spill=False)
    assert [e.kind for e in bus.snapshot()][-1] == "evict"


def test_service_trace_has_store_events(small_graph):
    svc = _service(small_graph, scheduling="bucketed")
    kinds = {e.kind for e in svc.trace.snapshot()}
    assert "publish" in kinds              # add_graph went over the bus


# ---------------------------------------------------------------------------
# tracing can be turned off
# ---------------------------------------------------------------------------

def test_tracing_off_emits_nothing(small_graph):
    svc = _service(small_graph, scheduling="continuous", slots=2,
                   tracing=False, result_cache_size=0)
    for f in _run(svc, [QueryRequest("g", "bfs", {"root": 0},
                                     deadline_ms=60_000)]):
        f.result(timeout=30)
    assert svc.trace.emitted == 0
    snap = svc.stats_snapshot()
    assert snap["trace_events"] == 0 and snap["trace_dropped"] == 0
    # stats are unaffected: the roofline still accounts the class
    assert snap["roofline"]                # non-empty


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _kinds_per_query(svc, reqs):
    """Each request's trace event kinds, in emission order, plus the
    store's residency events (kind and graph)."""
    per = {r.qid: [] for r in reqs}
    store = []
    for e in svc.trace.snapshot():
        if e.qid in per:
            per[e.qid].append(e.kind)
        elif e.kind in ("publish", "spill", "refault", "evict"):
            store.append((e.kind, e.attrs.get("graph_id"),
                          e.attrs.get("version")))
    return [per[r.qid] for r in reqs], store


@pytest.mark.parametrize("path", ["bucketed", "continuous", "preempt"])
def test_trace_event_order_matches_jax(small_graph, path):
    from repro.service import GraphQueryService as JaxService
    from repro.service import QueryRequest as JaxRequest
    if path == "preempt":
        graph = _mixed_graph(300, 6.0, 40)
        kw = dict(num_shards=4, max_batch=8, scheduling="continuous",
                  slots=2, result_cache_size=0)
        waves = [[(300, 60_000.0, 0), (339, 60_000.0, 0)],
                 [(5, 25.0, 1)]]
    else:
        graph = small_graph
        kw = dict(num_shards=2, max_batch=4, scheduling=path, slots=3,
                  result_cache_size=0)
        rng = np.random.default_rng(6)
        waves = [[(int(r), 600_000.0, 0) for r in
                  rng.integers(0, graph.num_vertices, 5)] for _ in range(2)]
    t0 = time.perf_counter()
    seen = []
    for svc, Req, g in ((JaxService(backend="ref", **kw), JaxRequest,
                         jax_graph(graph)),
                        (GraphQueryService(device="cpu", **kw),
                         QueryRequest, graph)):
        svc.add_graph("g", g, pad_multiple=16)
        reqs = []
        for wave in waves:
            batch = [Req("g", "bfs", {"root": r}, deadline_ms=d,
                         priority=p, arrival_s=t0) for r, d, p in wave]
            for r in batch:
                svc.submit(r)
            reqs += batch
            for _ in range(3):
                svc.poll()
        svc.flush()
        seen.append(_kinds_per_query(svc, reqs))
    assert seen[1] == seen[0]
    kinds = {k for per in seen[1][0] for k in per}
    assert {"submit", "retire"} <= kinds
    assert seen[1][1] and seen[1][1][0][0] == "publish"
    if path == "preempt":
        assert {"park", "restore"} <= kinds
