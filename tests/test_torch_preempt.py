"""The port's twin of ``tests/test_preempt.py``, over ``repro_torch`` on
the CPU (``device="cpu"``), plus parity with the JAX package.

Preemptible lane lifecycle: a preempted (parked) query restored into
a freed slot must be bit-identical to an uninterrupted run — state,
superstep count and message count — across gravfm and gravf modes,
single- and multi-shard (the shard_map variant runs in a subprocess);
park/restore cycles must re-trace nothing after warm; deadline-priority
preemption must let a tight-deadline arrival jump a fully occupied slot
array; deadline aging must prevent starvation under a continuous stream
of higher-priority arrivals (hypothesis property); and the parked-carry
bytes must be charged against the store's spill budget.

Adapted from the reference: the mixed-depth graph is
``benchmarks.continuous._mixed_graph`` rebuilt over the port's ``Graph``
(``_torch_twins.mixed_graph``, held equal to it below); the threaded
preempt-while-retiring test hands off with events instead of joining in
a loop; the forced-4-device JAX subprocess becomes the port's
``ShardEngine`` on ``LocalMesh(4, "cpu")``, held to its own contract and
to the same JAX subprocess's answers.
"""
import os
import subprocess
import sys
import json
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from repro_torch.core import algorithms as ALG
from repro_torch.core import graph as G
from repro_torch.core import partition as PT
from repro_torch.core.engine import Engine
from repro_torch.core.stepper import LaneMeta, LaneTable
from repro_torch.service import (GraphQueryService, QueryRequest, ServiceStats)
from repro_torch.store import GraphStore
from _torch_twins import (COUNTERS, assert_same_result, jax_graph,
                          jax_service, serve_waves, wait_for_arrival)
from _torch_twins import mixed_graph as _mixed_graph


@pytest.fixture(scope="module")
def deep_graph():
    # ladder: BFS depth varies strongly with the root, so parked lanes
    # genuinely have work left when restored
    return G.ladder(2, 30, 1, seed=0)


# ---------------------------------------------------------------------------
# LaneTable park/restore == uninterrupted run (engine level)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gravfm", "gravf"])
def test_park_restore_bit_identity(deep_graph, mode):
    """checkpoint -> run other work -> restore must resume the lane
    bit-identically (same state, superstep count, messages, comm stats)
    to never having been parked."""
    pg = PT.partition_graph(deep_graph, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.bfs(), pg, mode=mode, backend="ref", device="cpu")
    n = deep_graph.num_vertices
    tab = LaneTable(eng.make_stepper(2), 2, ("root",))
    tab.admit({0: LaneMeta(payload="A", qkw={"root": 0}),
               1: LaneMeta(payload="B", qkw={"root": n - 1})})
    for _ in range(3):
        tab.step(tab.alive_mask(10_000))
    ck = tab.checkpoint(0)          # park A at superstep 3
    assert ck.superstep == 3 and ck.nbytes > 0
    # admit C into A's old slot; run B and C to completion
    tab.admit({0: LaneMeta(payload="C", qkw={"root": n // 2})})
    while tab.alive_mask(10_000).any():
        tab.step(tab.alive_mask(10_000))
    host = tab.fetch()
    results = {"C": eng.lane_result(host, 0), "B": eng.lane_result(host, 1)}
    tab.release(0), tab.release(1)
    tab.restore(0, ck)              # un-park A
    while tab.alive_mask(10_000).any():
        tab.step(tab.alive_mask(10_000))
    results["A"] = eng.lane_result(tab.fetch(), 0)
    traces0 = eng.traces
    for name, root in (("A", 0), ("B", n - 1), ("C", n // 2)):
        ref = Engine(ALG.bfs(root), pg, mode=mode, backend="ref",
                     device="cpu").run()
        res = results[name]
        assert np.array_equal(res.state["parent"], ref.state["parent"]), name
        assert res.supersteps == ref.supersteps, name
        assert res.messages == ref.messages, name
        assert res.comm["messages"] == ref.comm["messages"], name
    # a second park/restore cycle re-traces nothing
    tab.release(0)
    tab.admit({1: LaneMeta(payload="D", qkw={"root": 7})})
    tab.step(tab.alive_mask(10_000))
    ck2 = tab.checkpoint(1)
    tab.restore(1, ck2)
    while tab.alive_mask(10_000).any():
        tab.step(tab.alive_mask(10_000))
    resD = eng.lane_result(tab.fetch(), 1)
    refD = Engine(ALG.bfs(7), pg, mode=mode, backend="ref", device="cpu").run()
    assert np.array_equal(resD.state["parent"], refD.state["parent"])
    assert resD.supersteps == refD.supersteps
    assert eng.traces == traces0


def test_park_restore_sssp_carry(deep_graph):
    """The argmin-carry (SSSP parent pointer) state survives a park."""
    g = G.uniform(200, 6.0, seed=5, weighted=True).symmetrized()
    pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
    eng = Engine(ALG.sssp(), pg, mode="gravfm", backend="ref", device="cpu")
    tab = LaneTable(eng.make_stepper(2), 2, ("root",))
    tab.admit({0: LaneMeta(payload=0, qkw={"root": 0}),
               1: LaneMeta(payload=1, qkw={"root": 99})})
    tab.step(tab.alive_mask(10_000))
    tab.step(tab.alive_mask(10_000))
    ck = tab.checkpoint(0)
    while tab.alive_mask(10_000).any():
        tab.step(tab.alive_mask(10_000))
    tab.release(1)
    tab.restore(1, ck)          # restore into a DIFFERENT slot
    while tab.alive_mask(10_000).any():
        tab.step(tab.alive_mask(10_000))
    res = eng.lane_result(tab.fetch(), 1)
    ref = Engine(ALG.sssp(0), pg, mode="gravfm", backend="ref",
                 device="cpu").run()
    assert np.array_equal(res.state["dist"].view(np.int32),
                          ref.state["dist"].view(np.int32))
    assert np.array_equal(res.state["parent"], ref.state["parent"])


# ---------------------------------------------------------------------------
# service-level deadline-priority preemption
# ---------------------------------------------------------------------------

def test_service_preemption_end_to_end():
    """A tight-deadline, high-priority arrival finding every slot busy
    parks the laxest deep lane, completes fast, and the parked query is
    restored and finishes bit-identically — with zero re-traces across
    the whole park/restore cycle (the acceptance criterion)."""
    g = _mixed_graph(300, 6.0, 40)
    pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=2,
                            result_cache_size=0, device="cpu")
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "bfs")        # pre-traces admit/step AND park/restore
    traces0 = svc.stats_snapshot()["plan_traces"]
    deep = [svc.submit(QueryRequest("g", "bfs", {"root": 300},
                                    deadline_ms=60_000)),
            svc.submit(QueryRequest("g", "bfs", {"root": 339},
                                    deadline_ms=60_000))]
    for _ in range(3):
        svc.poll()
    assert not any(f.done() for f in deep)       # slots full, mid-flight
    fg = svc.submit(QueryRequest("g", "bfs", {"root": 5},
                                 deadline_ms=25, priority=1))
    for _ in range(12):
        svc.poll()
        if fg.done():
            break
    assert fg.done(), "foreground never preempted a lane"
    snap = svc.stats_snapshot()
    assert snap["preemptions"] >= 1
    assert not all(f.done() for f in deep)
    svc.flush()
    snap = svc.stats_snapshot()
    assert snap["lane_restores"] >= 1
    assert snap["parked_lanes"] == 0
    assert snap["park_restore_ms"] > 0.0
    # bit-identity for everyone, preempted or not
    for root, fut in ((300, deep[0]), (339, deep[1]), (5, fg)):
        ref = Engine(ALG.bfs(root), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        res = fut.result(timeout=0)
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps
        assert res.messages == ref.messages
    # the whole preempt->park->restore cycle re-traced NOTHING
    assert snap["plan_traces"] == traces0


def test_preemption_off_runs_to_retire():
    """preemption=False restores the old behavior: the tight arrival
    waits for a natural retire."""
    g = _mixed_graph(200, 6.0, 30)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=1,
                            result_cache_size=0, preemption=False,
                                device="cpu")
    svc.add_graph("g", g, pad_multiple=16)
    deep = svc.submit(QueryRequest("g", "bfs", {"root": 200},
                                   deadline_ms=60_000))
    svc.poll()
    fg = svc.submit(QueryRequest("g", "bfs", {"root": 3},
                                 deadline_ms=5, priority=1))
    for _ in range(5):
        svc.poll()
    assert not fg.done()                 # no slot ever freed early
    assert svc.stats_snapshot()["preemptions"] == 0
    svc.flush()
    assert fg.result() is not None and deep.result() is not None


def test_parked_bytes_charged_against_spill_budget():
    """Parks reserve host bytes in the store's spill budget; a zero
    budget (host tier disabled) refuses every park, so preemption
    silently degrades to run-to-retire."""
    g = _mixed_graph(200, 6.0, 30)
    svc = GraphQueryService(num_shards=4, max_batch=8,
                            scheduling="continuous", slots=1,
                            result_cache_size=0, spill_budget=0, device="cpu")
    svc.add_graph("g", g, pad_multiple=16)
    deep = svc.submit(QueryRequest("g", "bfs", {"root": 200},
                                   deadline_ms=60_000))
    svc.poll()
    fg = svc.submit(QueryRequest("g", "bfs", {"root": 3},
                                 deadline_ms=5, priority=1))
    for _ in range(5):
        svc.poll()
    assert svc.stats_snapshot()["preemptions"] == 0   # budget refused
    svc.flush()
    assert fg.result() is not None and deep.result() is not None
    # and with an unbounded budget the charge round-trips to zero
    store = GraphStore()
    assert store.reserve_parked(1024) is True
    assert store.snapshot()["parked_bytes"] == 1024.0
    store.release_parked(1024)
    assert store.snapshot()["parked_bytes"] == 0.0
    # a bounded budget admits until full, then refuses an infeasible
    # park up front (without discarding anything to make room it can
    # never have)
    store2 = GraphStore(spill_budget_bytes=100)
    assert store2.reserve_parked(60) is True
    assert store2.reserve_parked(60) is False
    assert store2.snapshot()["parked_bytes"] == 60.0
    assert store2.snapshot()["discards"] == 0


# ---------------------------------------------------------------------------
# fake-stepper harness (threaded race + starvation property) — shared
# with tests/test_continuous.py
# ---------------------------------------------------------------------------

from _fake_stepper_torch import fake_scheduler, submit_fake  # noqa: E402


def _fake_scheduler(slots=1, **kw):
    return fake_scheduler(slots=slots, **kw)


_submit_fake = submit_fake


def test_threaded_preempt_while_retiring():
    """A tight-priority submit racing an in-flight drain must preempt at
    the next admission window; the preempted lane resumes (not
    restarts) and everyone resolves. The urgent query finishes first.
    The submit reaches the lock while A's superstep 1 holds it; both
    futures carry their done-callbacks before they are submitted."""
    stats = ServiceStats()
    go = threading.Event()
    in_step = threading.Event()

    def hook():
        in_step.set()
        go.wait(5)

    sched, qclass = _fake_scheduler(slots=1, stats=stats, step_hook=hook)
    order = []
    futA, futB = Future(), Future()
    futA.add_done_callback(lambda f: order.append("A"))
    futB.add_done_callback(lambda f: order.append("B"))
    _submit_fake(sched, qclass, depth=10, fut=futA)

    t = threading.Thread(target=sched.drain, daemon=True)
    t.start()
    assert in_step.wait(5)           # A's superstep 1 in flight
    s = threading.Thread(target=_submit_fake, args=(sched, qclass, 2),
                         kwargs={"deadline_ms": 10, "priority": 1,
                                 "fut": futB}, daemon=True)
    s.start()
    wait_for_arrival(sched)          # B waits for the lock
    go.set()
    s.join(5)
    t.join(5)
    assert not s.is_alive(), "submit never landed"
    assert not t.is_alive(), "drain never finished"
    assert futB.result(timeout=0).supersteps == 2
    # A RESUMED from its parked superstep: total superstep count intact
    assert futA.result(timeout=0).supersteps == 10
    assert order == ["B", "A"]
    assert stats.preemptions >= 1 and stats.lane_restores >= 1
    assert sched.parked() == 0 and sched.pending() == 0


def test_starvation_aging_deterministic():
    """Fixed adversarial stream (runs even without hypothesis): a
    priority-0 deep query keeps completing with its exact superstep
    count despite repeated preemption by priority-3 arrivals, because
    aggressive aging credit outranks the priority boost."""
    stats = ServiceStats()
    sched, qclass = _fake_scheduler(slots=1, stats=stats, aging_rate=1e7)
    bg = _submit_fake(sched, qclass, depth=12)
    sched.pump()
    fgs = []
    for d in (2, 1, 3, 2, 1):
        fgs.append(_submit_fake(sched, qclass, depth=d, deadline_ms=1,
                                priority=3))
        sched.pump()
    sched.drain(max_pumps=10_000)
    for d, f in zip((2, 1, 3, 2, 1), fgs):
        assert f.result(timeout=0).supersteps == d
    assert bg.result(timeout=0).supersteps == 12
    assert stats.preemptions >= 1
    assert sched.parked() == 0 and sched.pending() == 0


def test_starvation_aging_property():
    """Under ANY stream of higher-priority tight-deadline arrivals, a
    preempted query still completes — with its full superstep count
    (bit-identical resume across arbitrarily many park/restore cycles).
    With aggressive aging its credit outranks the priority boost, so it
    is restored ahead of queued urgent work and not re-parked."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st_

    @settings(max_examples=20, deadline=None)
    @given(st_.integers(5, 20),
           st_.lists(st_.integers(1, 4), min_size=1, max_size=6))
    def check(bg_depth, fg_depths):
        stats = ServiceStats()
        sched, qclass = _fake_scheduler(slots=1, stats=stats,
                                        aging_rate=1e7)
        bg = _submit_fake(sched, qclass, depth=bg_depth)
        sched.pump()                 # bg occupies the only lane
        fgs = []
        for d in fg_depths:
            fgs.append(_submit_fake(sched, qclass, depth=d,
                                    deadline_ms=1, priority=3))
            sched.pump()             # admission window: may preempt bg
        sched.drain(max_pumps=10_000)
        for d, f in zip(fg_depths, fgs):
            assert f.result(timeout=0).supersteps == d
        # the background query was parked (at least once for the first
        # urgent arrival) yet completed with its exact depth
        assert bg.result(timeout=0).supersteps == bg_depth
        assert sched.parked() == 0 and sched.pending() == 0

    check()


def test_missing_param_fails_future_not_strands():
    """A request missing a declared query param must fail ITS future
    (and the class) loudly — the meta is installed in the table before
    the kwarg write that raises, so the failure path can see it."""
    sched, qclass = _fake_scheduler(slots=2)
    fut = Future()
    sched.submit(qclass, QueryRequest("g", "fake", {},  # no "depth"
                                      deadline_ms=600_000), fut)
    sched.pump()
    with pytest.raises(KeyError):
        fut.result(timeout=0)
    assert sched.pending() == 0
    # the class recovers on the next (well-formed) submit
    ok = _submit_fake(sched, qclass, depth=2)
    sched.drain()
    assert ok.result(timeout=0).supersteps == 2


def test_depth_packing_orders_refill_by_predicted_depth():
    """With equal deadlines (same depth bucket), the refill pops queued
    work in predicted-depth order — the two shallow-predicted queries
    are co-scheduled and retire on the SAME pump, cutting retire-fetch
    churn; the deep-predicted one waits despite arriving first."""
    stats = ServiceStats()
    sched, qclass = _fake_scheduler(slots=2, stats=stats)
    from repro_torch.service.continuous import class_key
    ck = class_key(qclass)
    # evolve the class depth EWMA between submits so each queued item
    # snapshots a different prediction (deep arrives FIRST)
    stats.record_query_depth(ck, 9.0)
    f_deep = _submit_fake(sched, qclass, depth=8)    # predicted 9.0
    stats.record_query_depth(ck, 1.0)
    f_s1 = _submit_fake(sched, qclass, depth=2)      # predicted ~7.4
    stats.record_query_depth(ck, 1.0)
    f_s2 = _submit_fake(sched, qclass, depth=2)      # predicted ~6.1
    done_at = {}
    pump = 0
    while sched.has_work() and pump < 100:
        sched.pump()
        pump += 1
        for name, f in (("deep", f_deep), ("s1", f_s1), ("s2", f_s2)):
            if f.done() and name not in done_at:
                done_at[name] = pump
    assert f_deep.done() and f_s1.done() and f_s2.done()
    assert done_at["s1"] == done_at["s2"]   # packed, retired together
    assert done_at["deep"] > done_at["s1"]  # FIFO would have run first


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_mixed_graph_equals_the_benchmarks():
    """The port's rebuild of the CI benchmark's mixed-depth workload
    holds the benchmark's arrays."""
    from benchmarks.continuous import _mixed_graph as bench_mixed_graph
    for args in ((300, 6.0, 40), (200, 6.0, 30)):
        mine, theirs = _mixed_graph(*args), bench_mixed_graph(*args)
        assert mine.num_vertices == theirs.num_vertices
        np.testing.assert_array_equal(mine.src, theirs.src)
        np.testing.assert_array_equal(mine.dst, theirs.dst)
        assert mine.weights is None and theirs.weights is None


@pytest.mark.parametrize("mode", ["gravfm", "gravf"])
def test_lane_table_park_restore_matches_jax(deep_graph, mode):
    """The same park/restore sequence on the JAX LaneTable and the
    port's: the checkpoint's superstep and every lane's answer equal."""
    from repro.core import algorithms as JALG
    from repro.core import partition as JPT
    from repro.core.engine import Engine as JaxEngine
    from repro.core.stepper import LaneMeta as JaxMeta
    from repro.core.stepper import LaneTable as JaxTable
    n = deep_graph.num_vertices
    out = {}
    for tag, alg, pt, eng_cls, meta, table, kw in (
            ("jax", JALG, JPT, JaxEngine, JaxMeta, JaxTable, {}),
            ("torch", ALG, PT, Engine, LaneMeta, LaneTable,
             {"device": "cpu"})):
        graph = jax_graph(deep_graph) if tag == "jax" else deep_graph
        pg = pt.partition_graph(graph, 4, method="greedy", pad_multiple=16)
        eng = eng_cls(alg.bfs(), pg, mode=mode, backend="ref", **kw)
        tab = table(eng.make_stepper(2), 2, ("root",))
        tab.admit({0: meta(payload="A", qkw={"root": 0}),
                   1: meta(payload="B", qkw={"root": n - 1})})
        for _ in range(3):
            tab.step(tab.alive_mask(10_000))
        ck = tab.checkpoint(0)          # park A at superstep 3
        tab.admit({0: meta(payload="C", qkw={"root": n // 2})})
        while tab.alive_mask(10_000).any():
            tab.step(tab.alive_mask(10_000))
        host = tab.fetch()
        res = {"C": eng.lane_result(host, 0), "B": eng.lane_result(host, 1)}
        tab.release(0), tab.release(1)
        tab.restore(0, ck)              # un-park A
        while tab.alive_mask(10_000).any():
            tab.step(tab.alive_mask(10_000))
        res["A"] = eng.lane_result(tab.fetch(), 0)
        out[tag] = (ck.superstep, res)
    assert out["torch"][0] == out["jax"][0] == 3
    assert set(out["torch"][1]) == set(out["jax"][1]) == {"A", "B", "C"}
    for k, want in out["jax"][1].items():
        assert_same_result(out["torch"][1][k], want)


def test_preemption_stream_matches_jax():
    """The end-to-end preemption stream (two deep lanes fill the slots, a
    priority-1 arrival parks one) at one injected arrival time through
    the JAX service and the port's: every answer, the poll after which
    each query had retired, and the counters (preemptions and restores
    included) equal exactly."""
    from repro.service import QueryRequest as JaxRequest
    g = _mixed_graph(300, 6.0, 40)
    kw = dict(num_shards=4, max_batch=8, scheduling="continuous", slots=2,
              result_cache_size=0)
    jsvc = jax_service(g, **kw)
    tsvc = GraphQueryService(device="cpu", **kw)
    tsvc.add_graph("g", g, pad_multiple=16)
    deep = {"deadline_ms": 60_000.0}
    waves = [[("bfs", {"root": 300}, deep), ("bfs", {"root": 339}, deep)],
             [("bfs", {"root": 5}, {"deadline_ms": 25.0, "priority": 1})]]
    t0 = time.perf_counter()
    jf, jdone = serve_waves(jsvc, JaxRequest, waves, polls=6, arrival_s=t0)
    tf, tdone = serve_waves(tsvc, QueryRequest, waves, polls=6,
                            arrival_s=t0)
    jsvc.flush()
    tsvc.flush()
    assert tdone == jdone
    for j, t in zip(jf, tf):
        assert_same_result(t.result(timeout=0), j.result(timeout=0))
    jsnap, tsnap = jsvc.stats_snapshot(), tsvc.stats_snapshot()
    assert tsnap["preemptions"] >= 1
    for name in COUNTERS + ("parked_lanes", "deadline_misses"):
        assert tsnap[name] == jsnap[name], name


# ---------------------------------------------------------------------------
# shard engine checkpoint/restore across all four exchanges: the port on
# LocalMesh(4, "cpu"), the JAX ShardEngine in a subprocess with 4 forced
# host devices
# ---------------------------------------------------------------------------

_EXCHANGES = ("allgather", "ring", "frontier", "unicast")
_LANES = ((0, 0), (1, 100))

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro.core import graph as G, partition as PT, algorithms as ALG
from repro.core.engine_shardmap import ShardEngine
from repro.launch.mesh import compat_make_mesh

mesh = compat_make_mesh((4,), ("graph",))
g = G.uniform(200, 5.0, seed=3).symmetrized()
pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
out = {{}}
for exch in {exchanges!r}:
    se = ShardEngine(ALG.bfs(), pg, mesh=mesh, exchange=exch,
                     backend="ref")
    st = se.make_stepper(3)
    qkw = {{"root": np.array([0, 100, 0], np.int32)}}
    carry, act, steps = st.init(qkw)
    occ = np.array([True, True, False])
    for _ in range(2):
        carry, act, steps = st.step(carry, occ & act)
    ck = st.fetch_lane(carry, 0)
    occ[0] = False
    while (occ & act).any():
        carry, act, steps = st.step(carry, occ & act)
    fresh = np.zeros(3, bool)
    fresh[0] = True
    carry, act, steps = st.restore(carry, ck, fresh)
    occ[0] = True
    while (occ & act).any():
        carry, act, steps = st.step(carry, occ & act)
    host = st.fetch(carry)
    for lane, _ in {lanes!r}:
        res = se.lane_result(host, lane)
        out[f"{{exch}}.{{lane}}"] = [
            np.asarray(res["state"]["parent"]).tolist(),
            int(res["supersteps"]), int(res["messages"])]
print("JAX-PREEMPT-SHARD " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_shard_checkpoints():
    """The JAX ShardEngine's answers after the park/restore sequence, per
    exchange and lane (one subprocess with 4 forced host devices)."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _JAX_SCRIPT.format(src=os.path.abspath(src),
                                exchanges=_EXCHANGES, lanes=_LANES)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("JAX-PREEMPT-SHARD ")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[-1].split(" ", 1)[1])


@pytest.mark.parametrize("exch", _EXCHANGES)
def test_shardmap_checkpoint_multidevice(exch, jax_shard_checkpoints):
    """Park lane 0 at superstep 2 (fetching only its per-shard slices),
    run lane 1 to completion, restore lane 0 and finish it: both lanes
    bit-identical to a solo run and to the JAX ShardEngine; a second
    park/restore cycle builds nothing."""
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import LocalMesh
    g = G.uniform(200, 5.0, seed=3).symmetrized()
    pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
    se = ShardEngine(ALG.bfs(), pg, mesh=LocalMesh(4, "cpu"),
                     exchange=exch, backend="ref")
    st = se.make_stepper(3)
    qkw = {"root": np.array([0, 100, 0], np.int32)}
    carry, act, steps = st.init(qkw)
    occ = np.array([True, True, False])
    for _ in range(2):
        carry, act, steps = st.step(carry, occ & act)
    # park lane 0 at superstep 2: fetch ONLY its per-shard slices
    ck = st.fetch_lane(carry, 0)
    for leaf in _leaves(ck):
        assert tuple(leaf.shape[:1]) == (4,) or leaf.dim() <= 1
    occ[0] = False
    # run lane 1 to completion, then warm park/restore trace counters
    while (occ & act).any():
        carry, act, steps = st.step(carry, occ & act)
    fresh = np.zeros(3, bool)
    fresh[0] = True
    carry, act, steps = st.restore(carry, ck, fresh)
    occ[0] = True
    traces_steady = se.traces
    while (occ & act).any():
        carry, act, steps = st.step(carry, occ & act)
    # a SECOND park/restore cycle must re-trace nothing
    carry, act, steps = st.restore(carry, st.fetch_lane(carry, 2),
                                   np.zeros(3, bool))
    assert se.traces == traces_steady, exch
    host = st.fetch(carry)
    for lane, root in _LANES:
        res = se.lane_result(host, lane)
        ref = Engine(ALG.bfs(root), pg, mode="gravfm", backend="ref",
                     device="cpu").run()
        assert np.array_equal(res.state["parent"], ref.state["parent"])
        assert res.supersteps == ref.supersteps, (exch, lane)
        assert res.messages == ref.messages, (exch, lane)
        parent, supersteps, messages = jax_shard_checkpoints[
            f"{exch}.{lane}"]
        assert np.asarray(res.state["parent"]).tolist() == parent
        assert (res.supersteps, res.messages) == (supersteps, messages)


def _leaves(tree):
    if hasattr(tree, "dim"):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []
