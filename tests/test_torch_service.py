"""The port's query service against the JAX service on the same requests.

The JAX ``GraphQueryService`` runs with its oracle (``backend="ref"``);
the port's runs on the CPU (``device="cpu"``) with its default
``backend="kernel"`` (the kernel's plain version there). Both get the
same graph (the port's ``Graph`` holds the JAX graph's arrays) and the
same seeded request stream, and every ``EngineResult`` field must be
equal: exactly, except PageRank's float32 scores, compared at rtol =
1e-5, atol = 1e-8 (float32 sums taken in another order), as in
tests/test_torch_engine.py. The scheduler is driven by hand
(``submit``/``poll``/``flush``), so no test waits on a thread.
"""
import math

import numpy as np
import pytest
import torch

from benchmarks.continuous import _mixed_graph
from repro.core import graph as G
from repro.service import GraphQueryService as JaxService
from repro.service import QueryRequest as JaxRequest
from repro_torch.core import algorithms as TA
from repro_torch.core import perfmodel
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
from repro_torch.core.engine_shardmap import ShardEngine
from repro_torch.service import (GraphQueryService, PlanCache, PlanKey,
                                 QueryRequest)

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

KERNELS = ("bfs", "sssp", "wcc", "pagerank", "degree")


def _port_graph(g):
    return TG.Graph(g.num_vertices, g.src.copy(), g.dst.copy(),
                    None if g.weights is None else g.weights.copy())


@pytest.fixture(scope="module")
def graph():
    return G.uniform(240, 5.0, seed=11, weighted=True).symmetrized()


def _stream(n_vertices, n=24, seed=5):
    """A seeded mix of every kernel; rooted kernels get random roots."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kernel = KERNELS[int(rng.integers(len(KERNELS)))]
        kw = ({"root": int(rng.integers(n_vertices))}
              if kernel in ("bfs", "sssp") else {})
        out.append((kernel, kw, f"t{i % 2}"))
    return out


def _assert_result(got, want, kernel):
    assert got.supersteps == want.supersteps
    assert got.messages == want.messages
    assert got.comm == want.comm
    for view in ("state", "raw_state"):
        g, w = getattr(got, view), getattr(want, view)
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (view, k)
            if kernel == "pagerank" and k == "score":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{view}.{k}")


def _services(graph, **kw):
    jsvc = JaxService(backend="ref", **kw)
    tsvc = GraphQueryService(device="cpu", **kw)
    jsvc.add_graph("g", graph, pad_multiple=16)
    tsvc.add_graph("g", _port_graph(graph), pad_multiple=16)
    return jsvc, tsvc


# ---------------------------------------------------------------------------
# one request stream through both services
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_service_matches_jax(graph, scheduling):
    jsvc, tsvc = _services(graph, max_batch=8, slots=4,
                           scheduling=scheduling, result_cache_size=0)
    stream = _stream(graph.num_vertices)
    jf = [jsvc.submit(JaxRequest("g", k, kw, tenant=t, deadline_ms=60_000))
          for k, kw, t in stream]
    tf = [tsvc.submit(QueryRequest("g", k, kw, tenant=t,
                                   deadline_ms=60_000))
          for k, kw, t in stream]
    jsvc.flush()
    tsvc.flush()
    for (kernel, _, _), j, t in zip(stream, jf, tf):
        _assert_result(t.result(timeout=0), j.result(timeout=0), kernel)
    jsnap, tsnap = jsvc.stats_snapshot(), tsvc.stats_snapshot()
    # the port's one key more: the whole-carry fetch bytes
    assert set(tsnap) == set(jsnap) | {"carry_fetch_bytes_total"}
    assert set(tsnap["tenants"]) == set(jsnap["tenants"]) == {"t0", "t1"}
    for name in ("queries_completed", "messages_total", "supersteps_total",
                 "wire_words_total", "batches_dispatched", "plan_traces"):
        assert tsnap[name] == jsnap[name]
    # the same metric families (the Prometheus names stay gravfm_*)
    tmetrics = tsvc.metrics_snapshot()
    assert set(tmetrics) == set(jsvc.metrics_snapshot())
    assert all(n.startswith("gravfm_") for n in tmetrics)


def _serve(svc, Request, stream):
    """The stream through ``svc`` once every class is warm (a dispatch
    that traces accounts its wall as compile time, not busy time); the
    per-class roofline accounting."""
    for k in KERNELS:
        svc.warm("g", k, batch_sizes=None if k in ("bfs", "sssp") else [1])
    futs = [svc.submit(Request("g", k, kw, tenant=t, deadline_ms=60_000))
            for k, kw, t in stream]
    svc.flush()
    for f in futs:
        f.result(timeout=0)
    return svc.stats_snapshot()["roofline"]


def test_roofline_projection_matches_jax(graph):
    """Against the paper's platform (the default) every class projects as
    the JAX service projects it; against the card (perfmodel.H100) a
    class projects on one card, with no wire term, and its efficiency is
    above 0."""
    jsvc, tsvc = _services(graph, max_batch=8, result_cache_size=0)
    stream = _stream(graph.num_vertices)
    jroof = _serve(jsvc, JaxRequest, stream)
    troof = _serve(tsvc, QueryRequest, stream)
    assert set(troof) == set(jroof) and len(troof) == len(KERNELS)
    for ck in jroof:
        assert tsvc.projected_limits(ck) == jsvc.projected_limits(ck), ck
        assert math.isfinite(tsvc.projected_limits(ck)["L_if"])
    card = GraphQueryService(device="cpu", max_batch=8, result_cache_size=0,
                             roofline_platform=perfmodel.H100)
    card.add_graph("g", _port_graph(graph), pad_multiple=16)
    roof = _serve(card, QueryRequest, stream)
    wl = perfmodel.Workload(graph.num_vertices, graph.num_edges)
    for ck, r in roof.items():
        lim = card.projected_limits(ck)
        assert lim["L_if"] == lim["L_net"] == math.inf
        algo = perfmodel.H100_ALGOS.get(ck.split("/")[1],
                                        perfmodel.H100_ALGOS["bfs"])
        assert lim["T_sys"] == perfmodel.limits(
            perfmodel.H100, algo, wl, n_nodes=1)["T_sys"] == \
            r["projected_teps"]
        assert r["efficiency"] == r["teps"] / lim["T_sys"] > 0


def test_service_preemption_matches_jax():
    """A tight-deadline, priority-1 arrival parks a deep lane in both
    services; every answer, parked or not, equals JAX's and a solo run,
    and nothing is traced anew across the park/restore cycle."""
    g = _mixed_graph(300, 6.0, 40)
    results = []
    for cls, req, kw in ((JaxService, JaxRequest, {"backend": "ref"}),
                         (GraphQueryService, QueryRequest,
                          {"device": "cpu"})):
        svc = cls(num_shards=4, max_batch=8, scheduling="continuous",
                  slots=2, result_cache_size=0, **kw)
        svc.add_graph("g", g if cls is JaxService else _port_graph(g),
                      pad_multiple=16)
        svc.warm("g", "bfs")    # pre-traces admit/step AND park/restore
        traces0 = svc.stats_snapshot()["plan_traces"]
        deep = [svc.submit(req("g", "bfs", {"root": r},
                               deadline_ms=60_000)) for r in (300, 339)]
        for _ in range(3):
            svc.poll()
        assert not any(f.done() for f in deep)     # slots full, mid-flight
        fg = svc.submit(req("g", "bfs", {"root": 5}, deadline_ms=25,
                            priority=1))
        for _ in range(12):
            svc.poll()
            if fg.done():
                break
        assert fg.done(), "foreground never preempted a lane"
        assert svc.stats_snapshot()["preemptions"] >= 1
        svc.flush()
        snap = svc.stats_snapshot()
        assert snap["lane_restores"] >= 1 and snap["parked_lanes"] == 0
        assert snap["plan_traces"] == traces0
        results.append([f.result(timeout=0) for f in deep + [fg]])
    pg = TPT.partition_graph(_port_graph(g), 4, pad_multiple=16)
    eng = Engine(TA.bfs(), pg, device="cpu")
    for root, want, got in zip((300, 339, 5), *results):
        _assert_result(got, want, "bfs")
        _assert_result(got, eng.run(root=root), "bfs")


def test_two_parked_lanes_restore_in_aged_order():
    """Two lanes parked at once come back in aged-deadline order, the
    second one parked first, and every answer equals a solo run. (The
    JAX service's ``ParkedQueue.pop_best`` removes the entry it restores
    with ``list.remove``, which compares two parked carries with ``==``
    and raises ValueError here; the port removes it by position.)"""
    g = _port_graph(_mixed_graph(300, 6.0, 40))
    svc = GraphQueryService(device="cpu", max_batch=8, slots=2,
                            scheduling="continuous", result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "bfs")
    deep = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                    deadline_ms=60_000)) for r in (300, 339)]
    for _ in range(3):
        svc.poll()
    fg = [svc.submit(QueryRequest("g", "bfs", {"root": r}, deadline_ms=25,
                                  priority=1)) for r in (5, 6)]
    svc.flush()
    snap = svc.stats_snapshot()
    assert snap["preemptions"] == 2 and snap["lane_restores"] == 2
    eng = Engine(TA.bfs(), TPT.partition_graph(g, 4, pad_multiple=16),
                 device="cpu")
    for root, fut in zip((300, 339, 5, 6), deep + fg):
        _assert_result(fut.result(timeout=0), eng.run(root=root), "bfs")


@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_plan_traces_flat_after_warm(graph, scheduling):
    svc = GraphQueryService(device="cpu", max_batch=8, slots=4,
                            scheduling=scheduling, result_cache_size=0)
    svc.add_graph("g", _port_graph(graph), pad_multiple=16)
    for kernel in ("bfs", "sssp"):
        svc.warm("g", kernel)
    warm = svc.stats_snapshot()["plan_traces"]
    assert warm > 0
    for wave in range(3):
        futs = [svc.submit(QueryRequest("g", k, {"root": r},
                                        deadline_ms=60_000))
                for k in ("bfs", "sssp") for r in range(wave, 40, 7)]
        svc.flush()
        assert all(f.result(timeout=0).supersteps > 0 for f in futs)
        assert svc.stats_snapshot()["plan_traces"] == warm


def test_plan_cache_hit_miss_and_zero_retrace(graph):
    cache = PlanCache(device="cpu")
    cache.register_graph("g", _port_graph(graph), num_shards=4,
                         pad_multiple=16)
    key = PlanKey(graph_id="g", kernel="bfs", mode="gravfm", num_shards=4,
                  batch_size=8)
    assert key.backend == "kernel"
    plan = cache.get_plan(key, warm=True)
    traces = cache.sync_trace_counters()
    assert traces == 1 and cache.stats.plan_cache_misses == 1
    assert cache.get_plan(key) is plan
    plan.execute(root=np.arange(8))
    plan.execute(root=np.arange(8) + 8)
    assert cache.sync_trace_counters() == traces
    cache.get_plan(PlanKey("g", "bfs", "gravfm", 4, 4), warm=True)
    assert cache.sync_trace_counters() == traces + 1
    assert len({id(e) for e in cache._engines.values()}) == 1


def test_result_cache_partitioned_by_tenant(graph):
    """One tenant's burst does not evict another tenant's hot results,
    and a tenant never hits another tenant's entry."""
    svc = GraphQueryService(device="cpu", max_batch=1, result_cache_size=2)
    svc.add_graph("g", _port_graph(graph), pad_multiple=16)
    first = svc.query("g", "bfs", root=0, tenant="a")
    for r in range(1, 6):
        svc.query("g", "bfs", root=r, tenant="b")
    assert len(svc._result_cache["b"]) == 2
    b0 = svc.stats_snapshot()["batches_dispatched"]
    hit = svc.query("g", "bfs", root=0, tenant="a")
    snap = svc.stats_snapshot()
    assert snap["result_cache_hits"] == 1
    assert snap["batches_dispatched"] == b0
    assert snap["tenants"]["a"]["result_cache_hits"] == 1
    assert snap["tenants"]["b"]["result_cache_hits"] == 0
    _assert_result(hit, first, "bfs")
    hit.state["parent"][:] = -7          # a hit is a copy, not an alias
    again = svc.query("g", "bfs", root=0, tenant="a")
    _assert_result(again, first, "bfs")
    svc.query("g", "bfs", root=0, tenant="b")
    assert svc.stats_snapshot()["batches_dispatched"] == b0 + 1


def test_store_publish_spill_and_refault(graph):
    """A version publish moves new arrivals to the new graph; the store's
    spill offloads the version's engines (plans stay), a dispatch while
    spilled still answers, and the refault uploads them back with no new
    trace and identical results."""
    g1 = _port_graph(graph)
    g2 = _port_graph(G.uniform(240, 5.0, seed=12,
                               weighted=True).symmetrized())
    svc = GraphQueryService(device="cpu", max_batch=4, slots=4,
                            scheduling="continuous", result_cache_size=0)
    assert svc.publish("g", g1, pad_multiple=16) == 1
    before = svc.query("g", "sssp", root=3, deadline_ms=60_000)
    svc.query("g", "wcc", deadline_ms=60_000)
    assert svc.publish("g", g2, pad_multiple=16) == 2
    v2 = svc.query("g", "sssp", root=3, deadline_ms=60_000)
    want2 = Engine(TA.sssp(), TPT.partition_graph(g2, 4, pad_multiple=16),
                   device="cpu").run(root=3)
    _assert_result(v2, want2, "sssp")
    # a bucket-1 plan beside the stepper, on the same engine
    plan = svc.plans.get_plan(PlanKey("g", "sssp", "gravfm", 4, 1,
                                      version=2))
    _assert_result(plan.execute(root=np.int32(3))[0], want2, "sssp")
    snap0 = svc.stats_snapshot()
    engines = [e for k, e in svc.plans._engines.items() if k[1] == 2]
    assert engines and all(e.device_resident for e in engines)
    assert svc.store.evict("g")                     # the store's spill
    assert all(not e.device_resident for e in engines)
    spilled = svc.store.snapshot()
    assert spilled["spills"] >= 1 and spilled["spilled_bytes"] > 0
    # a dispatch while spilled: the engine stages its host copies
    _assert_result(plan.execute(root=np.int32(3))[0], want2, "sssp")
    assert all(not e.device_resident for e in engines)
    after = svc.query("g", "sssp", root=3, deadline_ms=60_000)  # refault
    assert all(e.device_resident for e in engines)
    _assert_result(after, want2, "sssp")
    snap1 = svc.stats_snapshot()
    assert snap1["plan_traces"] == snap0["plan_traces"]
    assert snap1["store_faults"] >= snap0["store_faults"] + 1
    assert snap1["store_refault_upload_ms"] > 0.0
    assert snap1["store_discards"] == snap0["store_discards"]
    assert before.supersteps > 0


def test_shard_classes_and_backends_rejected(graph, monkeypatch):
    """The shard classes are served (``exchange="combined"`` builds the
    port's ShardEngine with its four shards on the cache's device); an
    unknown exchange and the JAX package's ``backend="pallas"`` are
    refused."""
    svc = GraphQueryService(device="cpu", exchange="combined")
    assert svc.exchange == "combined"
    cache = PlanCache(device="cpu")
    cache.register_graph("g", _port_graph(graph), num_shards=4,
                         pad_multiple=16)
    plan = cache.get_plan(PlanKey("g", "bfs", "gravfm", 4, 1,
                                  exchange="combined"))
    assert isinstance(plan.engine, ShardEngine)
    assert plan.engine.mesh.devices == ("cpu",) * 4
    res = plan.execute(root=np.int32(3))[0]
    want = Engine(TA.bfs(), TPT.partition_graph(_port_graph(graph), 4,
                                                pad_multiple=16),
                  device="cpu").run(root=3)
    assert (res.supersteps, res.messages) == (want.supersteps,
                                              want.messages)
    np.testing.assert_array_equal(res.state["parent"], want.state["parent"])
    assert res.comm["exchange"] == "combined"
    for bad in (lambda: GraphQueryService(device="cpu", exchange="mesh"),
                lambda: PlanKey("g", "bfs", "gravfm", 4, 1,
                                exchange="mesh")):
        with pytest.raises(ValueError, match="exchange"):
            bad()
    with pytest.raises(ValueError, match="kernel"):
        GraphQueryService(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="kernel"):
        PlanKey("g", "bfs", "gravfm", 4, 1, backend="pallas")
    assert GraphQueryService(device="cpu").backend == "kernel"
    assert GraphQueryService(device="cpu", backend="ref").backend == "ref"
    assert GraphQueryService(plan_cache=cache).device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        GraphQueryService(device="meta", plan_cache=cache)
    # the card unless the caller asks for the CPU; no silent fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphQueryService()
    with pytest.raises(RuntimeError, match="CUDA"):
        PlanCache()
