"""The query service's shard classes (``exchange != ""``) in the port
against the JAX service on the same requests.

The JAX ``GraphQueryService(num_shards=4, exchange="combined")`` needs 4
devices: one module-scoped subprocess with 4 forced host devices serves
the streams (its oracle, ``backend="ref"``) and saves every answer to an
``.npz``. The port's service serves the same streams on the CPU
(``device="cpu"``, its kernel path; the four shards of a class share the
one device through ``LocalMesh``). Every ``EngineResult`` field must be
equal (PageRank is not in these streams, so exactly), every answer must
equal the port's one-device ``Engine``, and ``plan_traces`` must stay
flat after ``warm``. The streams: bucketed and continuous with
``overlap`` toggled per request, and continuous with a priority-1 arrival
that parks a deep lane. The schedulers are driven by hand
(``submit``/``poll``/``flush``), so no test waits on a thread.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmarks.continuous import _mixed_graph
from repro.core import graph as G
from repro_torch.core import algorithms as TA
from repro_torch.core import perfmodel
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
from repro_torch.core.engine_shardmap import EXCHANGES, ShardEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch.service import (GraphQueryService, PlanKey, QueryClass,
                                 QueryRequest)

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

SNAPSHOT_KEYS = ("queries_completed", "messages_total", "supersteps_total",
                 "wire_words_total", "plan_traces")
DEEP, FOREGROUND = (300, 339), 5


def _stream(n_vertices, n=24, seed=5):
    """A seeded mix of BFS and SSSP, every other request overlapped."""
    rng = np.random.default_rng(seed)
    return [("bfs" if rng.integers(3) else "sssp",
             int(rng.integers(n_vertices)), i % 2 == 1) for i in range(n)]


def _graph():
    return G.uniform(240, 5.0, seed=11, weighted=True).symmetrized()


_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import numpy as np
from benchmarks.continuous import _mixed_graph
from repro.core import graph as G
from repro.service import GraphQueryService, QueryRequest

out = {{}}
def save(tag, res):
    for view in ("state", "raw_state"):
        for k, v in getattr(res, view).items():
            out[f"{{tag}}/{{view}}/{{k}}"] = np.asarray(v)
    out[f"{{tag}}/meta"] = np.array(json.dumps(
        [res.supersteps, res.messages, res.comm]))

g = G.uniform(240, 5.0, seed=11, weighted=True).symmetrized()
for sched in ("bucketed", "continuous"):
    svc = GraphQueryService(num_shards=4, exchange="combined",
                            scheduling=sched, max_batch=8, slots=4,
                            result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    for k in ("bfs", "sssp"):
        for ov in (False, True):
            svc.warm("g", k, overlap=ov)
    warm = svc.stats_snapshot()["plan_traces"]
    futs = [svc.submit(QueryRequest("g", k, {{"root": r}},
                                    deadline_ms=60_000, overlap=ov))
            for k, r, ov in {stream!r}]
    svc.flush()
    for i, f in enumerate(futs):
        save(f"{{sched}}.{{i}}", f.result(timeout=0))
    snap = svc.stats_snapshot()
    out[f"{{sched}}/snap"] = np.array(json.dumps(
        [warm] + [snap[k] for k in {keys!r}]))
    out[f"{{sched}}/limits"] = np.array(json.dumps(
        {{ck: svc.projected_limits(ck) for ck in snap["roofline"]}}))

svc = GraphQueryService(num_shards=4, exchange="combined",
                        scheduling="continuous", slots=2,
                        result_cache_size=0)
svc.add_graph("g", _mixed_graph(300, 6.0, 40), pad_multiple=16)
svc.warm("g", "bfs")
warm = svc.stats_snapshot()["plan_traces"]
deep = [svc.submit(QueryRequest("g", "bfs", {{"root": r}},
                                deadline_ms=60_000)) for r in {deep!r}]
for _ in range(3):
    svc.poll()
fg = svc.submit(QueryRequest("g", "bfs", {{"root": {fg!r}}},
                             deadline_ms=25, priority=1))
for _ in range(12):
    svc.poll()
    if fg.done():
        break
svc.flush()
for i, f in enumerate(deep + [fg]):
    save(f"preempt.{{i}}", f.result(timeout=0))
snap = svc.stats_snapshot()
out["preempt/snap"] = np.array(json.dumps(
    [warm, snap["plan_traces"], snap["preemptions"],
     snap["lane_restores"]]))
np.savez({out!r}, **out)
print("JAX-SHARD-SERVICE-OK")
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_shard_service") / "results.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    script = _SCRIPT.format(
        src=os.path.join(root, "src"), root=root,
        stream=_stream(_graph().num_vertices), keys=SNAPSHOT_KEYS,
        deep=DEEP, fg=FOREGROUND, out=str(path))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-SHARD-SERVICE-OK" in proc.stdout
    print(f"JAX shard service subprocess: {time.perf_counter() - t0:.1f} s")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _port_graph(g):
    return TG.Graph(g.num_vertices, g.src.copy(), g.dst.copy(),
                    None if g.weights is None else g.weights.copy())


def _assert_result(got, jax_results, tag):
    supersteps, messages, comm = json.loads(str(jax_results[tag + "/meta"]))
    assert (got.supersteps, got.messages, got.comm) == (supersteps,
                                                        messages, comm)
    for view in ("state", "raw_state"):
        want = {k.split("/")[2]: v for k, v in jax_results.items()
                if k.startswith(f"{tag}/{view}/")}
        have = getattr(got, view)
        assert set(have) == set(want), view
        for k, v in want.items():
            a = np.asarray(have[k])
            assert a.dtype == v.dtype and a.shape == v.shape, (view, k)
            np.testing.assert_array_equal(a, v, err_msg=f"{view}.{k}")


def _same_as_engine(got, want):
    assert (got.supersteps, got.messages) == (want.supersteps,
                                              want.messages)
    for k, v in want.state.items():
        np.testing.assert_array_equal(got.state[k], v)


@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_shard_service_matches_jax(jax_results, scheduling):
    g = _graph()
    svc = GraphQueryService(device="cpu", num_shards=4, exchange="combined",
                            scheduling=scheduling, max_batch=8, slots=4,
                            result_cache_size=0)
    svc.add_graph("g", _port_graph(g), pad_multiple=16)
    for k in ("bfs", "sssp"):
        for ov in (False, True):
            svc.warm("g", k, overlap=ov)
    warm = svc.stats_snapshot()["plan_traces"]
    stream = _stream(g.num_vertices)
    futs = [svc.submit(QueryRequest("g", k, {"root": r}, deadline_ms=60_000,
                                    overlap=ov)) for k, r, ov in stream]
    svc.flush()
    pg = TPT.partition_graph(_port_graph(g), 4, pad_multiple=16)
    one = {k: Engine(TA.ALGORITHMS[k](), pg, device="cpu")
           for k in ("bfs", "sssp")}
    for i, ((kernel, root, _), f) in enumerate(zip(stream, futs)):
        res = f.result(timeout=0)
        _assert_result(res, jax_results, f"{scheduling}.{i}")
        _same_as_engine(res, one[kernel].run(root=root))
    snap = svc.stats_snapshot()
    want = json.loads(str(jax_results[f"{scheduling}/snap"]))
    assert [warm] + [snap[k] for k in SNAPSHOT_KEYS] == want
    assert snap["plan_traces"] == warm
    # one engine a kernel serves both schedules
    assert len(svc.plans._engines) == 2
    assert all(isinstance(e, ShardEngine)
               for e in svc.plans._engines.values())


def test_shard_class_projection(jax_results):
    """A shard class projects against the paper's platform as the JAX
    service's shard class does (four nodes, the combined exchange's
    wire); against the card (perfmodel.H100) its four shards share one
    card's L_PE and L_mem and cross no wire, and its efficiency is above
    0."""
    g = _graph()
    stream = _stream(g.num_vertices)
    want = json.loads(str(jax_results["bucketed/limits"]))
    wl = perfmodel.Workload(g.num_vertices, g.num_edges)
    for platform in (None, perfmodel.H100):
        svc = GraphQueryService(device="cpu", num_shards=4,
                                exchange="combined", max_batch=8,
                                result_cache_size=0,
                                roofline_platform=platform)
        svc.add_graph("g", _port_graph(g), pad_multiple=16)
        for k in ("bfs", "sssp"):
            for ov in (False, True):
                svc.warm("g", k, overlap=ov)
        futs = [svc.submit(QueryRequest("g", k, {"root": r},
                                        deadline_ms=60_000, overlap=ov))
                for k, r, ov in stream]
        svc.flush()
        for f in futs:
            f.result(timeout=0)
        roof = svc.stats_snapshot()["roofline"]
        assert set(roof) == set(want) and len(roof) == 4
        for ck, r in roof.items():
            lim = svc.projected_limits(ck)
            if platform is None:
                assert lim == want[ck], ck
                assert math.isfinite(lim["L_if"])
                continue
            assert lim["L_if"] == lim["L_net"] == math.inf
            one = perfmodel.limits(perfmodel.H100,
                                   perfmodel.H100_ALGOS["bfs"], wl,
                                   n_nodes=1)
            assert (lim["L_PE"], lim["L_mem"]) == (one["L_PE"],
                                                   one["L_mem"])
            assert r["efficiency"] == r["teps"] / lim["T_sys"] > 0


def test_shard_service_preemption_matches_jax(jax_results):
    """A tight-deadline, priority-1 arrival parks a deep lane of a shard
    class; every answer equals JAX's and the one-device engine's, and the
    park/restore cycle traces nothing."""
    g = _port_graph(_mixed_graph(300, 6.0, 40))
    svc = GraphQueryService(device="cpu", num_shards=4, exchange="combined",
                            scheduling="continuous", slots=2,
                            result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "bfs")
    warm = svc.stats_snapshot()["plan_traces"]
    deep = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                    deadline_ms=60_000)) for r in DEEP]
    for _ in range(3):
        svc.poll()
    assert not any(f.done() for f in deep)     # slots full, mid-flight
    fg = svc.submit(QueryRequest("g", "bfs", {"root": FOREGROUND},
                                 deadline_ms=25, priority=1))
    for _ in range(12):
        svc.poll()
        if fg.done():
            break
    assert fg.done(), "foreground never preempted a lane"
    svc.flush()
    snap = svc.stats_snapshot()
    jwarm, jtraces, jparks, jrestores = json.loads(
        str(jax_results["preempt/snap"]))
    assert snap["preemptions"] >= 1 and jparks >= 1
    assert snap["lane_restores"] >= 1 and jrestores >= 1
    assert snap["parked_lanes"] == 0
    assert snap["plan_traces"] == warm == jwarm == jtraces
    eng = Engine(TA.bfs(), TPT.partition_graph(g, 4, pad_multiple=16),
                 device="cpu")
    for i, (root, f) in enumerate(zip(DEEP + (FOREGROUND,), deep + [fg])):
        res = f.result(timeout=0)
        _assert_result(res, jax_results, f"preempt.{i}")
        _same_as_engine(res, eng.run(root=root))


def test_continuous_shard_class_names_mesh_devices():
    """A continuous shard class attributes its supersteps to the devices
    of its mesh: the lane table's ``devices`` and every superstep trace
    event name the four shards' device (the class run used to read a JAX
    ``Mesh``'s ``devices.flat``, which the port's meshes do not have)."""
    g = _port_graph(_graph())
    svc = GraphQueryService(device="cpu", num_shards=4, exchange="ring",
                            scheduling="continuous", slots=4,
                            result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                    deadline_ms=60_000)) for r in (0, 9)]
    svc.poll()
    runs = list(svc._continuous._classes.values())
    assert len(runs) == 1
    mesh = runs[0].splan.engine.mesh
    assert mesh.devices == ("cpu",) * 4
    assert runs[0].table.devices == mesh.devices
    svc.flush()
    steps = [e for e in svc.trace_snapshot() if e.kind == "superstep"]
    assert steps and all(e.attrs["devices"] == ["cpu"] * 4 for e in steps)
    eng = Engine(TA.bfs(), TPT.partition_graph(g, 4, pad_multiple=16),
                 device="cpu")
    for r, f in zip((0, 9), futs):
        _same_as_engine(f.result(timeout=0), eng.run(root=r))


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_every_exchange_serves(exchange):
    """Each of the five exchanges serves as a shard class, bucketed, with
    the answers of the one-device engine; a plan key names the exchange
    and an unknown one is refused."""
    g = _port_graph(_graph())
    svc = GraphQueryService(device="cpu", num_shards=4, exchange=exchange,
                            max_batch=4, result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    roots = (0, 9, 77, 150, 200)
    futs = [svc.submit(QueryRequest("g", "sssp", {"root": r},
                                    deadline_ms=60_000)) for r in roots]
    svc.flush()
    eng = Engine(TA.sssp(), TPT.partition_graph(g, 4, pad_multiple=16),
                 device="cpu")
    for r, f in zip(roots, futs):
        res = f.result(timeout=0)
        assert res.comm["exchange"] == exchange
        _same_as_engine(res, eng.run(root=r))
    (engine,) = svc.plans._engines.values()
    assert engine.exchange == exchange
    assert isinstance(engine.mesh, LocalMesh)
    assert QueryClass.of(QueryRequest("g", "sssp", {"root": 0}), 4,
                         "kernel", 1, exchange=exchange).exchange == exchange
    with pytest.raises(ValueError, match="exchange"):
        PlanKey("g", "bfs", "gravfm", 4, 1, exchange="mesh")


def test_shard_class_spill_and_refault():
    """The store's spill offloads a shard class's engine (plans and
    steppers stay); a dispatch while spilled answers as before; the next
    query refaults it back with no new trace."""
    g = _port_graph(_graph())
    svc = GraphQueryService(device="cpu", num_shards=4, exchange="combined",
                            max_batch=4, slots=4, scheduling="continuous",
                            result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    svc.warm("g", "sssp")
    before = svc.query("g", "sssp", root=3, deadline_ms=60_000)
    plan = svc.plans.get_plan(PlanKey("g", "sssp", "gravfm", 4, 1,
                                      exchange="combined"), warm=True)
    snap0 = svc.stats_snapshot()
    (engine,) = svc.plans._engines.values()
    assert engine.device_resident
    assert svc.store.evict("g")
    assert not engine.device_resident
    assert svc.store.snapshot()["spilled_bytes"] > 0
    during = plan.execute(root=np.int32(3))[0]
    assert not engine.device_resident
    after = svc.query("g", "sssp", root=3, deadline_ms=60_000)
    assert engine.device_resident
    for res in (during, after):
        assert (res.supersteps, res.messages, res.comm) == (
            before.supersteps, before.messages, before.comm)
        for k, v in before.state.items():
            np.testing.assert_array_equal(res.state[k], v)
    snap1 = svc.stats_snapshot()
    assert snap1["plan_traces"] == snap0["plan_traces"]
    assert snap1["store_refault_upload_ms"] > 0.0


def test_bucketed_request_overlap_runs_its_schedule():
    """A bucketed batch of a shard class runs the schedule its requests
    asked for: requests with ``overlap=True`` go through the overlapped
    plan, the others through the synchronous one, with the same answers.
    (The JAX service's bucketed dispatch passes only the exchange to its
    plan key, so every batch there runs the service's default schedule.)"""
    g = _port_graph(_graph())
    svc = GraphQueryService(device="cpu", num_shards=4, exchange="combined",
                            max_batch=4, result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    for ov in (False, True):
        svc.warm("g", "bfs", batch_sizes=[4], overlap=ov)
    plans = {k.overlap: p for k, p in svc.plans._plans.items()}
    runs = {ov: plans[ov].executions for ov in (False, True)}
    futs = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                    deadline_ms=60_000, overlap=ov))
            for ov in (False, True) for r in (0, 9, 77, 150)]
    svc.flush()
    assert {ov: plans[ov].executions - runs[ov] for ov in runs} == {
        False: 1, True: 1}
    for sync, ovl in zip(futs[:4], futs[4:]):
        a, b = sync.result(timeout=0), ovl.result(timeout=0)
        assert (a.supersteps, a.messages, a.comm) == (b.supersteps,
                                                      b.messages, b.comm)
        np.testing.assert_array_equal(a.state["parent"], b.state["parent"])
