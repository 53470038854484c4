"""The engine's spans and counters (``repro_torch.core.obs``) on the CPU.

Under ``torch.profiler`` every ``Engine.run`` / ``run_batch`` gives one
span tree: one ``engine.call`` holding ``engine.init`` (with the
superstep-0 ``engine.apply``), one ``engine.sync`` per read of the live
bits (supersteps + 1), one ``engine.superstep`` per loop iteration and
``engine.collect``; each superstep holds its phases a fixed number of
times (the deliver's and ``update_stats``'s counts are two
``engine.stats``; a kernel with a carry scatters and combines it in a
second ``engine.scatter`` / ``engine.combine``). A ``LaneStepper``'s
verbs give the same spans without the call. With no profiler a span is
the shared no-op and no ``record_function`` is built. Results are
bit-identical either way; ``engine.lanes_scanned`` and
``engine.messages`` count what the calls did; the continuous service
counts the bytes of each whole-carry fetch.
"""
import collections
import contextlib
import types
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import obs
from repro_torch.core import stepper
from repro_torch.core.engine import Engine, query_tensors
from repro_torch.core.engine_shardmap import ShardEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import partition_graph
from repro_torch.core.stepper import tree_nbytes
from repro_torch.service import GraphQueryService, QueryRequest
from repro_torch.service.continuous import ContinuousScheduler

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

PREFIXES = ("engine.", "service.")
PHASES = ("engine.broadcast", "engine.scatter", "engine.combine",
          "engine.stats", "engine.gather", "engine.apply", "engine.freeze")


@pytest.fixture(scope="module")
def pg():
    g = TG.rmat(7, 6, seed=3, weighted=True).symmetrized()
    return partition_graph(g, 4, method="greedy")


def _spans(prof):
    """Each span of the port as (event, its nearest enclosing span)."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PREFIXES):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIXES):
            p = p.cpu_parent
        out.append((e, p))
    return out


def _children(spans, parent):
    return collections.Counter(e.name for e, p in spans
                               if p is not None and p.id == parent.id)


def _per_superstep(kernel):
    """Each phase's spans in one superstep of the one-device engine."""
    carry = 2 if kernel.carry_dtype is not None else 1
    return {"engine.broadcast": 1, "engine.scatter": carry,
            "engine.combine": carry, "engine.stats": 2, "engine.gather": 1,
            "engine.apply": 1, "engine.freeze": 1}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _leaves(carry):
    """A host carry's arrays, field by field."""
    for part in carry:
        yield from (part.values() if isinstance(part, dict) else [part])


def _same(a, b):
    assert a.supersteps == b.supersteps and a.messages == b.messages
    assert a.comm == b.comm
    assert set(a.state) == set(b.state)
    for k in a.state:
        np.testing.assert_array_equal(a.state[k], b.state[k])


# PageRank takes no per-query array, so only ``run``
CASES = [(alg, mode, entry) for mode in ("gravfm", "gravf")
         for alg, entry in (("bfs", "run"), ("bfs", "run_batch"),
                            ("sssp", "run"), ("sssp", "run_batch"),
                            ("pagerank", "run"))]


@pytest.mark.parametrize("alg,mode,entry", CASES)
def test_engine_span_tree_counters_and_results(pg, alg, mode, entry):
    kernel = (TA.pagerank(num_supersteps=5) if alg == "pagerank"
              else TA.ALGORITHMS[alg]())
    eng = Engine(kernel, pg, mode=mode, device="cpu")
    roots = np.array([0, 9, 33])

    def call():
        if entry == "run":
            return [eng.run(**({} if alg == "pagerank" else {"root": 9}))]
        return eng.run_batch(root=roots)

    plain = call()
    before = obs.counters.snapshot()
    traced, spans = _profiled(call)
    after = obs.counters.snapshot()
    for a, b in zip(plain, traced):
        _same(a, b)

    steps = max(r.supersteps for r in traced)
    assert steps > 1
    names = collections.Counter(e.name for e, _ in spans)
    (top, parent), = [(e, p) for e, p in spans if e.name == "engine.call"]
    assert parent is None and not any(p is None for e, p in spans
                                      if e is not top)
    assert _children(spans, top) == {"engine.init": 1, "engine.collect": 1,
                                     "engine.sync": steps + 1,
                                     "engine.superstep": steps}
    init, = [e for e, _ in spans if e.name == "engine.init"]
    assert _children(spans, init) == {"engine.apply": 1}
    want = _per_superstep(kernel)
    for e, _ in spans:
        if e.name == "engine.superstep":
            assert _children(spans, e) == want
        elif e.name in PHASES:
            assert not _children(spans, e)
    # call, init and its apply, collect; a sync more than supersteps
    assert sum(names.values()) == 5 + 2 * steps + steps * sum(want.values())

    lanes = (eng._data.src_slot if mode == "gravfm"
             else eng._data.pair_src_slot).numel()
    assert eng._prog.lanes == lanes
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert grew == {"engine.lanes_scanned": steps * len(traced) * lanes,
                    "engine.messages": sum(r.messages for r in traced),
                    "engine.supersteps": steps}


def _grew(before):
    after = obs.counters.snapshot()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _shard(kernel, pg):
    return ShardEngine(kernel, pg, mesh=LocalMesh(4, "cpu"))


def _offloaded(kernel, pg):
    eng = Engine(kernel, pg, device="cpu")
    assert eng.offload() > 0 and not eng.device_resident
    return eng


@pytest.mark.parametrize("entry", ["run", "run_batch"])
@pytest.mark.parametrize("make", [
    lambda k, pg: Engine(k, pg, device="cpu"), _offloaded, _shard],
    ids=["cpu", "offloaded", "shard"])
def test_eager_loops_count_supersteps_and_no_replays(pg, make, entry):
    """The CPU engine, an offloaded one and the shard engine run the
    eager loop: one ``engine.supersteps`` a step dispatch (the batch's
    deepest query), never a graph replay or capture; their span tree is
    the eager one."""
    eng = make(TA.sssp(), pg)
    for cap in (None, 3):
        before = obs.counters.snapshot()
        if entry == "run":
            out, spans = _profiled(lambda: [eng.run(cap, root=9)])
        else:
            out, spans = _profiled(
                lambda: eng.run_batch(cap, root=np.array([0, 9, 33])))
        steps = max(r.supersteps for r in out)
        assert steps == (cap or steps) and steps > 1
        grew = _grew(before)
        assert grew["engine.supersteps"] == steps
        assert not {"engine.graph_replays", "engine.graph_captures"} & set(
            grew)
        names = collections.Counter(e.name for e, _ in spans)
        assert names["engine.superstep"] == steps
        assert names["engine.sync"] == steps + 1
        assert names["engine.freeze"] == steps


def test_one_device_engine_takes_no_graph_off_the_card(pg):
    eng = Engine(TA.bfs(), pg, device="cpu")
    assert eng._graph(1, {}) is None
    eng.offload()
    assert eng._graph(1, {}) is None and not eng._graphs


@pytest.mark.parametrize("entry", ["run", "run_batch"])
def test_run_eager_equals_run_and_takes_no_graph(pg, monkeypatch, entry):
    """``run_eager`` gives what ``run`` / ``run_batch`` give, with the
    same trace counts, and never asks for a graph."""
    eng = Engine(TA.sssp(), pg, device="cpu")
    twin = Engine(TA.sssp(), pg, device="cpu")
    query = ({"root": 9} if entry == "run"
             else {"root": np.array([0, 9, 33])})
    want = getattr(twin, entry)(4, **query)
    want = want if entry == "run_batch" else [want]
    monkeypatch.setattr(Engine, "_graph", _no_graph)
    got = eng.run_eager(entry, 4, **query)
    assert eng.traces == twin.traces == 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.supersteps, a.messages, a.comm) == (
            b.supersteps, b.messages, b.comm)
        for k in b.state:
            np.testing.assert_array_equal(a.state[k], b.state[k])
    with pytest.raises(ValueError, match="entry"):
        eng.run_eager("lanes", root=9)


def _no_graph(self, batch, qkw):
    raise AssertionError("the call asked for a superstep graph")


@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_service_runs_the_eager_loop(monkeypatch, scheduling):
    """The service's plans and steppers never ask for a superstep graph:
    the store's budget charges an engine its data alone."""
    monkeypatch.setattr(Engine, "_graph", _no_graph)
    svc = GraphQueryService(device="cpu", scheduling=scheduling,
                            max_batch=4)
    svc.add_graph("g", TG.rmat(7, 6, seed=3, weighted=True).symmetrized())
    svc.warm("g", "sssp")
    before = obs.counters.snapshot()
    futs = [svc.submit(QueryRequest("g", "sssp", {"root": r}))
            for r in (0, 9, 33, 50, 61)]
    svc.flush()
    assert all(f.result(timeout=0).supersteps > 0 for f in futs)
    grew = _grew(before)
    assert not {"engine.graph_replays", "engine.graph_captures"} & set(grew)


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("name", ["bfs", "wcc", "sssp", "pagerank",
                                  "degree"])
def test_graphed_loop_equals_the_eager_loop(pg, monkeypatch, name, batch):
    """The graphed loop on the CPU, a capture standing in for each graph
    (its replay runs the body): every call's carry equals the eager
    loop's bit for bit, at the kernel's cap and at 2 supersteps, with
    other roots each call; the init and the first superstep of the first
    call run eagerly and capture, every later superstep is a replay, and
    every later init a replay of the init graph."""
    replayed = collections.Counter()

    def capture(*bodies):
        def stand_in(body):
            def replay():
                replayed[body.__name__] += 1
                body()
            return types.SimpleNamespace(replay=replay)
        return [stand_in(body) for body in bodies]
    monkeypatch.setattr(stepper, "_capture", capture)
    kernel = TA.ALGORITHMS[name]()
    eng = Engine(kernel, pg, device="cpu")
    graph = stepper.SuperstepGraph(eng._prog, eng._data, eng.params, batch,
                                   eng.device)
    full = kernel.max_supersteps or 10_000
    for i, cap in enumerate((full, 2, full)):
        qkw = {}
        if kernel.query_params:
            roots = np.roll([0, 9, 33, 50, 61, 2, 7, 100], i)[:batch]
            qkw = query_tensors(kernel, {"root": roots}, eng.device,
                                batch=True)
        want = eng._prog.run_loop(eng._data, cap, eng.params, qkw, batch)
        before = obs.counters.snapshot()
        got = graph.run_loop(cap, qkw)
        assert replayed["_init"] == i
        steps = int(want.superstep.max())
        assert 0 < steps <= cap
        for a, b in zip(_leaves(want), _leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        grew = _grew(before)
        assert grew["engine.supersteps"] == steps
        assert grew.get("engine.graph_replays", 0) == steps - (i == 0)
        assert grew.get("engine.graph_captures", 0) == (i == 0)


def test_a_step_carry_is_freed_before_the_next_step(pg):
    """The superstep loop holds no step's output past its freeze: one
    more carry alive through the next step raises the device's peak."""
    eng = Engine(TA.sssp(), pg, device="cpu")
    real, outs = eng._prog.step, []

    def step(data, carry):
        assert all(r() is None for r in outs)
        out = real(data, carry)
        outs.append(weakref.ref(out.payload))
        return out
    eng._prog.step = step
    assert eng.run_batch(root=np.array([0, 9]))[0].supersteps == len(outs)


def test_lane_stepper_spans_and_counters(pg):
    eng = Engine(TA.sssp(), pg, device="cpu")
    st = eng.make_stepper(4)
    roots = {"root": np.array([0, 9, 33, 50], np.int32)}

    def drive():
        carry, act, _ = st.init(roots)
        for _ in range(3):
            carry, act, _ = st.step(carry, act)
        carry, act, _ = st.admit(carry, {"root": np.array([1, 9, 33, 50],
                                                          np.int32)},
                                 np.array([True, False, False, False]))
        return carry

    plain = st.fetch(drive())
    before = obs.counters.snapshot().get("engine.lanes_scanned", 0)
    carry, spans = _profiled(drive)
    assert obs.counters.snapshot()["engine.lanes_scanned"] - before \
        == 3 * 4 * eng._data.src_slot.numel()
    for a, b in zip(_leaves(plain), _leaves(st.fetch(carry))):
        np.testing.assert_array_equal(a, b)
    top = collections.Counter(e.name for e, p in spans if p is None)
    # init and admit: an init each; init, 3 steps and admit: a sync each;
    # the admit's select is a freeze
    assert top == {"engine.init": 2, "engine.sync": 5,
                   "engine.superstep": 3, "engine.freeze": 1}
    want = _per_superstep(eng.kernel)
    for e, _ in spans:
        if e.name == "engine.superstep":
            assert _children(spans, e) == want


def test_no_profiler_builds_no_record_function(pg, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("engine.call") is obs.span("engine.sync")
    assert isinstance(obs.span("x"), contextlib.nullcontext)
    eng = Engine(TA.sssp(), pg, device="cpu")
    assert eng.run_batch(root=np.array([0, 9]))[0].supersteps > 1
    st = eng.make_stepper(2)
    carry, act, _ = st.init({"root": np.array([0, 9], np.int32)})
    st.step(carry, act)


def test_counters_add_and_snapshot():
    c = obs.Counters()
    c.add("a", 2)
    c.add("a", 3)
    c.add("b", 1)
    snap = c.snapshot()
    assert snap == {"a": 5, "b": 1}
    c.add("a", 1)
    assert snap["a"] == 5 and c.snapshot()["a"] == 6


def test_service_counts_carry_fetch_bytes(pg, monkeypatch):
    fetched = []
    real = ContinuousScheduler._retire

    def retire(self, qclass, cr):
        fetch = cr.table.fetch

        def counted():
            host = fetch()
            fetched.append(tree_nbytes(host))
            return host
        cr.table.fetch = counted
        try:
            return real(self, qclass, cr)
        finally:
            del cr.table.fetch
    monkeypatch.setattr(ContinuousScheduler, "_retire", retire)
    svc = GraphQueryService(device="cpu", scheduling="continuous",
                            max_batch=4)
    g = TG.rmat(7, 6, seed=3, weighted=True).symmetrized()
    svc.add_graph("g", g)
    futs = [svc.submit(QueryRequest("g", "sssp", {"root": r}))
            for r in (0, 9, 33, 50, 61)]

    def serve():
        svc.flush()
        return [f.result(timeout=0) for f in futs]
    _, spans = _profiled(serve)
    snap = svc.stats_snapshot()
    assert fetched and all(n > 0 for n in fetched)
    assert snap["carry_fetch_bytes_total"] == sum(fetched)
    names = collections.Counter(e.name for e, _ in spans)
    assert names["service.retire_fetch"] == len(fetched)
