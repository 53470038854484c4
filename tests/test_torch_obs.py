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
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import obs
from repro_torch.core.engine import Engine
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
                    "engine.messages": sum(r.messages for r in traced)}


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
