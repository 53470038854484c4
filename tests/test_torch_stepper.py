"""The port's lane stepper, lane table, ``mode="gravf"``, trace counter and
offload/upload against the JAX package on the same graph.

Both packages run on the very same ``PartitionedGraph`` (compiled by the
JAX package, carried across with ``repro_torch.convert``). The JAX engine
runs with its oracle (``backend="ref"``); the port runs on the CPU with
its kernel path (the kernel's plain version there) and its oracle. The
fetched carries must be equal after every init/admit/step/restore:
exactly, except PageRank's float32 scores and payloads, which are
compared at rtol = 1e-5, atol = 1e-8 (float32 sums taken in another
order), as in tests/test_torch_engine.py. The JAX engine's ``messages``
counter is int32 and the port's int64: their values must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import graph as G
from repro.core import partition as PT
from repro.core.engine import Engine as JaxEngine
from repro.core.stepper import LaneMeta as JaxLaneMeta
from repro.core.stepper import LaneTable as JaxLaneTable
from repro_torch import convert
from repro_torch.core import algorithms as TA
from repro_torch.core.engine import Engine
from repro_torch.core.stepper import LaneMeta, LaneTable

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TILES = dict(tile_e=64, tile_r=32)
WIDTH = 4
CAP = 10_000


def _both(g):
    pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
    fields = {f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)}
    return pg, convert.partitioned_graph_from_numpy(fields)


@pytest.fixture(scope="module")
def weighted():
    """A weighted graph with more than one component (so some roots
    finish early)."""
    return _both(G.uniform(200, 3.0, seed=9, weighted=True).symmetrized())


@pytest.fixture(scope="module")
def ladder():
    """BFS depth varies strongly with the root: parked lanes have work
    left when they are restored."""
    g = G.ladder(2, 30, 1, seed=0)
    return g.num_vertices, _both(g)


def _kernel(name, lib):
    if name == "pagerank":
        # PageRank declares no query parameter, and a lane stepper needs
        # one per lane: a root that its init_state ignores.
        return dataclasses.replace(lib.pagerank(6), query_params=("root",))
    return lib.ALGORITHMS[name]()


def _assert_carry(got, want, name, label=""):
    """A port carry (host numpy) against a JAX one, leaf by leaf."""
    leaves = [("superstep", got.superstep, want.superstep),
              ("active", got.active, want.active),
              ("payload", got.payload, want.payload)]
    leaves += [(f"state.{k}", got.state[k], want.state[k])
               for k in want.state]
    leaves += [(f"stats.{k}", got.stats[k], want.stats[k])
               for k in want.stats]
    assert set(got.state) == set(want.state)
    assert set(got.stats) == set(want.stats)
    for what, a, b in leaves:
        a, b = np.asarray(a), np.asarray(b)
        msg = f"{label} {what}"
        assert a.shape == b.shape, msg
        if what == "stats.messages":
            np.testing.assert_array_equal(a, b.astype(np.int64), msg)
            continue
        assert a.dtype == b.dtype, msg
        if name == "pagerank" and what in ("state.score", "payload"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(a, b, msg)


def _assert_result(got, want, name):
    assert got.supersteps == want.supersteps
    assert got.messages == want.messages
    assert got.comm == want.comm
    for view in ("state", "raw_state"):
        g, w = getattr(got, view), getattr(want, view)
        assert set(g) == set(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (view, k)
            if name == "pagerank" and k == "score":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{view}.{k}")


# ---------------------------------------------------------------------------
# LaneStepper against the JAX LaneStepper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_stepper_matches_jax(weighted, name, backend):
    jpg, tpg = weighted
    jst = JaxEngine(_kernel(name, JA), jpg, backend="ref",
                    **TILES).make_stepper(WIDTH)
    tst = Engine(_kernel(name, TA), tpg, backend=backend, device="cpu",
                 **TILES).make_stepper(WIDTH)

    def both(verb, jargs, targs, label):
        jc, jact, jsteps = getattr(jst, verb)(*jargs)
        tc, tact, tsteps = getattr(tst, verb)(*targs)
        np.testing.assert_array_equal(tact, jact, label)
        np.testing.assert_array_equal(tsteps, jsteps, label)
        assert tact.dtype == np.bool_ and tsteps.dtype == np.int32
        _assert_carry(tst.fetch(tc), jst.fetch(jc), name, label)
        return jc, tc, tact

    roots = np.array([0, 7, 99, 150], np.int32)
    jc, tc, act = both("init", ({"root": roots},), ({"root": roots},),
                       "init")
    for i in range(3):
        jc, tc, act = both("step", (jc, act), (tc, act), f"step {i}")
    # splice new queries into lanes 1 and 3 mid-flight
    fresh = np.array([False, True, False, True])
    roots2 = np.array([0, 42, 99, 199], np.int32)
    jc, tc, act = both("admit", (jc, {"root": roots2}, fresh),
                       (tc, {"root": roots2}, fresh), "admit")
    jc, tc, act = both("step", (jc, act), (tc, act), "step after admit")
    # park lane 2, step, and splice it back into lane 0
    jlane, tlane = jst.fetch_lane(jc, 2), tst.fetch_lane(tc, 2)
    _assert_carry(tlane, jlane, name, "fetch_lane")
    jc, tc, act = both("step", (jc, act), (tc, act), "step after park")
    back = np.array([True, False, False, False])
    jc, tc, act = both("restore", (jc, jlane, back), (tc, tlane, back),
                       "restore")
    for i in range(40):
        if not act.any():
            break
        jc, tc, act = both("step", (jc, act), (tc, act), f"tail {i}")
    # the wire words of the packed probe: the lanes' sum, as JAX's
    assert tst.last_wire_words == jst.last_wire_words


@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
def test_lanes_equal_solo_runs(weighted, name):
    """Lanes spliced in at different supersteps each retire with the
    result of a solo ``run`` of their query."""
    _, tpg = weighted
    eng = Engine(_kernel(name, TA), tpg, device="cpu", **TILES)
    table = LaneTable(eng.make_stepper(3), 3, ("root",))
    pending = [0, 7, 99, 150, 42, 199]
    done = {}
    table.admit({s: LaneMeta(payload=r, qkw={"root": r})
                 for s, r in enumerate(pending[:3])})
    queue = pending[3:]
    while table.in_flight():
        table.step(table.alive_mask(CAP))
        finished = table.done_slots(CAP)
        if finished:
            host = table.fetch()
            for s in finished:
                done[table.release(s).payload] = eng.lane_result(host, s)
        if queue and table.free_slots():
            s = table.free_slots()[0]
            r = queue.pop(0)
            table.admit({s: LaneMeta(payload=r, qkw={"root": r})})
    assert sorted(done) == sorted(pending)
    for r, res in done.items():
        solo = eng.run(root=r)
        assert res.supersteps == solo.supersteps
        assert res.messages == solo.messages
        assert res.comm == solo.comm
        for k in solo.state:
            np.testing.assert_array_equal(res.state[k], solo.state[k])
            np.testing.assert_array_equal(res.raw_state[k],
                                          solo.raw_state[k])


@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_profiled_step_equals_fused(weighted, name):
    _, tpg = weighted
    eng = Engine(_kernel(name, TA), tpg, device="cpu", **TILES)
    fused, prof = eng.make_stepper(WIDTH), eng.make_stepper(WIDTH + 1)
    prof.profile = True
    roots = np.array([0, 7, 99, 150], np.int32)
    c1, a1, s1 = fused.init({"root": roots})
    c2, a2, s2 = prof.init({"root": np.append(roots, 3)})
    for _ in range(6):
        alive = np.append(a1, a2[-1])
        c1, a1, s1 = fused.step(c1, a1)
        c2, a2, s2 = prof.step(c2, alive)
        assert fused.last_phases is None
        assert set(prof.last_phases) == {"scatter", "combine", "apply",
                                         "probe"}
        np.testing.assert_array_equal(a2[:WIDTH], a1)
        np.testing.assert_array_equal(s2[:WIDTH], s1)
    h1, h2 = fused.fetch(c1), prof.fetch(c2)
    for a, b in zip(h1[2:4], h2[2:4]):
        np.testing.assert_array_equal(b[:WIDTH], a)
    for k in h1.state:
        np.testing.assert_array_equal(h2.state[k][:WIDTH], h1.state[k])
    for k in h1.stats:
        np.testing.assert_array_equal(h2.stats[k][:WIDTH], h1.stats[k])


def test_traces_contract(ladder):
    """One trace the first time each program runs at each shape: run per
    query-argument set, run_batch per batch size, each stepper program
    per width; flat from then on, across park/restore cycles."""
    n, (_, tpg) = ladder
    eng = Engine(TA.bfs(), tpg, device="cpu", **TILES)
    assert eng.traces == 0
    eng.run(root=1)
    eng.run(root=2)
    assert eng.traces == 1
    eng.run_batch(root=np.arange(4))
    eng.run_batch(root=np.arange(4) + 4)
    assert eng.traces == 2
    eng.run_batch(root=np.arange(8))
    assert eng.traces == 3
    table = LaneTable(eng.make_stepper(2), 2, ("root",))
    table.admit({0: LaneMeta(payload="A", qkw={"root": 0})})
    table.admit({1: LaneMeta(payload="B", qkw={"root": n - 1})})
    table.step(table.alive_mask(CAP))
    after = eng.traces
    assert after >= 3 + 3   # init, admit, step
    for _ in range(3):
        table.step(table.alive_mask(CAP))
    ck = table.checkpoint(0)
    table.restore(0, ck)
    warm = eng.traces    # + fetch_lane, restore
    for _ in range(2):
        ck = table.checkpoint(1)
        table.step(table.alive_mask(CAP))
        table.restore(1, ck)
        table.admit({})
        table.step(table.alive_mask(CAP))
    eng.run(root=3)
    eng.run_batch(root=np.arange(8))
    assert eng.traces == warm
    assert eng.make_stepper(2) is table.stepper
    eng.make_stepper(3).init({"root": np.zeros(3, np.int32)})
    assert eng.traces == warm + 1


# ---------------------------------------------------------------------------
# LaneTable park/restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gravfm", "gravf"])
def test_lane_table_checkpoint_restore(ladder, mode):
    """checkpoint -> other work -> restore resumes the lane bit-identically
    to never having been parked, and equals the JAX lane table's result
    of the same schedule."""
    n, (jpg, tpg) = ladder
    eng = Engine(TA.bfs(), tpg, mode=mode, device="cpu", **TILES)
    jeng = JaxEngine(JA.bfs(), jpg, mode=mode, backend="ref")

    def schedule(engine, table_cls, meta_cls):
        tab = table_cls(engine.make_stepper(2), 2, ("root",))
        tab.admit({0: meta_cls(payload="A", qkw={"root": 0}),
                   1: meta_cls(payload="B", qkw={"root": n - 1})})
        for _ in range(3):
            tab.step(tab.alive_mask(CAP))
        ck = tab.checkpoint(0)          # park A at superstep 3
        assert ck.superstep == 3 and ck.nbytes > 0
        tab.admit({0: meta_cls(payload="C", qkw={"root": n // 2})})
        while tab.alive_mask(CAP).any():
            tab.step(tab.alive_mask(CAP))
        host = tab.fetch()
        out = {"C": engine.lane_result(host, 0),
               "B": engine.lane_result(host, 1)}
        tab.release(0), tab.release(1)
        tab.restore(1, ck)              # un-park A into the other slot
        while tab.alive_mask(CAP).any():
            tab.step(tab.alive_mask(CAP))
        out["A"] = engine.lane_result(tab.fetch(), 1)
        return out, ck.nbytes

    got, nbytes = schedule(eng, LaneTable, LaneMeta)
    want, jnbytes = schedule(jeng, JaxLaneTable, JaxLaneMeta)
    # the port's messages counter is int64, JAX's int32
    assert nbytes == jnbytes + 4
    for name, root in (("A", 0), ("B", n - 1), ("C", n // 2)):
        _assert_result(got[name], eng.run(root=root), "bfs")
        _assert_result(got[name], want[name], "bfs")


def test_park_restore_sssp_carry(weighted):
    """The argmin carry (SSSP's parent pointer) survives a park."""
    _, tpg = weighted
    eng = Engine(TA.sssp(), tpg, device="cpu", **TILES)
    tab = LaneTable(eng.make_stepper(2), 2, ("root",))
    tab.admit({0: LaneMeta(payload=0, qkw={"root": 0}),
               1: LaneMeta(payload=1, qkw={"root": 99})})
    tab.step(tab.alive_mask(CAP))
    tab.step(tab.alive_mask(CAP))
    ck = tab.checkpoint(0)
    while tab.alive_mask(CAP).any():
        tab.step(tab.alive_mask(CAP))
    tab.release(1)
    tab.restore(1, ck)
    while tab.alive_mask(CAP).any():
        tab.step(tab.alive_mask(CAP))
    _assert_result(eng.lane_result(tab.fetch(), 1), eng.run(root=0), "sssp")


# ---------------------------------------------------------------------------
# mode="gravf"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bfs", "wcc", "pagerank", "sssp",
                                  "degree", "bfs_got"])
def test_gravf_matches_jax(weighted, name):
    jpg, tpg = weighted

    def kern(lib):
        if name == "bfs_got":  # reaches the deliver's `got` combine
            return dataclasses.replace(lib.bfs(), got_from_identity=False)
        return lib.ALGORITHMS[name]()
    want = JaxEngine(kern(JA), jpg, mode="gravf", backend="ref").run()
    got = Engine(kern(TA), tpg, mode="gravf", device="cpu").run()
    _assert_result(got, want, name)
    assert got.comm["scheme"] == "gravf_unicast"
    assert got.comm["wire_words"] == got.comm["unicast_words"]


def test_gravf_batch_and_gravfm_agree(weighted):
    """gravf's run_batch equals its solo runs, and gravf computes the
    same BFS as gravfm (only the wire accounting differs)."""
    jpg, tpg = weighted
    roots = np.array([0, 7, 150])
    gravf = Engine(TA.bfs(), tpg, mode="gravf", device="cpu")
    gravfm = Engine(TA.bfs(), tpg, device="cpu", **TILES)
    want = JaxEngine(JA.bfs(), jpg, mode="gravf",
                     backend="ref").run_batch(root=roots)
    for r, res, jres in zip(roots, gravf.run_batch(root=roots), want):
        _assert_result(res, gravf.run(root=int(r)), "bfs")
        _assert_result(res, jres, "bfs")
        fm = gravfm.run(root=int(r))
        assert (res.supersteps, res.messages) == (fm.supersteps,
                                                  fm.messages)
        np.testing.assert_array_equal(res.state["parent"],
                                      fm.state["parent"])


# ---------------------------------------------------------------------------
# offload / upload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gravfm", "gravf"])
def test_offload_upload_round_trip(weighted, mode):
    _, tpg = weighted
    eng = Engine(TA.sssp(), tpg, mode=mode, device="cpu", **TILES)
    st = eng.make_stepper(2)
    before = eng.run(root=7)
    c, act, _ = st.init({"root": np.array([7, 99], np.int32)})
    c, act, _ = st.step(c, act)
    traces = eng.traces
    nbytes = eng.device_nbytes
    assert eng.device_resident
    assert eng.offload() == nbytes
    assert not eng.device_resident and eng.offload() == 0
    assert st._data is eng._data    # the stepper was rebound
    _assert_result(eng.run(root=7), before, "sssp")
    c, act, _ = st.step(c, act)     # a stepper over the host copies
    assert eng.upload() >= 0.0
    assert eng.device_resident and eng.upload() == 0.0
    assert st._data is eng._data
    while act.any():
        c, act, _ = st.step(c, act)
    _assert_result(eng.lane_result(st.fetch(c), 0), before, "sssp")
    _assert_result(eng.run(root=7), before, "sssp")
    assert eng.traces == traces + 0
    assert eng.device_nbytes == nbytes
