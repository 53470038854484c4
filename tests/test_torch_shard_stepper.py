"""The port's ``ShardLaneStepper`` and the shard engine's offload/upload
against the JAX package.

Both sides run on the very same ``PartitionedGraph`` (compiled by the JAX
package, carried across with ``repro_torch.convert``). The JAX
``ShardLaneStepper`` needs 4 devices: one module-scoped subprocess with 4
forced host devices drives it (``backend="ref"``) through a fixed verb
sequence (init, steps, an admit mid-flight, a park with ``fetch_lane``, a
restore, steps to the end) and saves the fetched carry after every verb
to an ``.npz``. The port replays the sequence on the CPU
(``LocalMesh(4, "cpu")``, its kernel path and its oracle) and its carry
must equal JAX's after every verb, transposed: the JAX carry is
``(P, W, ...)``, the port's ``(W, S, ...)``; the superstep counters and
per-query leaves, held once per shard by JAX, are ``(W,)`` in the port.
Exact, except PageRank's float32 scores and payloads (rtol = atol =
1e-5). The JAX ``messages`` counter is int32 and the port's int64: their
values must be equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import graph as G
from repro.core import partition as PT
from repro_torch import convert
from repro_torch.core import algorithms as TA
from repro_torch.core.engine_shardmap import (EXCHANGES, ShardEngine,
                                              build_shard_data)
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.stepper import LaneMeta, LaneTable

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TILES = dict(tile_e=64, tile_r=32)
WIDTH = 4
CAP = 10_000
ROOTS = [0, 7, 99, 150]
ROOTS2 = [0, 42, 99, 199]
FRESH = [False, True, False, True]
BACK = [True, False, False, False]
# (exchange, overlap, kernel)
CASES = ([(x, False, n) for x in EXCHANGES for n in ("bfs", "sssp")]
         + [(x, False, "pagerank") for x in ("allgather", "ring")]
         + [(x, True, "bfs") for x in EXCHANGES]
         + [(x, True, "sssp") for x in ("ring", "combined")])

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro.core import algorithms as ALG, graph as G, partition as PT
from repro.core.engine_shardmap import ShardEngine
from repro.launch.mesh import compat_make_mesh

mesh = compat_make_mesh((4,), ("graph",))
pg = PT.partition_graph(
    G.uniform(200, 3.0, seed=9, weighted=True).symmetrized(), 4,
    method="greedy", pad_multiple=16)

def kern(name):
    if name == "pagerank":
        return dataclasses.replace(ALG.pagerank(6), query_params=("root",))
    return ALG.ALGORITHMS[name]()

out = {{}}
def save(tag, c, act=None, steps=None):
    h = c
    leaves = {{"payload": h.payload, "active": h.active,
               "superstep": h.superstep}}
    leaves.update({{"state." + k: v for k, v in h.state.items()}})
    leaves.update({{"stats." + k: v for k, v in h.stats.items()}})
    for k, v in leaves.items():
        out[f"{{tag}}/{{k}}"] = np.asarray(v)
    if act is not None:
        out[f"{{tag}}/act"] = np.asarray(act)
        out[f"{{tag}}/steps"] = np.asarray(steps)

for i, (exch, ov, name) in enumerate({cases!r}):
    se = ShardEngine(kern(name), pg, mesh=mesh, exchange=exch,
                     backend="ref", tile_e=64, tile_r=32)
    st = se.make_stepper({width}, overlap=ov)
    roots = np.array({roots!r}, np.int32)
    c, act, steps = st.init({{"root": roots}})
    j = 0
    save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    for _ in range(3):
        c, act, steps = st.step(c, act)
        save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    c, act, steps = st.admit(c, {{"root": np.array({roots2!r}, np.int32)}},
                             np.array({fresh!r}))
    save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    c, act, steps = st.step(c, act)
    save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    lane = st.fetch_lane(c, 2)
    save(f"{{i}}.lane", lane)
    c, act, steps = st.step(c, act)
    save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    c, act, steps = st.restore(c, lane, np.array({back!r}))
    save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    for _ in range(40):
        if not act.any():
            break
        c, act, steps = st.step(c, act)
        save(f"{{i}}.{{j}}", st.fetch(c), act, steps); j += 1
    out[f"{{i}}/meta"] = np.array(json.dumps([j, st.last_wire_words]))

# the park/restore cycle of tests/test_preempt.py, per exchange: the
# trace count once warm
traces = {{}}
for exch in {exchanges!r}:
    se = ShardEngine(ALG.bfs(), pg, mesh=mesh, exchange=exch,
                     backend="ref", tile_e=64, tile_r=32)
    st = se.make_stepper(3)
    c, act, steps = st.init({{"root": np.array([0, 100, 0], np.int32)}})
    occ = np.array([True, True, False])
    for _ in range(2):
        c, act, steps = st.step(c, occ & act)
    ck = st.fetch_lane(c, 0)
    occ[0] = False
    while (occ & act).any():
        c, act, steps = st.step(c, occ & act)
    c, act, steps = st.restore(c, ck, np.array([True, False, False]))
    traces[exch] = se.traces
out["traces"] = np.array(json.dumps(traces))
np.savez({out!r}, **out)
print("JAX-STEPPER-OK")
"""


@pytest.fixture(scope="module")
def graph():
    g = G.uniform(200, 3.0, seed=9, weighted=True).symmetrized()
    pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
    tpg = convert.partitioned_graph_from_numpy(
        {f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)})
    return tpg, build_shard_data(tpg, **TILES)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_stepper") / "results.npz"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _SCRIPT.format(
        src=os.path.abspath(src), cases=CASES, width=WIDTH, roots=ROOTS,
        roots2=ROOTS2, fresh=FRESH, back=BACK, exchanges=EXCHANGES,
        out=str(path))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-STEPPER-OK" in proc.stdout
    print(f"JAX ShardLaneStepper subprocess: "
          f"{time.perf_counter() - t0:.1f} s")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _kernel(name):
    if name == "pagerank":
        # PageRank declares no query parameter, and a lane stepper needs
        # one per lane: a root that its init_state ignores.
        return dataclasses.replace(TA.pagerank(6), query_params=("root",))
    return TA.ALGORITHMS[name]()


def _engine(graph, name, exchange, backend="kernel"):
    tpg, data = graph
    return ShardEngine(_kernel(name), tpg, mesh=LocalMesh(4, "cpu"),
                       exchange=exchange, backend=backend, shard_data=data,
                       **TILES)


def _port_view(jax_leaf: np.ndarray, port_leaf: np.ndarray,
               lane: bool) -> np.ndarray:
    """A JAX carry leaf in the port's layout: (P, W, ...) as (W, P, ...)
    (a lane slice (P, ...) as it is), without the shard axis where the
    port holds a per-query value once (every shard's JAX copy must
    agree)."""
    t = jax_leaf if lane else np.swapaxes(jax_leaf, 0, 1)
    shard_axis = 0 if lane else 1
    if port_leaf.ndim == t.ndim - 1:
        first = np.take(t, 0, axis=shard_axis)
        assert (t == np.expand_dims(first, shard_axis)).all()
        return first
    return t


def _assert_carry(port, jax, tag, name, label):
    """A host port carry against the JAX one saved under ``tag``."""
    leaves = {"payload": port.payload, "active": port.active,
              "superstep": port.superstep}
    leaves.update({"state." + k: v for k, v in port.state.items()})
    leaves.update({"stats." + k: v for k, v in port.stats.items()})
    saved = {k[len(tag) + 1:] for k in jax if k.startswith(tag + "/")}
    assert set(leaves) == saved - {"act", "steps"}, label
    for what, a in leaves.items():
        a = np.asarray(a)
        want = _port_view(jax[f"{tag}/{what}"], a, tag.endswith(".lane"))
        msg = f"{label} {what}"
        assert a.shape == want.shape, msg
        if what == "stats.messages":
            np.testing.assert_array_equal(a, want.astype(np.int64), msg)
            continue
        assert a.dtype == want.dtype, msg
        if name == "pagerank" and what in ("state.score", "payload"):
            np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-5,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(a, want, msg)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join([x + ("-ov" if ov else ""), n])
                              for x, ov, n in CASES])
def test_shard_stepper_matches_jax(graph, jax_results, case, backend):
    exchange, overlap, name = CASES[case]
    st = _engine(graph, name, exchange, backend).make_stepper(
        WIDTH, overlap=overlap)
    n_verbs, wire_words = json.loads(str(jax_results[f"{case}/meta"]))
    j = 0

    def check(out, label):
        nonlocal j
        c, act, steps = out
        tag = f"{case}.{j}"
        np.testing.assert_array_equal(act, jax_results[tag + "/act"], label)
        np.testing.assert_array_equal(steps, jax_results[tag + "/steps"],
                                      label)
        assert act.dtype == np.bool_ and steps.dtype == np.int32
        _assert_carry(st.fetch(c), jax_results, tag, name, label)
        j += 1
        return c, act

    c, act = check(st.init({"root": np.array(ROOTS, np.int32)}), "init")
    for i in range(3):
        c, act = check(st.step(c, act), f"step {i}")
    c, act = check(st.admit(c, {"root": np.array(ROOTS2, np.int32)},
                            np.array(FRESH)), "admit")
    c, act = check(st.step(c, act), "step after admit")
    lane = st.fetch_lane(c, 2)
    _assert_carry(lane, jax_results, f"{case}.lane", name, "fetch_lane")
    c, act = check(st.step(c, act), "step after park")
    c, act = check(st.restore(c, lane, np.array(BACK)), "restore")
    for i in range(40):
        if not act.any():
            break
        c, act = check(st.step(c, act), f"tail {i}")
    assert j == n_verbs
    # the packed probe's wire words: every shard's and lane's, as JAX's
    assert st.last_wire_words == wire_words


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_lanes_equal_solo_runs(graph, exchange, name):
    """Lanes spliced in at different supersteps each retire with the
    result of a solo ``run`` of their query, in both schedules."""
    eng = _engine(graph, name, exchange)
    for overlap in (False, True):
        table = LaneTable(eng.make_stepper(3, overlap=overlap), 3,
                          ("root",))
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
                r = queue.pop(0)
                table.admit({table.free_slots()[0]:
                             LaneMeta(payload=r, qkw={"root": r})})
        assert sorted(done) == sorted(pending)
        for r, res in done.items():
            solo = eng.run(root=r)
            assert (res.supersteps, res.messages, res.comm) == (
                solo.supersteps, solo.messages, solo.comm)
            for view in ("state", "raw_state"):
                for k, v in getattr(solo, view).items():
                    np.testing.assert_array_equal(getattr(res, view)[k], v)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_park_restore_cycle(graph, jax_results, exchange):
    """The park/restore cycle of tests/test_preempt.py: a lane parked at
    superstep 2 (``fetch_lane`` returns only its per-shard slices) and
    restored after the other lane finished resumes to its solo result; a
    second park/restore cycle traces nothing, and the warm trace count is
    the JAX stepper's."""
    eng = _engine(graph, "bfs", exchange)
    st = eng.make_stepper(3)
    c, act, steps = st.init({"root": np.array([0, 100, 0], np.int32)})
    occ = np.array([True, True, False])
    for _ in range(2):
        c, act, steps = st.step(c, occ & act)
    ck = st.fetch_lane(c, 0)
    for leaf in (ck.payload, ck.active, *ck.state.values(),
                 *ck.stats.values()):
        assert leaf.shape[:1] == (4,) or leaf.ndim == 0
    occ[0] = False
    while (occ & act).any():
        c, act, steps = st.step(c, occ & act)
    c, act, steps = st.restore(c, ck, np.array([True, False, False]))
    occ[0] = True
    steady = eng.traces
    assert steady == json.loads(str(jax_results["traces"]))[exchange]
    while (occ & act).any():
        c, act, steps = st.step(c, occ & act)
    c, act, steps = st.restore(c, st.fetch_lane(c, 2),
                               np.zeros(3, bool))
    assert eng.traces == steady
    host = st.fetch(c)
    for lane, root in ((0, 0), (1, 100)):
        res, solo = eng.lane_result(host, lane), eng.run(root=root)
        assert (res.supersteps, res.messages) == (solo.supersteps,
                                                  solo.messages)
        np.testing.assert_array_equal(res.state["parent"],
                                      solo.state["parent"])


@pytest.mark.parametrize("exchange,overlap", [("combined", False),
                                              ("ring", True)])
def test_profiled_step_equals_fused(graph, exchange, overlap):
    """The profiled exchange/apply/probe step (with the synchronous
    exchange timed beside an overlapped one) gives the fused step's
    carry."""
    eng = _engine(graph, "sssp", exchange)
    fused, prof = eng.make_stepper(WIDTH, overlap), eng.make_stepper(
        WIDTH + 1, overlap)
    prof.profile = True
    roots = np.array(ROOTS, np.int32)
    c1, a1, _ = fused.init({"root": roots})
    c2, a2, _ = prof.init({"root": np.append(roots, 3)})
    want = {"exchange", "apply", "probe"} | (
        {"exchange_serial"} if overlap else set())
    for _ in range(6):
        alive = np.append(a1, a2[-1])
        c1, a1, s1 = fused.step(c1, a1)
        c2, a2, s2 = prof.step(c2, alive)
        assert fused.last_phases is None
        assert set(prof.last_phases) == want
        np.testing.assert_array_equal(a2[:WIDTH], a1)
        np.testing.assert_array_equal(s2[:WIDTH], s1)
    h1, h2 = fused.fetch(c1), prof.fetch(c2)
    for k in h1.state:
        np.testing.assert_array_equal(h2.state[k][:WIDTH], h1.state[k])
    for k in h1.stats:
        np.testing.assert_array_equal(h2.stats[k][:WIDTH], h1.stats[k])


@pytest.mark.parametrize("exchange", ["frontier", "combined"])
def test_offload_upload_round_trip(graph, exchange):
    """Offload demotes every device tensor of the engine (the stacked
    kernel layouts included) to host copies and rebinds its steppers; a
    run and a stepper step while offloaded answer as before; upload
    brings them back; nothing is traced anew."""
    eng = _engine(graph, "sssp", exchange)
    st = eng.make_stepper(2)
    before = eng.run(root=7)
    c, act, _ = st.init({"root": np.array([7, 99], np.int32)})
    c, act, _ = st.step(c, act)
    traces, nbytes = eng.traces, eng.device_nbytes
    assert eng.device_resident and nbytes > 0
    if exchange == "combined":
        assert eng._data.comb is not None
    assert eng.offload() == nbytes
    assert not eng.device_resident and eng.offload() == 0
    assert st._data is eng._data    # the stepper was rebound
    again = eng.run(root=7)
    assert (again.supersteps, again.messages, again.comm) == (
        before.supersteps, before.messages, before.comm)
    c, act, _ = st.step(c, act)     # a stepper over the host copies
    assert eng.upload() >= 0.0
    assert eng.device_resident and eng.upload() == 0.0
    assert st._data is eng._data
    while act.any():
        c, act, _ = st.step(c, act)
    res = eng.lane_result(st.fetch(c), 0)
    assert (res.supersteps, res.messages, res.comm) == (
        before.supersteps, before.messages, before.comm)
    for k in before.state:
        np.testing.assert_array_equal(res.state[k], before.state[k])
    assert eng.traces == traces
    assert eng.device_nbytes == nbytes
