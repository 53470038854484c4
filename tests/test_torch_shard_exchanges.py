"""The port's ring and frontier exchanges and the overlapped schedules of
all five exchanges against the JAX ``ShardEngine``.

Both sides run on the very same ``PartitionedGraph`` (compiled by the JAX
package, carried across with ``repro_torch.convert``). The JAX engine
needs 4 devices: one module-scoped subprocess with 4 forced host devices
runs it (``backend="ref"``) and saves its results to an ``.npz``; the
port runs all four shards on the CPU (``LocalMesh(4, "cpu")``) with its
kernel path (K2's plain version there) and its oracle, at ``tile_e=64,
tile_r=32``. States, ``raw_state``, supersteps, messages and the whole
comm dict must match: exactly, except PageRank's float32 ``score``,
compared at rtol = atol = 1e-5.

The frontier cases also run on a graph with 1,024 vertices a shard, whose
capacity buckets (64, 256, 1024 slots) make BFS and SSSP switch buckets
from superstep to superstep, so the words of each superstep's bucket are
checked against JAX's ``lax.switch``.
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

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TILES = dict(tile_e=64, tile_r=32)
ROOTS = [0, 5, 17, 99]
KERNELS = ("bfs", "bfs_got", "sssp", "wcc", "pagerank")


def _allowed(exchange, name, overlap):
    """Overlapped unicast/combined refuse an add combiner (PageRank)."""
    return not (overlap and exchange in ("unicast", "combined")
                and name == "pagerank")


# (exchange, overlap, kernel, graph, entry)
CASES = (
    [(x, False, n, "weighted", "run") for x in ("ring", "frontier")
     for n in KERNELS]
    + [(x, True, n, "weighted", "run") for x in EXCHANGES for n in KERNELS
       if _allowed(x, n, True)]
    + [("frontier", ov, n, "wide", "run") for ov in (False, True)
       for n in ("bfs", "sssp")]
    + [(x, True, n, "weighted", "run_batch")
       for x, n in (("ring", "sssp"), ("frontier", "bfs"),
                    ("combined", "sssp"), ("unicast", "bfs_got"),
                    ("allgather", "bfs"))]
    + [("frontier", False, "bfs", "wide", "run_batch")])

# per exchange: the trace counts after run(), run(overlap=True), then
# three more runs toggling the schedule
TRACE_SEQUENCE = (False, True, False, True, False)

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
graphs = {{
    "weighted": G.uniform(200, 4.0, seed=9, weighted=True).symmetrized(),
    "wide": G.uniform(4096, 2.5, seed=4, weighted=True).symmetrized(),
}}
pgs = {{k: PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
        for k, g in graphs.items()}}

def kern(name):
    if name == "bfs_got":
        return dataclasses.replace(ALG.bfs(), got_from_identity=False)
    return ALG.ALGORITHMS[name]()

out = {{}}
for i, (exch, ov, name, gname, entry) in enumerate({cases!r}):
    eng = ShardEngine(kern(name), pgs[gname], mesh=mesh, exchange=exch,
                      backend="ref", tile_e=64, tile_r=32)
    res = (eng.run(overlap=ov) if entry == "run"
           else eng.run_batch(overlap=ov, root=np.array({roots!r})))
    for q, r in enumerate(res if isinstance(res, list) else [res]):
        for view in ("state", "raw_state"):
            for k, v in getattr(r, view).items():
                out[f"{{i}}.{{q}}/{{view}}/{{k}}"] = np.asarray(v)
        out[f"{{i}}.{{q}}/meta"] = np.array(json.dumps(
            [r.supersteps, r.messages, r.comm]))
traces = {{}}
for exch in {exchanges!r}:
    eng = ShardEngine(ALG.bfs(), pgs["weighted"], mesh=mesh, exchange=exch,
                      backend="ref", tile_e=64, tile_r=32)
    counts = []
    for ov in {sequence!r}:
        eng.run(overlap=ov, root=3)
        counts.append(eng.traces)
    traces[exch] = counts
out["traces"] = np.array(json.dumps(traces))
np.savez({out!r}, **out)
print("JAX-EXCHANGES-OK")
"""


@pytest.fixture(scope="module")
def graphs():
    """name -> (port pg, port shard data), from the JAX partition."""
    made = {"weighted": G.uniform(200, 4.0, seed=9,
                                  weighted=True).symmetrized(),
            "wide": G.uniform(4096, 2.5, seed=4, weighted=True).symmetrized()}
    out = {}
    for name, g in made.items():
        pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
        tpg = convert.partitioned_graph_from_numpy(
            {f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)})
        out[name] = (tpg, build_shard_data(tpg, **TILES))
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_exchanges") / "results.npz"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _SCRIPT.format(src=os.path.abspath(src), cases=CASES,
                            roots=ROOTS, exchanges=EXCHANGES,
                            sequence=TRACE_SEQUENCE, out=str(path))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-EXCHANGES-OK" in proc.stdout
    print(f"JAX ShardEngine subprocess: {time.perf_counter() - t0:.1f} s")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _kernel(name):
    if name == "bfs_got":  # reaches the engines' `got` combine
        return dataclasses.replace(TA.bfs(), got_from_identity=False)
    return TA.ALGORITHMS[name]()


def _engine(graphs, gname, name, exchange, backend):
    tpg, data = graphs[gname]
    return ShardEngine(_kernel(name), tpg, mesh=LocalMesh(4, "cpu"),
                       exchange=exchange, backend=backend, shard_data=data,
                       **TILES)


def _assert_state(got, want, name, view):
    assert set(got) == set(want), view
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (view, k)
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{view}.{k}")


def _case_id(case):
    exchange, overlap, name, gname, entry = case
    return "-".join([exchange + ("-ov" if overlap else ""), name, gname,
                     entry])


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_exchange_matches_jax_shard_engine(graphs, jax_results, case,
                                           backend):
    exchange, overlap, name, gname, entry = CASES[case]
    eng = _engine(graphs, gname, name, exchange, backend)
    got = (eng.run(overlap=overlap) if entry == "run"
           else eng.run_batch(overlap=overlap, root=np.array(ROOTS)))
    got = got if isinstance(got, list) else [got]
    assert len(got) == (len(ROOTS) if entry == "run_batch" else 1)
    for q, res in enumerate(got):
        prefix = f"{case}.{q}/"
        supersteps, messages, comm = json.loads(
            str(jax_results[prefix + "meta"]))
        assert (res.supersteps, res.messages, res.comm) == (
            supersteps, messages, comm)
        for view in ("state", "raw_state"):
            want = {k.split("/")[2]: v for k, v in jax_results.items()
                    if k.startswith(f"{prefix}{view}/")}
            _assert_state(getattr(res, view), want, name, view)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_overlap_toggle_adds_no_trace(graphs, jax_results, exchange):
    """Both schedules share one engine's data: after one run of each,
    toggling ``overlap`` per run counts no new trace, and the counts
    follow the JAX engine's."""
    eng = _engine(graphs, "weighted", "bfs", exchange, "kernel")
    counts, results = [], {}
    for ov in TRACE_SEQUENCE:
        res = eng.run(overlap=ov, root=3)
        counts.append(eng.traces)
        results.setdefault(ov, res)
        _assert_state(res.state, results[ov].state, "bfs", "state")
        assert (res.supersteps, res.messages, res.comm) == (
            results[False].supersteps, results[False].messages,
            results[False].comm)
    assert counts == json.loads(str(jax_results["traces"]))[exchange]
    assert counts[1:] == [counts[1]] * (len(counts) - 1)


@pytest.mark.parametrize("exchange", ["ring", "frontier"])
def test_wire_words_per_exchange(graphs, exchange):
    """The ring moves allgather's dense words in P-1 hops; the frontier
    moves two words a slot of the chosen bucket, so its words follow the
    frontier: on the wide graph BFS's first superstep (one active vertex)
    takes the smallest bucket."""
    eng = _engine(graphs, "wide", "bfs", exchange, "ref")
    m = eng.meta
    one = eng.run(max_supersteps=1, root=3)
    if exchange == "ring":
        assert one.comm["wire_words"] == m.P * m.v_max * (m.P - 1)
    else:
        assert m.frontier_capacities[0] < m.v_max
        assert one.comm["wire_words"] == (
            m.P * m.frontier_capacities[0] * 2 * (m.P - 1))
