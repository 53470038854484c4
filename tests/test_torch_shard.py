"""The port's shard engine against the JAX package's engines.

Both sides run on the very same ``PartitionedGraph``: the JAX package
compiles it (``partition_graph(..., pad_multiple=16)``) and
``repro_torch.convert`` carries its fields across. The port runs all four
shards on the CPU (``LocalMesh(4, "cpu")``; ``backend="kernel"`` takes
K2's plain version there) at ``tile_e=64, tile_r=32``.

  * ``build_shard_data`` must give the JAX arrays field for field.
  * Against the JAX global-array ``Engine``: states, supersteps and
    messages.
  * Against the JAX ``ShardEngine`` itself, which needs 4 devices: one
    subprocess with 4 forced host devices runs it and saves its results
    to an ``.npz``; states, ``raw_state``, supersteps, messages and the
    whole comm dict must match.

Integer data and min/max are compared exactly; PageRank ``score``
(float32 add, summed in another order) at rtol = 1e-5, atol = 1e-8.
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

from repro.core import algorithms as JA
from repro.core import graph as G
from repro.core import partition as PT
from repro.core.engine import Engine as JaxEngine
from repro.core.engine_shardmap import build_shard_data as jax_build_shard_data
from repro_torch import convert
from repro_torch.core import algorithms as TA
from repro_torch.core.engine_shardmap import ShardEngine, build_shard_data
from repro_torch.core.mesh import LocalMesh

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TILES = dict(tile_e=64, tile_r=32)
EXCHANGES = ["allgather", "ring", "frontier", "unicast", "combined"]
GRAPHS = {
    "uniform": lambda: G.uniform(300, 5.0, seed=7).symmetrized(),
    "rmat": lambda: G.rmat(8, 6, seed=3).symmetrized(),
    "weighted": lambda: G.uniform(200, 4.0, seed=9,
                                  weighted=True).symmetrized(),
}
ROOTS = [1, 2, 3, 60]


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX pg, port pg, port shard data)."""
    out = {}
    for name, make in GRAPHS.items():
        pg = PT.partition_graph(make(), 4, method="greedy", pad_multiple=16)
        fields = {f.name: getattr(pg, f.name)
                  for f in dataclasses.fields(pg)}
        tpg = convert.partitioned_graph_from_numpy(fields)
        out[name] = (pg, tpg, build_shard_data(tpg, **TILES))
    return out


@pytest.fixture(scope="module")
def mesh():
    return LocalMesh(4, "cpu")


def _kernels(name, lib):
    if name == "bfs_got":  # reaches the engines' `got` combine
        return dataclasses.replace(lib.bfs(), got_from_identity=False)
    return lib.ALGORITHMS[name]()


def _engine(graphs, mesh, gname, name, exchange, backend):
    _, tpg, data = graphs[gname]
    return ShardEngine(_kernels(name, TA), tpg, mesh=mesh, exchange=exchange,
                       backend=backend, shard_data=data, **TILES)


def _assert_state(got, want, name, view="state"):
    assert set(got) == set(want), view
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (view, k)
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{view}.{k}")


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_build_shard_data_matches_jax(graphs, gname):
    jpg, tpg, (data, meta) = graphs[gname]
    jdata, jmeta = jax_build_shard_data(jpg, **TILES)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    for f in jdata._fields:
        a, b = getattr(data, f), getattr(jdata, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # tile_start: each shard's own window tile ranges, pad tiles excluded
    for ts, wid, nt in ((data.tile_start, data.wid, meta.n_tiles),
                        (data.comb_tile_start, data.comb_wid,
                         meta.comb_tiles)):
        for p in range(meta.P):
            own = ts[p, -1]
            assert ts[p, 0] == 0 and own <= nt
            np.testing.assert_array_equal(
                np.diff(ts[p]), np.bincount(wid[p, :own],
                                            minlength=ts.shape[1] - 1))


@pytest.fixture(scope="module")
def jax_engine(graphs):
    """The JAX global-array Engine's result, once per (graph, kernel)."""
    cache = {}

    def result(gname, name):
        if (gname, name) not in cache:
            cache[gname, name] = JaxEngine(_kernels(name, JA),
                                           graphs[gname][0], backend="ref",
                                           **TILES).run()
        return cache[gname, name]
    return result


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["bfs", "wcc", "pagerank", "sssp",
                                  "degree", "bfs_got"])
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_shard_engine_matches_jax_engine(graphs, mesh, jax_engine, gname,
                                         name, exchange, backend):
    want = jax_engine(gname, name)
    got = _engine(graphs, mesh, gname, name, exchange, backend).run()
    assert got.supersteps == want.supersteps
    assert got.messages == want.messages
    # a per-query state leaf (PageRank's num_vertices) is held once per
    # shard by the shard engines, (P,), and once by Engine, ()
    _assert_state(got.state, {k: np.broadcast_to(v, got.state[k].shape)
                              for k, v in want.state.items()}, name)


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_run_batch_equals_solo_runs(graphs, mesh, exchange, name):
    eng = _engine(graphs, mesh, "weighted", name, exchange, "kernel")
    roots = np.array([0, 5, 17, 42, 99, 123, 150, 199])
    batch = eng.run_batch(root=roots)
    assert len(batch) == len(roots)
    words = 0.0
    for r, res in zip(roots, batch):
        solo = eng.run(root=int(r))
        assert res.supersteps == solo.supersteps
        assert res.messages == solo.messages
        _assert_state(res.state, solo.state, name)
        _assert_state(res.raw_state, solo.raw_state, name, "raw_state")
        words += solo.comm["wire_words"]
    # the batch reports the words of its shared wire, on every entry
    assert {res.comm["wire_words"] for res in batch} == {words}


def test_unported_options_raise(graphs, mesh):
    """What the shard engine still refuses, as the JAX one does: an
    overlapped unicast/combined schedule with an ``add`` combiner (its
    windowed receiver fold is exact for min/max only), an unknown
    exchange, a mesh or tiles that do not fit the graph, a misspelled
    query parameter, a stepper of no lanes."""
    _, tpg, data = graphs["uniform"]
    for exchange in ("unicast", "combined"):
        eng = _engine(graphs, mesh, "uniform", "pagerank", exchange, "kernel")
        for call in (lambda: eng.run(overlap=True),
                     lambda: eng.make_stepper(4, overlap=True)):
            with pytest.raises(ValueError, match="min/max"):
                call()
        assert eng.run().supersteps > 0
    with pytest.raises(ValueError, match="exchange"):
        ShardEngine(TA.bfs(), tpg, mesh=mesh, exchange="hierarchical",
                    shard_data=data, **TILES)
    eng = _engine(graphs, mesh, "uniform", "bfs", "combined", "kernel")
    with pytest.raises(ValueError, match="width"):
        eng.make_stepper(0)
    with pytest.raises(ValueError):
        ShardEngine(TA.bfs(), tpg, mesh=LocalMesh(2, "cpu"), shard_data=data,
                    **TILES)
    with pytest.raises(ValueError):
        ShardEngine(TA.bfs(), tpg, mesh=mesh, shard_data=data, tile_e=128,
                    tile_r=32)
    with pytest.raises(ValueError):
        eng.run(roots=3)  # misspelled query parameter
    # only the fields the exchange reads go on the device
    ref = _engine(graphs, mesh, "uniform", "bfs", "combined", "ref")
    assert 0 < ref.device_nbytes < eng.device_nbytes
    assert eng._data.src_slot is None and eng._data.pair_w is None


# ---------------------------------------------------------------------------
# Against the JAX ShardEngine (4 forced host devices, in a subprocess)
# ---------------------------------------------------------------------------

# (exchange, kernel, JAX backend, graph, entry)
JAX_SHARD_CASES = (
    [(x, n, "ref", "weighted", "run") for x in EXCHANGES
     for n in ("bfs", "sssp", "pagerank")]
    + [(x, "wcc", "pallas", "rmat", "run") for x in ("allgather", "combined")]
    + [("combined", "bfs", "ref", "rmat", "run_batch")])

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro.core import algorithms as ALG, graph as G, partition as PT
from repro.core.engine_shardmap import ShardEngine
from repro.launch.mesh import compat_make_mesh

mesh = compat_make_mesh((4,), ("graph",))
graphs = {{
    "rmat": G.rmat(8, 6, seed=3).symmetrized(),
    "weighted": G.uniform(200, 4.0, seed=9, weighted=True).symmetrized(),
}}
pgs = {{k: PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
        for k, g in graphs.items()}}
out = {{}}
for i, (exch, name, backend, gname, entry) in enumerate({cases!r}):
    eng = ShardEngine(ALG.ALGORITHMS[name](), pgs[gname], mesh=mesh,
                      exchange=exch, backend=backend, tile_e=64, tile_r=32)
    res = (eng.run() if entry == "run"
           else eng.run_batch(root=np.array({roots!r})))
    for q, r in enumerate(res if isinstance(res, list) else [res]):
        for view in ("state", "raw_state"):
            for k, v in getattr(r, view).items():
                out[f"{{i}}.{{q}}/{{view}}/{{k}}"] = np.asarray(v)
        out[f"{{i}}.{{q}}/meta"] = np.array(json.dumps(
            [r.supersteps, r.messages, r.comm]))
np.savez({out!r}, **out)
print("JAX-SHARD-OK")
"""


@pytest.fixture(scope="module")
def jax_shard_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_shard") / "results.npz"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = _SCRIPT.format(src=os.path.abspath(src), cases=JAX_SHARD_CASES,
                            roots=ROOTS, out=str(path))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-SHARD-OK" in proc.stdout
    print(f"JAX ShardEngine subprocess: {time.perf_counter() - t0:.1f} s")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("case", range(len(JAX_SHARD_CASES)),
                         ids=["-".join(c) for c in JAX_SHARD_CASES])
def test_shard_engine_matches_jax_shard_engine(graphs, mesh,
                                               jax_shard_results, case):
    exchange, name, jax_backend, gname, entry = JAX_SHARD_CASES[case]
    backend = {"ref": "ref", "pallas": "kernel"}[jax_backend]
    eng = _engine(graphs, mesh, gname, name, exchange, backend)
    got = (eng.run() if entry == "run"
           else eng.run_batch(root=np.array(ROOTS)))
    got = got if isinstance(got, list) else [got]
    assert len(got) == (len(ROOTS) if entry == "run_batch" else 1)
    for q, res in enumerate(got):
        prefix = f"{case}.{q}/"
        supersteps, messages, comm = json.loads(
            str(jax_shard_results[prefix + "meta"]))
        assert (res.supersteps, res.messages, res.comm) == (
            supersteps, messages, comm)
        for view in ("state", "raw_state"):
            want = {k.split("/")[2]: v for k, v in jax_shard_results.items()
                    if k.startswith(f"{prefix}{view}/")}
            _assert_state(getattr(res, view), want, name, view)
