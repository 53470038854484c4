"""The port's GraVF-M engine against the JAX engine on the same graph.

Both engines run on the very same ``PartitionedGraph``: the JAX package
compiles it (``partition_graph(..., pad_multiple=16)``) and
``repro_torch.convert`` carries its fields across. The port runs on the
CPU (``backend="kernel"`` takes the kernel's plain version there), the JAX
engine with the Pallas kernel in interpret mode and with its oracle, at
``tile_e=64, tile_r=32`` as in tests/test_system.py. States, supersteps,
messages and comm must be identical; PageRank ``score`` is compared at
rtol = 1e-5, atol = 1e-8 (float32 sums taken in another order, over 30
contracting supersteps).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as JA
from repro.core import graph as G
from repro.core import partition as PT
from repro.core.engine import Engine as JaxEngine
from repro_torch import convert
from repro_torch.core import algorithms as TA
from repro_torch.core.engine import Engine

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TILES = dict(tile_e=64, tile_r=32)


@pytest.fixture(scope="module")
def graphs():
    """The graphs of tests/test_system.py, compiled once by the JAX
    package and carried across."""
    out = {}
    for name, g in {
        "uniform": G.uniform(300, 5.0, seed=7).symmetrized(),
        "rmat": G.rmat(8, 6, seed=3).symmetrized(),
        "weighted": G.uniform(200, 4.0, seed=9, weighted=True).symmetrized(),
    }.items():
        pg = PT.partition_graph(g, 4, method="greedy", pad_multiple=16)
        fields = {f.name: getattr(pg, f.name)
                  for f in dataclasses.fields(pg)}
        out[name] = (pg, convert.partitioned_graph_from_numpy(fields))
    return out


def _kernels(name, lib):
    if name == "bfs_got":  # reaches the engine's `got` combine
        return dataclasses.replace(lib.bfs(), got_from_identity=False)
    return lib.ALGORITHMS[name]()


def _assert_same(got, want, name):
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


@pytest.mark.parametrize("gname", ["uniform", "rmat", "weighted"])
@pytest.mark.parametrize("name", ["bfs", "wcc", "pagerank", "sssp",
                                  "degree", "bfs_got"])
@pytest.mark.parametrize("backend,jax_backend", [("kernel", "pallas"),
                                                 ("ref", "ref")])
def test_engine_matches_jax(graphs, gname, name, backend, jax_backend):
    jpg, tpg = graphs[gname]
    want = JaxEngine(_kernels(name, JA), jpg, backend=jax_backend,
                     **TILES).run()
    got = Engine(_kernels(name, TA), tpg, backend=backend, device="cpu",
                 **TILES).run()
    _assert_same(got, want, name)


@pytest.mark.parametrize("name", ["bfs", "sssp"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_run_batch_equals_solo_runs(graphs, name, backend):
    _, tpg = graphs["weighted"]
    eng = Engine(TA.ALGORITHMS[name](), tpg, backend=backend, device="cpu",
                 **TILES)
    roots = np.array([0, 5, 17, 42, 99, 123, 150, 199])
    batch = eng.run_batch(root=roots)
    assert len(batch) == len(roots)
    for r, res in zip(roots, batch):
        solo = eng.run(root=int(r))
        assert res.supersteps == solo.supersteps
        assert res.messages == solo.messages
        assert res.comm == solo.comm
        for k in solo.state:
            np.testing.assert_array_equal(res.state[k], solo.state[k])
            np.testing.assert_array_equal(res.raw_state[k],
                                          solo.raw_state[k])


def test_run_batch_matches_jax(graphs):
    jpg, tpg = graphs["rmat"]
    roots = np.array([1, 2, 3, 60])
    want = JaxEngine(JA.bfs(), jpg, backend="ref", **TILES).run_batch(
        root=roots)
    got = Engine(TA.bfs(), tpg, device="cpu", **TILES).run_batch(root=roots)
    for g, w in zip(got, want):
        _assert_same(g, w, "bfs")


def test_query_kwargs_and_modes(graphs):
    _, tpg = graphs["uniform"]
    eng = Engine(TA.bfs(), tpg, device="cpu", **TILES)
    with pytest.raises(ValueError):
        eng.run(roots=3)  # misspelled query parameter
    with pytest.raises(ValueError):
        eng.run_batch()
    with pytest.raises(ValueError):
        eng.run_batch(root=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError):
        Engine(TA.wcc(), tpg, device="cpu").run_batch(root=np.arange(2))
    with pytest.raises(ValueError, match="mode"):
        Engine(TA.bfs(), tpg, mode="graph", device="cpu")
    assert Engine(TA.bfs(), tpg, mode="gravf", device="cpu").mode == "gravf"
    assert eng.device_nbytes > 0


def test_state_to_numpy_round_trip(graphs):
    jpg, tpg = graphs["uniform"]
    eng = Engine(TA.pagerank(3), tpg, device="cpu", **TILES)
    res = eng.run()
    assert res.raw_state["score"].shape == (jpg.num_parts, jpg.v_max)
    assert res.raw_state["num_vertices"].shape == ()
    carry = eng._prog.init_carry(eng._data, eng.params, {}, 2)
    host = convert.state_to_numpy(carry.state)
    assert host["score"].shape == (2, jpg.num_parts, jpg.v_max)
    assert all(isinstance(v, np.ndarray) for v in host.values())
