"""The frozen generators equal the port's at small sizes."""
from __future__ import annotations

import numpy as np
import pytest

from bench.gen import graphs
from repro_torch.core import graph as G


def same(frozen, port):
    assert frozen.num_vertices == port.num_vertices
    np.testing.assert_array_equal(frozen.src, port.src)
    np.testing.assert_array_equal(frozen.dst, port.dst)
    if port.weights is None:
        assert frozen.weights is None
    else:
        np.testing.assert_array_equal(frozen.weights, port.weights)


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 17])
@pytest.mark.parametrize("weighted", [False, True])
def test_rmat_equals_port(seed, weighted):
    same(graphs.rmat(9, 16, seed=seed, weighted=weighted),
         G.rmat(9, 16, seed=seed, weighted=weighted))
    same(graphs.rmat(8, 8, a=0.45, b=0.15, c=0.15, seed=seed,
                     weighted=weighted).symmetrized(),
         G.rmat(8, 8, a=0.45, b=0.15, c=0.15, seed=seed,
                weighted=weighted).symmetrized())


@pytest.mark.parametrize("seed", [0, 3, 2**32 + 1])
def test_road_equals_port(seed):
    same(graphs.road(23, seed=seed), G.road(23, seed=seed))
    weighted = graphs.road(23, seed=seed, weighted=True)
    np.testing.assert_array_equal(weighted.src, G.road(23, seed=seed).src)
    assert weighted.weights.dtype == np.float32
    assert weighted.weights.min() >= 0.5 and weighted.weights.max() < 2.0


@pytest.mark.parametrize("seed", [0, 2**32 + 1])
def test_road_streets_are_two_way(seed):
    g = graphs.make({"generator": "road", "symmetrize": True,
                     "params": {"side": 40, "weighted": True,
                                "streets": True}}, seed)
    fwd = dict(zip(zip(g.src.tolist(), g.dst.tolist()), g.weights.tolist()))
    assert all(fwd[(d, s)] == w for (s, d), w in fwd.items())
    streets = 2 * 40 * 39
    assert abs(g.num_edges / 2 - 0.7 * streets) < 4 * (streets * 0.21) ** 0.5
    # keeping every street gives the whole two-way grid
    full = graphs.road(12, keep=1.0, seed=seed, streets=True).symmetrized()
    both = graphs.road(12, keep=1.0, seed=seed)
    assert both.num_edges == 4 * 12 * 11
    assert (set(zip(full.src.tolist(), full.dst.tolist()))
            == set(zip(both.src.tolist(), both.dst.tolist())))


def test_make_follows_the_config():
    g = graphs.make({"generator": "rmat", "symmetrize": True,
                     "params": {"scale": 7, "weighted": True}}, 11)
    same(g, G.rmat(7, seed=11, weighted=True).symmetrized())
    assert graphs.make({"generator": "rmat", "params": {"scale": 7}},
                       12).num_edges != g.num_edges


def test_root_rules():
    g = graphs.rmat(8, 4, seed=1).symmetrized()
    cands = graphs.ROOT_RULES["graph500"](g)
    assert (g.out_degrees()[cands] > 0).all()
    assert cands.size == np.count_nonzero(g.out_degrees())
    # a line 0 -> 1 -> 2 plus a cycle 3 <-> 4 <-> 5: the cycle is largest
    line = graphs.Edges(6, np.array([0, 1, 3, 4, 4, 5], np.int32),
                        np.array([1, 2, 4, 3, 5, 4], np.int32), None)
    np.testing.assert_array_equal(graphs.ROOT_RULES["largest_scc"](line),
                                  [3, 4, 5])
