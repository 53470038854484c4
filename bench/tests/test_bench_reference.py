"""The plain reference against hand-solved graphs and against the port's
CPU engine at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.checks import bfs as CB, pagerank as CP, sssp as CS
from bench.gen import graphs
from bench.reference import graph_algorithms as R


def edges(n, pairs, w=None):
    src = torch.tensor([a for a, _ in pairs])
    dst = torch.tensor([b for _, b in pairs])
    return n, src, dst, (None if w is None else torch.tensor(w, dtype=torch.float32))


def test_bfs_by_hand():
    # levels: 0 | 1 2 | 3 4 | 5; 6 unreached; 4 -> 3 joins one level
    n, src, dst, _ = edges(7, [(0, 1), (0, 2), (2, 3), (1, 3), (2, 4),
                               (4, 3), (4, 5), (3, 5)])
    got = R.bfs(n, src, dst, torch.tensor([0, 6]))
    assert got[0].tolist() == [0, 0, 0, 1, 2, 3, -1]
    assert got[1].tolist() == [-1, -1, -1, -1, -1, -1, 6]


def test_sssp_by_hand():
    # 4 is reached at 1.0 first by 5 (round 1), again at 1.0 by 0 (round
    # 2): the first sender stays. 3 is reached at 2.0 by 1 and 2 in one
    # round: the smaller id. 6 improves from 3.0 to 0.75 in round 2.
    pairs = [(5, 4), (5, 0), (0, 4), (5, 1), (5, 2), (1, 3), (2, 3), (5, 6),
             (0, 6)]
    w = [1.0, 0.5, 0.5, 1.0, 1.0, 1.0, 1.0, 3.0, 0.25]
    n, src, dst, wt = edges(7, pairs, w)
    dist, parent = R.sssp(n, src, dst, wt, torch.tensor([5]))
    assert dist[0].tolist() == [0.5, 1.0, 1.0, 2.0, 1.0, 0.0, 0.75]
    assert parent[0].tolist() == [5, 5, 5, 1, 5, 5, 0]


def test_pagerank_by_hand():
    pairs = [(0, 1), (0, 2), (1, 2), (2, 0), (3, 2)]
    n, src, dst, _ = edges(4, pairs)
    rank = np.full(4, 0.25)
    for _ in range(5):
        new = np.full(4, 0.15 / 4)
        for a, b in pairs:
            new[b] += 0.85 * rank[a] / sum(1 for x, _ in pairs if x == a)
        rank = new
    np.testing.assert_allclose(R.pagerank(n, src, dst, 5, 0.85).numpy(),
                               rank, rtol=1e-12)


class _G:
    def __init__(self, g):
        self.num_vertices = g.num_vertices
        self.src = torch.as_tensor(g.src, dtype=torch.int64)
        self.dst = torch.as_tensor(g.dst, dtype=torch.int64)
        self.w = torch.as_tensor(g.weights)


def port_engine(g, kernel, **params):
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import partition_graph
    pg = partition_graph(Graph(g.num_vertices, g.src, g.dst, g.weights), 4,
                         method="greedy")
    return Engine(ALG.ALGORITHMS[kernel](**params), pg, device="cpu")


GRAPHS = {
    "rmat": lambda seed: graphs.make(
        {"generator": "rmat", "symmetrize": True,
         "params": {"scale": 8, "weighted": True}}, seed),
    "road": lambda seed: graphs.make(
        {"generator": "road", "params": {"side": 14, "weighted": True}}, seed),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_rooted_kernels_equal_the_port(name, seed):
    g = GRAPHS[name](seed)
    roots = np.random.default_rng(seed).choice(
        graphs.ROOT_RULES["graph500"](g), size=6, replace=False)
    params = [{"root": int(r)} for r in roots]
    for kernel, check in (("bfs", CB), ("sssp", CS)):
        got = [r.state for r in port_engine(g, kernel).run_batch(root=roots)]
        numbers = check.compare(got, check.reference(_G(g), params))
        assert all(numbers[k] <= check.LIMITS[k] for k in numbers), numbers
        assert numbers["mismatch"] == 0


@pytest.mark.parametrize("seed", [3, 2**40 + 1])
def test_pagerank_equals_the_port(seed):
    g = GRAPHS["rmat"](seed)
    params = {"num_supersteps": 30, "damping": 0.85}
    got = [port_engine(g, "pagerank", **params).run().state]
    numbers = CP.compare(got, CP.reference(_G(g), [params]))
    assert numbers["rank_gap"] <= CP.LIMITS["rank_gap"]


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_control_in_bfloat16_fails(seed):
    """The reference in bfloat16 in the program's place fails each
    check's limit: SSSP's exact distances and PageRank's gap."""
    g = _G(GRAPHS["rmat"](seed))
    params = [{"root": int(r)} for r in range(4)]
    low = CS.reference(g, params, dtype=torch.bfloat16)
    numbers = CS.compare(low, CS.reference(g, params))
    assert numbers["mismatch"] > 0
    assert numbers["dist_gap"] > CS.LIMITS["dist_gap"]
    pr = [{"num_supersteps": 30, "damping": 0.85}]
    numbers = CP.compare(CP.reference(g, pr, dtype=torch.bfloat16),
                         CP.reference(g, pr))
    assert numbers["rank_gap"] > 10 * CP.LIMITS["rank_gap"]
