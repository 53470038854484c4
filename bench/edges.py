"""Traversed edges, counted from the benchmark's graph (never from the
program's message counter).

A rooted query (BFS, SSSP) traverses, once, every edge whose source it
reaches: Graph500's rule (the edges of the root's component), read on
the directed, deduplicated edge list, so a symmetrized graph counts each
undirected edge twice. PageRank traverses every edge once an iteration.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

__all__ = ["traversed", "reach_edges"]


def reach_edges(g, roots) -> np.ndarray:
    """Edges whose source each root reaches. Roots in one strongly
    connected component reach the same set, so one search a component."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, connected_components
    a = csr_matrix((np.ones(g.num_edges, np.int8), (g.src, g.dst)),
                   shape=(g.num_vertices, g.num_vertices))
    _, label = connected_components(a, directed=True, connection="strong")
    deg = g.out_degrees()
    per_label: Dict[int, int] = {}
    out = []
    for r in np.asarray(roots, np.int64):
        lab = int(label[r])
        if lab not in per_label:
            seen = breadth_first_order(a, int(r), directed=True,
                                       return_predecessors=False)
            per_label[lab] = int(deg[seen].sum())
        out.append(per_label[lab])
    return np.array(out, np.int64)


def traversed(g, kernels: List[str], params: List[Dict[str, Any]]) -> int:
    """Edges traversed by the queries ``(kernel, params)`` together."""
    total = 0
    rooted = [p["root"] for k, p in zip(kernels, params) if "root" in p]
    if rooted:
        total += int(reach_edges(g, rooted).sum())
    for k, p in zip(kernels, params):
        if k == "pagerank":
            total += g.num_edges * int(p["num_supersteps"])
    return total
