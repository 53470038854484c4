"""Frozen graph generators of the benchmark (NumPy only).

``rmat`` and ``road`` are copies of the port's generators
(``repro_torch/core/graph.py``) that return plain edge arrays: the same
seed gives the same edges as the port, and a later change to the port's
generators does not change what the benchmark feeds it. ``road`` can
also draw per-edge weights from the same stream, after the edges, and
keep streets in place of directed edges (a road map's undirected
streets, made two-way by ``symmetrize``).

``ROOT_RULES`` give the vertices a mix draws roots from: Graph500's rule
(vertices of degree >= 1), or the largest strongly connected component
(the largest component of a symmetrized graph), so that every root
reaches the same set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Edges", "rmat", "road", "make", "ROOT_RULES"]


@dataclasses.dataclass(frozen=True)
class Edges:
    """A directed graph as deduplicated edge arrays, self-loops removed."""

    num_vertices: int
    src: np.ndarray                    # (E,) int32
    dst: np.ndarray                    # (E,) int32
    weights: Optional[np.ndarray]      # (E,) float32 or None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices)

    def symmetrized(self) -> "Edges":
        w = (None if self.weights is None
             else np.concatenate([self.weights, self.weights]))
        return _dedup(self.num_vertices, np.concatenate([self.src, self.dst]),
                      np.concatenate([self.dst, self.src]), w)


def _dedup(n, src, dst, w) -> Edges:
    keys = src.astype(np.int64) * n + dst
    _, idx = np.unique(keys, return_index=True)
    idx.sort()
    return Edges(n, src[idx].astype(np.int32), dst[idx].astype(np.int32),
                 None if w is None else w[idx])


def _finalize(n, src, dst, rng, weighted) -> Edges:
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    w = (rng.uniform(0.5, 2.0, size=src.shape).astype(np.float32)
         if weighted else None)
    keep = src != dst
    return _dedup(n, src[keep], dst[keep], None if w is None else w[keep])


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         weighted: bool = False) -> Edges:
    """R-MAT (Chakrabarti et al. 2004) as Graph500 draws it: ``2**scale``
    vertices, ``edge_factor * 2**scale`` edges before deduplication,
    vertices relabelled by a random permutation."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    d_ = 1.0 - a - b - c
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        sbit = (r1 < c + d_).astype(np.int64)
        p = np.where(sbit == 1, d_ / (c + d_), b / (a + b))
        dbit = (r2 < p).astype(np.int64)
        src = src * 2 + sbit
        dst = dst * 2 + dbit
    perm = rng.permutation(n)
    return _finalize(n, perm[src], perm[dst], rng, weighted)


def road(side: int, *, seed: int = 0, keep: float = 0.7,
         weighted: bool = False, streets: bool = False) -> Edges:
    """A ``side`` x ``side`` grid whose directed edges (both directions of
    each street) are each kept with probability ``keep``; with
    ``streets``, each street is kept with probability ``keep`` as one
    edge from its lower vertex, to be symmetrized."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    v = (ii * side + jj).astype(np.int64)
    right_s, right_d = v[:, :-1].ravel(), v[:, 1:].ravel()
    down_s, down_d = v[:-1, :].ravel(), v[1:, :].ravel()
    src = np.concatenate([right_s, down_s] + ([] if streets
                                              else [right_d, down_d]))
    dst = np.concatenate([right_d, down_d] + ([] if streets
                                              else [right_s, down_s]))
    kept = rng.random(src.shape[0]) < keep
    return _finalize(side * side, src[kept], dst[kept], rng, weighted)


GENERATORS = {"rmat": rmat, "road": road}


def make(spec: dict, seed: int) -> Edges:
    """The graph a configuration's ``graph`` entry describes, from
    ``seed``: ``{"generator": name, "params": {...}, "symmetrize": bool}``."""
    g = GENERATORS[spec["generator"]](**spec["params"], seed=seed)
    return g.symmetrized() if spec.get("symmetrize") else g


def graph500_candidates(g: Edges) -> np.ndarray:
    """Graph500's search keys: the vertices of degree >= 1."""
    return np.flatnonzero(g.out_degrees() > 0)


def largest_scc(g: Edges) -> np.ndarray:
    """The vertices of the largest strongly connected component."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    a = csr_matrix((np.ones(g.num_edges, np.int8), (g.src, g.dst)),
                   shape=(g.num_vertices, g.num_vertices))
    _, labels = connected_components(a, directed=True, connection="strong")
    return np.flatnonzero(labels == np.bincount(labels).argmax())


# where a traffic mix draws its roots ("roots" in the mix's file)
ROOT_RULES = {"graph500": graph500_candidates, "largest_scc": largest_scc}
