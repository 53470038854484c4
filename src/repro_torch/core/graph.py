"""Graph containers and generators (the port's own numpy copy).

Host-side (numpy) graph construction mirrors the paper's preprocessing
stage: graphs are read/generated as edge lists, partitioned, and compiled
into fixed-shape per-shard device arrays. The code is identical to
``repro.core.graph``, so the same seed gives the same graph in both
packages; the port keeps a copy so that it never imports the JAX package.

Generators reproduce the paper's datasets:
  - ``uniform``  : Erdos-Renyi-style, every vertex close to average degree
                   (paper Figs. 7, 8, 9).
  - ``rmat``     : Chakrabarti et al. recursive-matrix power-law graphs
                   (paper Fig. 12/13, Table 3 social-graph stand-in).
  - ``ladder``   : the width-w depth-d synthetic graphs of Fig. 10/11 used
                   to isolate superstep-synchronization latency.
  - ``line``     : ladder with w=1 (the 16385-vertex latency probe).
  - ``road``     : low-degree grid-like graph (the PA-road-network stand-in,
                   average degree ~2.8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "uniform",
    "rmat",
    "ladder",
    "line",
    "road",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable COO graph. ``src[i] -> dst[i]`` directed edges.

    ``weights`` is optional per-edge f32 data (the paper's edge data /
    message weight input to the scatter kernel).
    """

    num_vertices: int
    src: np.ndarray  # (E,) int32
    dst: np.ndarray  # (E,) int32
    weights: Optional[np.ndarray] = None  # (E,) float32 or None

    def __post_init__(self):
        assert self.src.dtype == np.int32 and self.dst.dtype == np.int32
        assert self.src.shape == self.dst.shape
        if self.weights is not None:
            assert self.weights.shape == self.src.shape

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(1, self.num_vertices)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.int64)

    def with_unit_weights(self) -> "Graph":
        w = np.ones(self.num_edges, np.float32)
        return dataclasses.replace(self, weights=w)

    def symmetrized(self) -> "Graph":
        """Add reverse edges (paper's WCC operates on undirected reach)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = None
        if self.weights is not None:
            w = np.concatenate([self.weights, self.weights])
        g = Graph(self.num_vertices, src.astype(np.int32), dst.astype(np.int32), w)
        return g.deduplicated()

    def deduplicated(self) -> "Graph":
        keys = self.src.astype(np.int64) * self.num_vertices + self.dst
        _, idx = np.unique(keys, return_index=True)
        idx.sort()
        w = self.weights[idx] if self.weights is not None else None
        return Graph(self.num_vertices, self.src[idx], self.dst[idx], w)

    def without_self_loops(self) -> "Graph":
        keep = self.src != self.dst
        w = self.weights[keep] if self.weights is not None else None
        return Graph(self.num_vertices, self.src[keep], self.dst[keep], w)


def _finalize(num_vertices: int, src: np.ndarray, dst: np.ndarray,
              rng: np.random.Generator, weighted: bool) -> Graph:
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    w = rng.uniform(0.5, 2.0, size=src.shape).astype(np.float32) if weighted else None
    return Graph(num_vertices, src, dst, w).without_self_loops().deduplicated()


def uniform(num_vertices: int, avg_degree: float, *, seed: int = 0,
            weighted: bool = False) -> Graph:
    """Uniform random graph: edges with equal probability for any pair."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_vertices * avg_degree)
    src = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    return _finalize(num_vertices, src, dst, rng, weighted)


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weighted: bool = False) -> Graph:
    """R-MAT generator (Chakrabarti et al. 2004) as used by graph500 and the
    paper's scale-free datasets. ``2**scale`` vertices, ``edge_factor *
    2**scale`` edges before dedup."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    num_edges = edge_factor * n
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    # Vectorized: per bit level, choose quadrant.
    p_src1 = c + (1.0 - a - b - c)  # P(src bit = 1) = c + d
    for level in range(scale):
        r1 = rng.random(num_edges)
        r2 = rng.random(num_edges)
        sbit = (r1 < p_src1).astype(np.int64)
        # P(dst bit = 1 | src bit) — conditional quadrant probabilities.
        d_ = 1.0 - a - b - c
        p_d1_given_s0 = b / (a + b)
        p_d1_given_s1 = d_ / (c + d_)
        p = np.where(sbit == 1, p_d1_given_s1, p_d1_given_s0)
        dbit = (r2 < p).astype(np.int64)
        src = src * 2 + sbit
        dst = dst * 2 + dbit
    # Random vertex relabeling to break degree-locality artifacts.
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    return _finalize(n, src, dst, rng, weighted)


def ladder(width: int, depth: int, extra_degree: int = 0, *, seed: int = 0) -> Graph:
    """Paper Fig. 10 synthetic: a root vertex, then ``depth`` ranks of
    ``width`` vertices. Every vertex in rank r connects to every vertex of
    rank r+1? No — the paper's solid edges form a BFS spanning tree with
    exactly ``width`` active vertices per superstep; dashed intra-rank edges
    raise average degree without changing activation timing.

    We connect vertex i of rank r to vertex i of rank r+1 (spanning chain)
    plus ``extra_degree`` intra-rank edges per vertex.
    """
    rng = np.random.default_rng(seed)
    n = 1 + width * depth
    srcs, dsts = [], []

    def vid(rank: int, i: int) -> int:
        return 1 + (rank - 1) * width + i if rank >= 1 else 0

    # Root to all of rank 1.
    srcs.append(np.zeros(width, np.int64))
    dsts.append(np.arange(1, 1 + width, dtype=np.int64))
    # Rank chains.
    for r in range(1, depth):
        base_a = 1 + (r - 1) * width
        base_b = 1 + r * width
        srcs.append(np.arange(base_a, base_a + width, dtype=np.int64))
        dsts.append(np.arange(base_b, base_b + width, dtype=np.int64))
    # Intra-rank (dashed) edges.
    if extra_degree > 0 and width > 1:
        for r in range(1, depth + 1):
            base = 1 + (r - 1) * width
            s = np.repeat(np.arange(base, base + width, dtype=np.int64), extra_degree)
            d = base + rng.integers(0, width, size=width * extra_degree)
            srcs.append(s)
            dsts.append(d)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return _finalize(n, src, dst, rng, weighted=False)


def line(length: int) -> Graph:
    """The paper's 16385-vertex latency probe is ``line(16384)``."""
    return ladder(1, length)


def road(side: int, *, seed: int = 0) -> Graph:
    """Grid-like low-degree graph; average degree ~2.8 like the PA road
    network subgraph in the paper (we drop a fraction of grid edges)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    v = (ii * side + jj).astype(np.int64)
    right_s, right_d = v[:, :-1].ravel(), v[:, 1:].ravel()
    down_s, down_d = v[:-1, :].ravel(), v[1:, :].ravel()
    src = np.concatenate([right_s, down_s, right_d, down_d])
    dst = np.concatenate([right_d, down_d, right_s, down_s])
    keep = rng.random(src.shape[0]) < 0.7
    return _finalize(n, src[keep], dst[keep], rng, weighted=False)
