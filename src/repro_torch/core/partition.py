"""Vertex partitioning and device-layout compilation (the port's own
numpy copy of ``repro.core.partition``; same inputs, same arrays).

Implements the paper's §4.4:
  - ``round_robin``         : vertex count balance (paper's least-effort).
  - ``greedy_edge_balance`` : assign each vertex (stream order, no sort) to
                              the bin with lowest cumulative out-degree —
                              the paper's default, "near-perfect" heuristic.
  - ``snake_lpt``           : sorted longest-processing-time variant
                              (vectorized; within rounding of greedy).
  - ``ldg``                 : streaming Linear Deterministic Greedy — our
                              METIS stand-in (locality-aware, minimizes
                              cross-shard edges under a balance cap). METIS
                              itself is unavailable offline; the paper finds
                              greedy within 5% of METIS anyway (Fig. 13).

and compiles a :class:`PartitionedGraph` holding BOTH edge layouts of
paper Fig. 4:
  - GraVF   (left) : source-partitioned CSR — shard p stores out-edges of
                     its owned vertices, grouped by destination shard
                     (unicast message exchange).
  - GraVF-M (right): destination-partitioned CSC — shard p stores, for ALL
                     vertices, the subset of edges whose destination lives
                     on p (receiver-side scatter after update broadcast).

plus the neighbor-filter bitmap of §4.3 (|V| x P: which shards host
neighbors of each vertex).

All per-shard arrays are padded to identical static shapes so they stack
into SPMD-shardable global arrays with a leading shard axis.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Optional

import numpy as np

from .graph import Graph

__all__ = [
    "round_robin",
    "greedy_edge_balance",
    "snake_lpt",
    "ldg",
    "PARTITIONERS",
    "PartitionedGraph",
    "partition_graph",
]


# ---------------------------------------------------------------------------
# Partitioners: Graph -> part_of (V,) int32
# ---------------------------------------------------------------------------

def round_robin(g: Graph, num_parts: int) -> np.ndarray:
    return (np.arange(g.num_vertices) % num_parts).astype(np.int32)


def greedy_edge_balance(g: Graph, num_parts: int) -> np.ndarray:
    """Paper default: stream vertices in natural order, assign to the bin
    with the lowest cumulative edge count. Exact heap implementation."""
    deg = g.out_degrees()
    part_of = np.zeros(g.num_vertices, np.int32)
    heap = [(0, p) for p in range(num_parts)]
    heapq.heapify(heap)
    for v in range(g.num_vertices):
        load, p = heapq.heappop(heap)
        part_of[v] = p
        heapq.heappush(heap, (load + int(deg[v]), p))
    return part_of


def snake_lpt(g: Graph, num_parts: int) -> np.ndarray:
    """Vectorized LPT approximation: sort by degree desc, deal out in
    alternating (snake) order. O(V log V), no Python loop."""
    deg = g.out_degrees()
    order = np.argsort(-deg, kind="stable")
    part_of = np.zeros(g.num_vertices, np.int32)
    n = g.num_vertices
    idx = np.arange(n)
    block = idx // num_parts
    pos = idx % num_parts
    snake_pos = np.where(block % 2 == 0, pos, num_parts - 1 - pos)
    part_of[order] = snake_pos.astype(np.int32)
    return part_of


def ldg(g: Graph, num_parts: int, *, eps: float = 0.1,
        chunk: int = 4096) -> np.ndarray:
    """Streaming Linear Deterministic Greedy (METIS stand-in): assign v to
    the shard maximizing |N(v) ∩ shard| * (1 - load/capacity). Processes
    vertices in chunks for speed (standard streaming approximation)."""
    V = g.num_vertices
    deg = g.out_degrees().astype(np.float64)
    capacity = (1.0 + eps) * max(1.0, deg.sum()) / num_parts
    part_of = np.full(V, -1, np.int32)
    load = np.zeros(num_parts, np.float64)

    # adjacency (undirected view) as CSR for neighbor lookup
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    starts = np.searchsorted(src_s, np.arange(V))
    ends = np.searchsorted(src_s, np.arange(V) + 1)

    for c0 in range(0, V, chunk):
        c1 = min(V, c0 + chunk)
        scores = np.zeros((c1 - c0, num_parts), np.float64)
        for i, v in enumerate(range(c0, c1)):
            nbr = dst_s[starts[v]:ends[v]]
            placed = part_of[nbr]
            placed = placed[placed >= 0]
            if placed.size:
                np.add.at(scores[i], placed, 1.0)
        scores *= np.maximum(0.0, 1.0 - load[None, :] / capacity)
        # Tie-break towards least-loaded shard.
        scores -= 1e-9 * load[None, :]
        choice = np.argmax(scores, axis=1).astype(np.int32)
        part_of[c0:c1] = choice
        np.add.at(load, choice, deg[c0:c1])
    return part_of


PARTITIONERS: Dict[str, Callable[..., np.ndarray]] = {
    "round_robin": round_robin,
    "greedy": greedy_edge_balance,
    "snake_lpt": snake_lpt,
    "ldg": ldg,
}


# ---------------------------------------------------------------------------
# PartitionedGraph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Static per-shard device layout. Leading axis = shard (the paper's
    FPGA). All shapes identical across shards (SPMD)."""

    num_parts: int
    num_vertices: int
    num_edges: int
    v_max: int          # max owned vertices per shard (padded)
    e_in_max: int       # max in-edges per shard (GraVF-M layout, padded)
    e_pair_max: int     # max edges between any ordered shard pair (GraVF)

    # vertex ownership
    part_of: np.ndarray     # (V,) int32
    local_of: np.ndarray    # (V,) int32
    vert_gid: np.ndarray    # (P, v_max) int32, pad = -1
    vert_valid: np.ndarray  # (P, v_max) bool
    out_deg: np.ndarray     # (P, v_max) int32 (out-degree of owned verts)

    # GraVF-M destination-partitioned CSC (sorted by (shard, dst_local))
    in_src_slot: np.ndarray     # (P, e_in_max) int32: src as p*v_max+local
    in_src_gid: np.ndarray      # (P, e_in_max) int32
    in_src_outdeg: np.ndarray   # (P, e_in_max) int32
    in_dst_local: np.ndarray    # (P, e_in_max) int32, pad = v_max
    in_w: np.ndarray            # (P, e_in_max) float32, pad = 0
    in_valid: np.ndarray        # (P, e_in_max) bool

    # GraVF source-partitioned CSR grouped by destination shard
    pair_src_local: np.ndarray   # (P, P, e_pair_max) int32, pad = 0
    pair_src_gid: np.ndarray     # (P, P, e_pair_max) int32
    pair_src_outdeg: np.ndarray  # (P, P, e_pair_max) int32
    pair_dst_local: np.ndarray   # (P, P, e_pair_max) int32, pad = v_max
    pair_w: np.ndarray           # (P, P, e_pair_max) float32
    pair_valid: np.ndarray       # (P, P, e_pair_max) bool

    # §4.3 neighbor filter: nbr_filter[v, p] = does v have a neighbor on p.
    nbr_filter: np.ndarray  # (V, P) bool

    @property
    def slot_of(self) -> np.ndarray:
        return (self.part_of.astype(np.int64) * self.v_max
                + self.local_of).astype(np.int32)

    # -- byte-size accounting (the §5 model's m_board consumer) ------------
    @property
    def nbytes(self) -> int:
        """Total bytes across every compiled array (host mirror of what an
        engine uploads, plus the edge-list kept for stats)."""
        return int(sum(getattr(self, f.name).nbytes
                       for f in dataclasses.fields(self)
                       if isinstance(getattr(self, f.name), np.ndarray)))

    @property
    def device_nbytes(self) -> int:
        """Bytes of the per-shard layout arrays an engine turns into
        device buffers — what a memory-budgeted GraphStore charges a
        resident graph against ``Platform.m_board``. Excludes the
        host-only ``src_for_stats``/``dst_for_stats`` accounting copies."""
        skip = ("src_for_stats", "dst_for_stats")
        return int(sum(getattr(self, f.name).nbytes
                       for f in dataclasses.fields(self)
                       if f.name not in skip
                       and isinstance(getattr(self, f.name), np.ndarray)))

    # -- combine-at-source buckets (degree-factor exchange compression) ----
    def combined_buckets(self) -> Dict[str, np.ndarray]:
        """Re-sort each (source shard p, dest shard q) edge bucket by
        destination vertex and rank its DISTINCT destinations — the layout
        the ``combined`` exchange segment-reduces into before the wire.

        Returns a dict of (P, P, e_pair_max) edge arrays (the ``pair_*``
        fields reordered dst-sorted within each bucket, stable), plus:
          dst_rank : (P, P, e_pair_max) int32 — rank of the edge's dst
                     among the bucket's distinct dsts; invalid -> comb_max
                     (the per-bucket discard bin).
          comb_dst : (P, P, comb_max) int32 — the r-th distinct dst_local
                     of bucket (p, q); pad = v_max. Static layout, so the
                     receiver never needs ids on the wire.
          comb_max : max distinct dsts over all buckets, padded to a
                     multiple of 8 (the all_to_all block width).
        """
        P, E2, Vm = self.num_parts, self.e_pair_max, self.v_max
        key = np.where(self.pair_valid, self.pair_dst_local, Vm)
        order = np.argsort(key, axis=-1, kind="stable")

        def take(a):
            return np.ascontiguousarray(
                np.take_along_axis(a, order, axis=-1))

        dst = np.take_along_axis(key, order, axis=-1)
        valid = take(self.pair_valid)
        new = np.zeros_like(valid)
        new[..., 0] = valid[..., 0]
        new[..., 1:] = valid[..., 1:] & (dst[..., 1:] != dst[..., :-1])
        counts = new.sum(axis=-1)
        R = int(counts.max()) if counts.size else 1
        R = int(-(-max(R, 1) // 8) * 8)
        rank = np.cumsum(new, axis=-1) - 1
        rank = np.where(valid, rank, R).astype(np.int32)
        comb_dst = np.full((P, P, R), Vm, np.int32)
        pp, qq, _ = np.nonzero(new)
        comb_dst[pp, qq, rank[new]] = dst[new]
        return dict(
            src_local=take(self.pair_src_local),
            src_gid=take(self.pair_src_gid),
            src_outdeg=take(self.pair_src_outdeg),
            dst_local=take(self.pair_dst_local),
            w=take(self.pair_w),
            valid=valid,
            dst_rank=rank,
            comb_dst=comb_dst,
            comb_max=R,
        )

    # -- paper §4.3 accounting: how much the filter + broadcast save -------
    def comm_stats(self) -> Dict[str, float]:
        """Per-superstep worst-case traffic (units: payload words), for the
        perfmodel and EXPERIMENTS tables."""
        P = self.num_parts
        cross_mask = self.part_of[self.src_for_stats] != self.part_of[self.dst_for_stats]
        cross_edges = int(cross_mask.sum())
        bcast_updates = int(self.nbr_filter.sum()) - int(
            self.nbr_filter[np.arange(self.num_vertices), self.part_of].sum())
        return {
            "unicast_cross_edges": cross_edges,            # GraVF traffic
            "broadcast_naive": self.num_vertices * (P - 1),  # no filter
            "broadcast_filtered": bcast_updates,           # GraVF-M + filter
        }

    # stats helpers (original edge list retained for accounting only)
    src_for_stats: np.ndarray = dataclasses.field(default=None, repr=False)
    dst_for_stats: np.ndarray = dataclasses.field(default=None, repr=False)


def partition_graph(g: Graph, num_parts: int, *, method: str = "greedy",
                    pad_multiple: int = 256,
                    part_of: Optional[np.ndarray] = None) -> PartitionedGraph:
    """Compile ``g`` into the two padded shard layouts of Fig. 4."""
    P = num_parts
    if part_of is None:
        part_of = PARTITIONERS[method](g, P)
    part_of = part_of.astype(np.int32)
    V = g.num_vertices

    # local indices per shard, in global-id order (stable)
    local_of = np.zeros(V, np.int32)
    counts = np.zeros(P, np.int64)
    order = np.argsort(part_of, kind="stable")
    # rank within shard
    sorted_parts = part_of[order]
    ranks = np.arange(V) - np.searchsorted(sorted_parts, sorted_parts)
    local_of[order] = ranks.astype(np.int32)
    counts = np.bincount(part_of, minlength=P).astype(np.int64)

    def up(n, m):
        return int(-(-max(n, 1) // m) * m)

    v_max = up(int(counts.max()) if V else 1, pad_multiple)

    vert_gid = np.full((P, v_max), -1, np.int32)
    vert_valid = np.zeros((P, v_max), bool)
    out_deg_g = g.out_degrees().astype(np.int32)
    out_deg = np.zeros((P, v_max), np.int32)
    vert_gid[part_of, local_of] = np.arange(V, dtype=np.int32)
    vert_valid[part_of, local_of] = True
    out_deg[part_of, local_of] = out_deg_g

    w = g.weights if g.weights is not None else np.ones(g.num_edges, np.float32)
    src, dst = g.src, g.dst
    slot_of = (part_of.astype(np.int64) * v_max + local_of).astype(np.int32)

    # ---- GraVF-M: dst-partitioned CSC ------------------------------------
    dpart = part_of[dst]
    dloc = local_of[dst]
    key = dpart.astype(np.int64) * (v_max + 1) + dloc
    eorder = np.argsort(key, kind="stable")
    e_counts = np.bincount(dpart, minlength=P).astype(np.int64)
    e_in_max = up(int(e_counts.max()) if g.num_edges else 1, pad_multiple)

    in_src_slot = np.zeros((P, e_in_max), np.int32)
    in_src_gid = np.zeros((P, e_in_max), np.int32)
    in_src_outdeg = np.ones((P, e_in_max), np.int32)
    in_dst_local = np.full((P, e_in_max), v_max, np.int32)
    in_w = np.zeros((P, e_in_max), np.float32)
    in_valid = np.zeros((P, e_in_max), bool)

    es, ed, ew = src[eorder], dst[eorder], w[eorder]
    edp = dpart[eorder]
    starts = np.searchsorted(edp, np.arange(P))
    ends = np.searchsorted(edp, np.arange(P) + 1)
    for p in range(P):
        s, e = int(starts[p]), int(ends[p])
        n = e - s
        if n == 0:
            continue
        in_src_slot[p, :n] = slot_of[es[s:e]]
        in_src_gid[p, :n] = es[s:e]
        in_src_outdeg[p, :n] = np.maximum(1, out_deg_g[es[s:e]])
        in_dst_local[p, :n] = local_of[ed[s:e]]
        in_w[p, :n] = ew[s:e]
        in_valid[p, :n] = True

    # ---- GraVF: src-partitioned, grouped by destination shard ------------
    spart = part_of[src]
    pair_key = (spart.astype(np.int64) * P + dpart)
    porder = np.argsort(pair_key, kind="stable")
    pair_counts = np.bincount(pair_key, minlength=P * P).astype(np.int64)
    e_pair_max = up(int(pair_counts.max()) if g.num_edges else 1,
                    max(8, pad_multiple // 8))

    pair_src_local = np.zeros((P, P, e_pair_max), np.int32)
    pair_src_gid = np.zeros((P, P, e_pair_max), np.int32)
    pair_src_outdeg = np.ones((P, P, e_pair_max), np.int32)
    pair_dst_local = np.full((P, P, e_pair_max), v_max, np.int32)
    pair_w = np.zeros((P, P, e_pair_max), np.float32)
    pair_valid = np.zeros((P, P, e_pair_max), bool)

    ps, pd, pw = src[porder], dst[porder], w[porder]
    pk = pair_key[porder]
    pstarts = np.searchsorted(pk, np.arange(P * P))
    pends = np.searchsorted(pk, np.arange(P * P) + 1)
    for pq in range(P * P):
        s, e = int(pstarts[pq]), int(pends[pq])
        n = e - s
        if n == 0:
            continue
        p, q = pq // P, pq % P
        pair_src_local[p, q, :n] = local_of[ps[s:e]]
        pair_src_gid[p, q, :n] = ps[s:e]
        pair_src_outdeg[p, q, :n] = np.maximum(1, out_deg_g[ps[s:e]])
        pair_dst_local[p, q, :n] = local_of[pd[s:e]]
        pair_w[p, q, :n] = pw[s:e]
        pair_valid[p, q, :n] = True

    # ---- neighbor filter bitmap (§4.3) -----------------------------------
    nbr_filter = np.zeros((V, P), bool)
    nbr_filter[src, dpart] = True

    return PartitionedGraph(
        num_parts=P, num_vertices=V, num_edges=g.num_edges,
        v_max=v_max, e_in_max=e_in_max, e_pair_max=e_pair_max,
        part_of=part_of, local_of=local_of,
        vert_gid=vert_gid, vert_valid=vert_valid, out_deg=out_deg,
        in_src_slot=in_src_slot, in_src_gid=in_src_gid,
        in_src_outdeg=in_src_outdeg, in_dst_local=in_dst_local,
        in_w=in_w, in_valid=in_valid,
        pair_src_local=pair_src_local, pair_src_gid=pair_src_gid,
        pair_src_outdeg=pair_src_outdeg, pair_dst_local=pair_dst_local,
        pair_w=pair_w, pair_valid=pair_valid,
        nbr_filter=nbr_filter,
        src_for_stats=src, dst_for_stats=dst,
    )

