"""The plain reference: BFS, SSSP and PageRank in plain PyTorch.

Written from the algorithms' definitions over the benchmark's own edge
arrays, not from the port: it imports nothing of the program and takes
nothing the program made. It runs on any device; the benchmark runs it
on the card after the measured window, the tests on the CPU.

The semantics are those the port promises (the paper's vertex programs,
as the JAX package defines them):

- BFS: ``parent[v]`` is the smallest id among ``v``'s in-neighbours one
  level nearer the root; the root is its own parent; -1 where unreached.
- SSSP: float distances relaxed in synchronous rounds (Bellman-Ford over
  the vertices that improved in the round before). ``parent[v]`` is the
  smallest id among the senders that first gave ``v`` its final
  distance, in the round it was first reached. Each sum is rounded to
  the dtype asked for, so float32 gives the exact float32 fixpoint.
- PageRank: ``num_iters`` synchronous iterations from ``1/n``, each
  vertex sending ``rank/out_degree`` along its out-edges, the new rank
  ``(1 - d)/n + d * sum``; mass of vertices without out-edges is dropped.
"""
from __future__ import annotations

import torch

__all__ = ["bfs", "sssp", "pagerank"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_UNSET = torch.iinfo(torch.int32).max
# rounds between the host's checks for an empty frontier: extra rounds
# over an empty frontier change nothing
_CHECK_EVERY = 8


def _rows(src: torch.Tensor, batch: int) -> torch.Tensor:
    return src.unsqueeze(0).expand(batch, -1)


def bfs(n: int, src: torch.Tensor, dst: torch.Tensor,
        roots: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 parents for the (B,) ``roots``."""
    B = roots.shape[0]
    dev = src.device
    ar = torch.arange(B, device=dev)
    level = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    level[ar, roots] = 0
    frontier = torch.zeros((B, n), dtype=torch.bool, device=dev)
    frontier[ar, roots] = True
    dst_rows = _rows(dst, B)
    depth = 0
    while True:
        for _ in range(_CHECK_EVERY):
            depth += 1
            hit = torch.zeros((B, n), dtype=torch.int32, device=dev)
            hit.scatter_reduce_(1, dst_rows, frontier[:, src].to(torch.int32),
                                "amax")
            frontier = (hit > 0) & (level < 0)
            level = torch.where(frontier, depth, level)
        if not bool(frontier.any()):
            break
    # parent: the smallest in-neighbour exactly one level nearer
    lsrc, ldst = level[:, src], level[:, dst]
    tree = (lsrc >= 0) & (ldst == lsrc + 1)
    cand = torch.where(tree, src.to(torch.int32), _UNSET)
    parent = torch.full((B, n), _UNSET, dtype=torch.int32, device=dev)
    parent.scatter_reduce_(1, dst_rows, cand, "amin")
    parent = torch.where(level < 0, -1, parent)
    parent[ar, roots] = roots.to(torch.int32)
    return parent


def _rounding(dtype, acc):
    """Values held in ``acc`` and rounded to ``dtype`` after each step:
    a lower precision than ``acc`` without kernels of its own."""
    if dtype == acc:
        return lambda x: x
    return lambda x: x.to(dtype).to(acc)


def sssp(n: int, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
         roots: torch.Tensor, dtype=torch.float32):
    """(B, n) float32 distances, each sum rounded to ``dtype``, and int32
    parents."""
    B = roots.shape[0]
    dev = src.device
    ar = torch.arange(B, device=dev)
    rnd = _rounding(dtype, torch.float32)
    w = rnd(w.to(torch.float32))
    inf = torch.tensor(float("inf"), device=dev)
    dist = torch.full((B, n), float("inf"), device=dev)
    dist[ar, roots] = 0
    parent = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    parent[ar, roots] = roots.to(torch.int32)
    active = torch.zeros((B, n), dtype=torch.bool, device=dev)
    active[ar, roots] = True
    dst_rows = _rows(dst, B)
    src32 = src.to(torch.int32)
    while True:
        for _ in range(_CHECK_EVERY):
            sent = active[:, src]
            cand = torch.where(sent, rnd(dist[:, src] + w), inf)
            best = torch.full((B, n), float("inf"), device=dev)
            best.scatter_reduce_(1, dst_rows, cand, "amin")
            won = sent & (cand == best[:, dst])
            who = torch.full((B, n), _UNSET, dtype=torch.int32, device=dev)
            who.scatter_reduce_(1, dst_rows, torch.where(won, src32, _UNSET),
                                "amin")
            active = best < dist
            dist = torch.where(active, best, dist)
            parent = torch.where(active, who, parent)
        if not bool(active.any()):
            break
    return dist, parent


def pagerank(n: int, src: torch.Tensor, dst: torch.Tensor, num_iters: int,
             damping: float, dtype=torch.float64) -> torch.Tensor:
    """(n,) ranks after ``num_iters`` iterations: in float64, or in
    float32 with every value rounded to a lower ``dtype``."""
    dev = src.device
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    rnd = _rounding(dtype, acc)
    deg = rnd(torch.bincount(src, minlength=n).clamp(min=1).to(acc))
    rank = rnd(torch.full((n,), 1.0 / n, dtype=acc, device=dev))
    base = rnd(torch.tensor((1.0 - damping) / n, dtype=acc, device=dev))
    for _ in range(num_iters):
        share = rnd(rank / deg)[src]
        total = rnd(torch.zeros(n, dtype=acc, device=dev).index_add_(
            0, dst, share))
        rank = rnd(base + rnd(damping * total))
    return rank
