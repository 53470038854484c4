"""The paper's benchmark algorithms (BFS, WCC, PageRank) plus SSSP and
degree centrality, as GraVF-M kernels in PyTorch (twins of
``repro.core.algorithms``: same names, state keys and dtypes).

State is a dict of per-vertex tensors; the ``active`` convention mirrors
the paper: gather sets an ``active`` bit in state, apply reads and clears
it and issues the update. Shapes follow :mod:`repro_torch.core.gas`.
"""
from __future__ import annotations

import torch

from .gas import GasKernel

__all__ = ["bfs", "wcc", "pagerank", "sssp", "degree_centrality", "ALGORITHMS"]

INT_MAX = torch.iinfo(torch.int32).max


def _per_query(flag: torch.Tensor, vshape) -> torch.Tensor:
    """A (B,) per-query flag spread over every vertex: (B, *vshape)."""
    return flag.view(-1, 1, 1).expand((flag.shape[0],) + tuple(vshape))


# ---------------------------------------------------------------------------
# WCC — the paper's worked example (§3). Propagate the lowest vertex id.
# ---------------------------------------------------------------------------

def wcc() -> GasKernel:
    def init_state(vert_gid, out_deg, valid, **_):
        gid = torch.where(valid, vert_gid, INT_MAX)
        return {"label": gid.to(torch.int32),
                "active": valid}  # every vertex broadcasts its id first

    def apply(state, vert_gid, out_deg, superstep):
        payload = state["label"]
        active = state["active"]
        new_state = {"label": state["label"],
                     "active": torch.zeros_like(active)}
        return new_state, payload, active

    def scatter(payload, weight, src_gid, src_outdeg):
        return payload  # forward the label as-is (paper Listing 3)

    def gather(state, combined, got, superstep):
        # paper Listing 1: keep the smaller label, mark active on change.
        new_label = got & (combined < state["label"])
        return {
            "label": torch.where(new_label, combined, state["label"]),
            "active": state["active"] | new_label,
        }

    return GasKernel(
        name="wcc", init_state=init_state, apply=apply, scatter=scatter,
        gather=gather, combiner="min", msg_dtype=torch.int32,
        update_bits=32, message_bits=32)


# ---------------------------------------------------------------------------
# BFS — parent-pointer spanning tree (graph500 flavour, paper §6.2).
# ---------------------------------------------------------------------------

def bfs(root: int = 0) -> GasKernel:
    # ``root`` is a query parameter: the factory argument is the default,
    # and the engine passes a (B, 1, 1) tensor of roots for a batch.
    def init_state(vert_gid, out_deg, valid, *, root=root, **_):
        root = torch.as_tensor(root, dtype=torch.int32,
                               device=vert_gid.device)
        is_root = vert_gid == root
        return {
            "parent": torch.where(is_root, root, -1).to(torch.int32),
            "active": is_root & valid,
        }

    def apply(state, vert_gid, out_deg, superstep):
        payload = vert_gid.to(torch.int32)  # "I am your parent"
        active = state["active"]
        return ({"parent": state["parent"],
                 "active": torch.zeros_like(active)}, payload, active)

    def scatter(payload, weight, src_gid, src_outdeg):
        return payload

    def gather(state, combined, got, superstep):
        newly = got & (state["parent"] < 0)
        return {
            "parent": torch.where(newly, combined, state["parent"]),
            "active": state["active"] | newly,
        }

    return GasKernel(
        name="bfs", init_state=init_state, apply=apply, scatter=scatter,
        gather=gather, combiner="min", msg_dtype=torch.int32,
        update_bits=32, message_bits=32, query_params=("root",))


# ---------------------------------------------------------------------------
# PageRank — Pregel-style fixed 30 supersteps (paper §6.2).
# ---------------------------------------------------------------------------

def pagerank(num_supersteps: int = 30, damping: float = 0.85) -> GasKernel:
    def init_state(vert_gid, out_deg, valid, *, num_vertices, **_):
        base = torch.where(valid, 1.0 / num_vertices, 0.0).to(torch.float32)
        return {"score": base,
                "num_vertices": torch.tensor(float(num_vertices),
                                             dtype=torch.float32,
                                             device=vert_gid.device)}

    def apply(state, vert_gid, out_deg, superstep):
        # contribution = score / out_degree, divided at the sender (Pregel).
        payload = state["score"] / out_deg.clamp(min=1).to(torch.float32)
        active = _per_query(superstep < num_supersteps, vert_gid.shape)
        return state, payload, active

    def scatter(payload, weight, src_gid, src_outdeg):
        return payload

    def gather(state, combined, got, superstep):
        n = state["num_vertices"]
        acc = torch.where(got, combined, 0.0)
        # A true division: torch's `scalar / tensor` multiplies by the
        # reciprocal and rounds differently from JAX's `(1 - d) / n`.
        base = torch.div(torch.tensor(1.0 - damping, dtype=torch.float32,
                                      device=n.device), n)
        score = base.view(-1, 1, 1) + damping * acc
        return {"score": score.to(torch.float32), "num_vertices": n}

    return GasKernel(
        name="pagerank", init_state=init_state, apply=apply, scatter=scatter,
        gather=gather, combiner="add", msg_dtype=torch.float32,
        max_supersteps=num_supersteps, update_bits=32, message_bits=32)


# ---------------------------------------------------------------------------
# SSSP — beyond-paper. Message key = candidate distance (min-combined);
# the parent pointer travels as an argmin carry (engine resolves the min
# sender id among the winning distances — deterministic, 32-bit payloads).
# ---------------------------------------------------------------------------

def sssp(root: int = 0) -> GasKernel:
    def init_state(vert_gid, out_deg, valid, *, root=root, **_):
        root = torch.as_tensor(root, dtype=torch.int32,
                               device=vert_gid.device)
        is_root = vert_gid == root
        dist = torch.where(is_root, 0.0, float("inf")).to(torch.float32)
        return {
            "dist": dist,
            "parent": torch.where(is_root, root, -1).to(torch.int32),
            "active": is_root & valid,
        }

    def apply(state, vert_gid, out_deg, superstep):
        payload = state["dist"]
        active = state["active"]
        st = dict(state)
        st["active"] = torch.zeros_like(active)
        return st, payload, active

    def scatter(payload, weight, src_gid, src_outdeg):
        return payload + weight

    def scatter_carry(payload, weight, src_gid, src_outdeg):
        return src_gid

    def gather(state, combined, carry, got, superstep):
        better = got & (combined < state["dist"])
        return {
            "dist": torch.where(better, combined, state["dist"]),
            "parent": torch.where(better, carry, state["parent"]),
            "active": state["active"] | better,
        }

    return GasKernel(
        name="sssp", init_state=init_state, apply=apply, scatter=scatter,
        gather=gather, combiner="min", msg_dtype=torch.float32,
        carry_dtype=torch.int32, scatter_carry=scatter_carry,
        update_bits=32, message_bits=64, query_params=("root",))


# ---------------------------------------------------------------------------
# Degree centrality — single-superstep sanity workload.
# ---------------------------------------------------------------------------

def degree_centrality() -> GasKernel:
    def init_state(vert_gid, out_deg, valid, **_):
        return {"indeg": torch.zeros(vert_gid.shape, dtype=torch.float32,
                                     device=vert_gid.device),
                "done": torch.zeros(vert_gid.shape, dtype=torch.bool,
                                    device=vert_gid.device)}

    def apply(state, vert_gid, out_deg, superstep):
        active = _per_query(superstep == 0, vert_gid.shape)
        payload = torch.ones(vert_gid.shape, dtype=torch.float32,
                             device=vert_gid.device)
        return state, payload, active

    def scatter(payload, weight, src_gid, src_outdeg):
        return payload

    def gather(state, combined, got, superstep):
        return {"indeg": torch.where(got, combined, state["indeg"]),
                "done": state["done"] | got}

    return GasKernel(
        name="degree", init_state=init_state, apply=apply, scatter=scatter,
        gather=gather, combiner="add", msg_dtype=torch.float32,
        max_supersteps=1, update_bits=32, message_bits=32)


ALGORITHMS = {
    "bfs": bfs,
    "wcc": wcc,
    "pagerank": pagerank,
    "sssp": sssp,
    "degree": degree_centrality,
}
