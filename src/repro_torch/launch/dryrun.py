"""The graph cell of the multi-pod dry-run, on PyTorch's ``meta`` device
(the port's counterpart of ``repro.launch.dryrun.run_graph_cell``: the
paper's own technique at pod scale).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --graph \\
        --exchange allgather [--multi-pod] [--algo wcc] [--out DIR]

A ``ShardEngine`` over an analytic :class:`ShardMeta` (graph500 R-MAT,
scale 26, edge factor 16, on a mesh of 256 shards, or 512 with
``--multi-pod``) runs one synchronous superstep (deliver, gather, apply)
on ``meta`` tensors, which carry shapes and dtypes and allocate nothing,
so the cell needs no card and runs on the CPU too. It records:

  memory       argument bytes per shard (the shard data, payload, active
               bit and state: the counterpart of XLA's
               ``argument_size_in_bytes``) and the sum of the bytes of
               every tensor the superstep creates, per shard (an upper
               bound on its working set: nothing is counted as freed; the
               counterpart of ``temp_size_in_bytes``);
  collectives  each mesh collective the superstep calls, and its wire
               bytes per shard under the ring-cost factors the JAX
               dry-run applies to the compiled HLO;
  words        ``perfmodel.words_per_superstep`` at the meta's padded
               layout values, which the engine's wire-word count equals
               (but where 2 x comb_max exceeds e_pair_max: the model
               clamps the combined exchange at unicast's per-edge words,
               the engine counts its comb_max slots a pair);
  roofline     ``perfmodel.limits`` on the measured ``H100`` profile at
               ``n_nodes = P``: L_PE and L_mem, and ``teps_bound`` = T_sys.
               No multi-card wire has been measured, so L_if and L_net
               are reported as not bounded.

The frontier exchange reads its frontier sizes on the host each
superstep; on ``meta`` there is nothing to read, and the cell takes the
largest capacity bucket, the most a superstep can move (what the JAX
engine's ``lax.switch`` traces too). The engine runs ``backend="ref"``,
as the JAX dry-run does: the kernel's work list is built on the host from
real data. The JAX dry-run's LM cells are not ported.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core import algorithms as ALG
from ..core import perfmodel
from ..core.engine_shardmap import ShardEngine, ShardMeta, abstract_shard_data
from ..core.mesh import LocalMesh
from ..core.stepper import tree_nbytes

__all__ = ["CollectiveRecorder", "graph_meta", "run_graph_cell",
           "superstep_cell"]


def graph_meta(P: int, scale: int = 26, edge_factor: int = 16) -> ShardMeta:
    """The analytic layout of the JAX dry-run's graph cell: uniform
    shards of ``V = 2**scale`` vertices padded to 256, ``e_pair_max`` at
    4x headroom over ``E/P**2`` (padded to 32), tiles of 512 lanes and
    windows of 256 rows, frontier buckets of Vm/16, Vm/4 and Vm. The
    combined exchange's lanes, which the JAX cell leaves empty
    (``comb_max = 0``), are sized here: ``comb_max`` is the expected
    number of distinct destinations of ``e_pair_max`` edges thrown at
    ``v_max`` vertices (``perfmodel.words_per_superstep``'s estimate),
    padded to 32, over every edge of a shard."""
    V = 1 << scale
    E = edge_factor * V
    v_max = -(-V // P // 256) * 256
    e_pair = -(-E // (P * P) // 32) * 32 * 4
    distinct = v_max * (1.0 - (1.0 - 1.0 / v_max) ** e_pair)
    comb_max = -(-math.ceil(distinct) // 32) * 32
    n_tiles = -(-(E // P) // 512)
    return ShardMeta(P=P, v_max=v_max, e_pair_max=e_pair, n_tiles=n_tiles,
                     n_windows=-(-(v_max + 1) // 256), tile_e=512,
                     tile_r=256, num_vertices=V,
                     frontier_capacities=(v_max // 16, v_max // 4, v_max),
                     comb_max=comb_max, comb_tiles=n_tiles,
                     comb_windows=-(-(P * (comb_max + 1)) // 256))


class CollectiveRecorder:
    """A mesh that runs its wrapped mesh's collectives and records each
    call: ``calls[op]`` and ``wire_bytes[op]``, the bytes one shard puts
    on the wire, by the ring-cost factors of the JAX dry-run's
    ``parse_collectives`` (all-gather: block x (P-1); all-to-all: send
    buffer x (P-1)/P; collective-permute: the block; all-reduce:
    2 x operand x (P-1)/P). Every other attribute is the wrapped
    mesh's."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.calls: Dict[str, int] = {}
        self.wire_bytes: Dict[str, float] = {}

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def _note(self, op: str, nbytes: float) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.wire_bytes[op] = self.wire_bytes.get(op, 0.0) + nbytes

    def _block(self, x: torch.Tensor) -> float:
        """Bytes of one shard's block of a (B, S, ...) tensor."""
        S = self._mesh.shards.stop - self._mesh.shards.start
        return x.numel() * x.element_size() / S

    def all_gather(self, x):
        self._note("all-gather", self._block(x) * (self.num_shards - 1))
        return self._mesh.all_gather(x)

    def all_to_all(self, x):
        return self.all_to_all_async(x).wait()

    def all_to_all_async(self, x):
        P = self.num_shards
        self._note("all-to-all", self._block(x) * (P - 1) / P)
        return self._mesh.all_to_all_async(x)

    def ppermute(self, x):
        return self.ppermute_async(x).wait()

    def ppermute_async(self, x):
        self._note("collective-permute", self._block(x))
        return self._mesh.ppermute_async(x)

    def _reduce(self, op, x, dim):
        # each process all-reduces its shards' reduced value
        out = getattr(self._mesh, op)(x, dim)
        P = self.num_shards
        self._note("all-reduce",
                   2 * out.numel() * out.element_size() * (P - 1) / P)
        return out

    def pmax(self, x, dim=None):
        return self._reduce("pmax", x, dim)

    def psum(self, x, dim=None):
        return self._reduce("psum", x, dim)


class _CreatedBytes(TorchDispatchMode):
    """Sums the bytes of every tensor an operator creates: each output
    that aliases no input (views and in-place results are not new
    memory)."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        returns = func._schema.returns
        for i, t in enumerate(tree_leaves(out)):
            if (isinstance(t, torch.Tensor)
                    and (i >= len(returns) or returns[i].alias_info is None)):
                self.nbytes += t.numel() * t.element_size()
        return out


def superstep_cell(meta: ShardMeta, exchange: str, algo: str = "wcc",
                   data=None, mesh=None) -> Dict:
    """One superstep of ``algo`` over ``exchange`` at ``meta``'s layout:
    argument and created bytes per shard, the collectives with their
    wire bytes per shard, and ``perfmodel.words_per_superstep`` at the
    layout's padded values. ``data`` defaults to
    ``abstract_shard_data(meta, exchange)`` and ``mesh`` to
    ``LocalMesh(P, "meta")``; a real engine's device data and mesh give
    the same records for one real superstep."""
    P = meta.P
    kernel = ALG.ALGORITHMS[algo]()
    rec = CollectiveRecorder(LocalMesh(P, "meta") if mesh is None else mesh)
    eng = ShardEngine(kernel, meta, mesh=rec, exchange=exchange,
                      backend="ref", tile_e=meta.tile_e, tile_r=meta.tile_r)
    if data is None:
        data = abstract_shard_data(meta, exchange)
    # the superstep's inputs: the carry after init and superstep 0's apply
    carry = eng._prog_for(False).init_carry(data, eng.params, {}, 1)
    rec.calls.clear()
    rec.wire_bytes.clear()
    step = eng.superstep_fn()
    created = _CreatedBytes()
    t0 = time.perf_counter()
    with created:
        step(data, carry.payload, carry.active, carry.state, carry.superstep)
    host_s = time.perf_counter() - t0
    data_bytes = tree_nbytes(data)
    args = (data_bytes + tree_nbytes(carry.state)
            + tree_nbytes((carry.payload, carry.active, carry.superstep)))
    # every shape argument is given, so the workload's edges go unread
    words = perfmodel.words_per_superstep(
        exchange, perfmodel.Workload(meta.num_vertices, 0), P,
        v_max=meta.v_max, e_pair_max=meta.e_pair_max,
        remote_dst_max=meta.comb_max,
        frontier_cap=(meta.frontier_capacities[-1]
                      if meta.frontier_capacities else None))
    return {
        "memory": {"data_bytes": data_bytes / P,
                   "argument_bytes": args / P,
                   "temp_bytes": created.nbytes / P},
        "collectives": {
            **{op: {"calls": rec.calls[op],
                    "wire_bytes": rec.wire_bytes[op]}
               for op in sorted(rec.calls)},
            "total_wire_bytes": sum(rec.wire_bytes.values())},
        "words_per_superstep": words,
        "operators": created.ops,
        "host_s": host_s,
    }


def run_graph_cell(exchange: str, multi_pod: bool = False,
                   algo: str = "wcc", outdir: Optional[str] = None,
                   scale: int = 26, edge_factor: int = 16) -> Dict:
    """The graph cell: one superstep at pod scale on ``meta`` tensors,
    bounded by the measured ``H100`` profile; written to
    ``outdir/graph__{algo}__{exchange}__{mesh}.json`` when given."""
    P = 512 if multi_pod else 256
    mesh_name = "multipod_512" if multi_pod else "pod_256"
    meta = graph_meta(P, scale, edge_factor)
    V = meta.num_vertices
    E = edge_factor * V
    cell = {"arch": f"gravfm-{algo}-{exchange}", "shape": f"rmat{scale}",
            "mesh": mesh_name, "device": "meta",
            "meta": {k: getattr(meta, k) for k in meta.__dataclass_fields__}}
    cell.update(superstep_cell(meta, exchange, algo))
    lim = perfmodel.limits(
        perfmodel.H100, perfmodel.H100_ALGOS[algo],
        perfmodel.Workload(V, E), n_nodes=P, exchange=exchange,
        v_max=meta.v_max, e_pair_max=meta.e_pair_max,
        remote_dst_max=meta.comb_max,
        frontier_cap=meta.frontier_capacities[-1])
    cell.update(
        status="ok", platform=perfmodel.H100.name,
        edges_per_superstep=E,
        roofline={"L_PE": lim["L_PE"], "L_mem": lim["L_mem"],
                  "L_if": "not bounded", "L_net": "not bounded",
                  "T_sys": lim["T_sys"], "bottleneck": lim["bottleneck"]},
        teps_bound=lim["T_sys"])
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(
                outdir, f"graph__{algo}__{exchange}__{mesh_name}.json"),
                "w") as f:
            json.dump(cell, f, indent=1)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--graph", action="store_true", required=True,
                    help="the graph cell (the only cell ported)")
    ap.add_argument("--exchange", default="allgather",
                    choices=perfmodel.EXCHANGES)
    ap.add_argument("--multi-pod", action="store_true",
                    help="512 shards instead of 256")
    ap.add_argument("--algo", default="wcc",
                    choices=sorted(perfmodel.H100_ALGOS))
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    cell = run_graph_cell(args.exchange, args.multi_pod, args.algo,
                          args.out)
    mem, coll = cell["memory"], cell["collectives"]
    print(f"[ok] {cell['arch']} {cell['shape']} {cell['mesh']}"
          f" argument_bytes/shard={mem['argument_bytes']:.6g}"
          f" temp_bytes/shard={mem['temp_bytes']:.6g}"
          f" wire_bytes/shard={coll['total_wire_bytes']:.6g}"
          f" words/superstep={cell['words_per_superstep']['total']:.6g}"
          f" teps_bound={cell['teps_bound']:.6g}"
          f" ({cell['roofline']['bottleneck']}; L_if, L_net not bounded)"
          f" host_s={cell['host_s']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
