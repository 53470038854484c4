"""The multi-pod dry-run on PyTorch's ``meta`` device (the port of
``repro.launch.dryrun``): every (architecture x input shape x mesh) LM
cell on the production meshes, and the graph cell (the paper's own
technique at pod scale).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --graph \
        --exchange allgather [--multi-pod] [--algo wcc] [--out DIR]

``meta`` tensors carry shapes and dtypes and allocate nothing, so a cell
needs no card and runs on the CPU too. A failed cell (a sharding
mismatch, an operator ``meta`` cannot run) makes the run exit nonzero.

**LM cells** (``run_cell``). A process group of the mesh's 256 or 512
ranks runs in this one process over torch's ``fake`` backend
(``launch.mesh.dryrun_world``), and the step runs as the mesh's rank 0
on DTensors whose local blocks are ``meta`` tensors: the params and
AdamW state placed by ``sharding.param_sharding_rules``, the batch over
the batch axes, the serving cache by ``lm.cache_axes``. The train step
is ``make_train_step`` with the reference's microbatching (16 on one
pod, 8 on two), prefill is ``lm_forward`` (``encode`` then
``decode_train`` for the enc-dec) with the cache and the last logits,
decode one ``lm_decode_step`` (``encdec_decode_step``). A dispatch mode
(:class:`StepCost`) sees every operator the rank runs on its local
blocks (DTensor's own operators are left to DTensor, whose local
operators and collectives come back through the mode), so every count is
per device, work replicated over a mesh axis included. It records:

  memory       ``argument_bytes``: the local blocks of the params,
               optimizer state, batch and cache, exact; ``peak_live_bytes``:
               the most bytes of tensors the step created that were alive
               at once (each operator's new outputs counted when made and
               released when freed); ``peak_estimate_bytes`` = the two
               summed, against 80e9 B a card for ``fits_hbm``;
               ``temp_bytes``: every created tensor's bytes, nothing freed
               (the graph cell's upper bound).
  cost         ``flops``: the FLOPs of the rank's matrix products
               (``torch.utils.flop_counter``'s formulas); ``bytes
               accessed``: every non-view operator's inputs read and
               outputs written (unfused: an upper bound).
  collectives  every collective the rank issues (``_c10d_functional``
               and ``c10d``): calls, result bytes, and wire bytes by
               ``roofline.ring_wire_bytes`` at the op's group size.
  roofline     ``roofline.roofline`` at the card's data-sheet rates
               (``roofline.H100``), and again at the measured stream rate
               (``roofline_stream``).

XLA's cost pass counts a rolled scan once, so the reference extrapolates
from depths 2 and 4. The port's step is eager; it runs the cost pass at
depths 1 and 2 of the block pattern (``repeats``; both stacks of the
enc-dec) and extrapolates linearly to the full depth (every repeat has
the same shapes, so each count is affine in depth); a train step of more
than 3 microbatches runs 2 and 3 of its chunks. The mLSTM and sLSTM loop
once a token; for a config with either, each loop runs 2 and then 4
timesteps of the full sequence (``recurrence_steps``), and the counts
extrapolate to every timestep. ``argument_bytes`` is exact at full size;
the live peak is the same extrapolation, an estimate.

**The graph cell** (``run_graph_cell``). A ``ShardEngine`` over an
analytic :class:`ShardMeta` (graph500 R-MAT, scale 26, edge factor 16,
on a mesh of 256 shards, or 512 with ``--multi-pod``) runs one
synchronous superstep (deliver, gather, apply). It records:

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
real data.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .. import configs
from .. import sharding as SH
from ..configs.common import (ENC_LEN_CAP, SHAPES, input_specs,
                              shape_applicable)
from ..core import algorithms as ALG
from ..core import perfmodel
from ..core.engine_shardmap import ShardEngine, ShardMeta, abstract_shard_data
from ..core.mesh import LocalMesh
from ..core.stepper import tree_nbytes
from ..models import encdec as ED
from ..models import layers as L
from ..models import lm as LM
from ..models import ssm as SSM
from ..train.loop import make_train_step
from ..train.optimizer import AdamWConfig, adamw_init
from . import roofline as RL
from .mesh import PRODUCTION, dryrun_world, make_production_mesh

__all__ = ["CollectiveRecorder", "graph_meta", "run_graph_cell",
           "superstep_cell", "StepCost", "active_param_count",
           "build_lowerable", "argument_bytes", "step_costs",
           "extrapolated_costs", "recurrence_steps", "run_cell",
           "HBM_PER_CARD"]


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


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

HBM_PER_CARD = RL.H100.hbm_bytes      # the card's 80 GB (not v5e's 16 GB)
COST_DEPTHS = (1, 2)                  # repeats of the cost passes
COST_STEPS = (2, 4)                   # timesteps an xLSTM loop runs
COST_CHUNKS = (2, 3)                  # microbatch chunks of a train step
_RECURRENT = ("mlstm", "slstm")       # mixers that loop once a token


def _spec(cfg):
    if cfg.family == "encdec":
        return ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
    return LM.lm_spec(cfg)


def _abstract_params(cfg, mesh):
    """(the params as ``meta`` DTensors placed by the rules, the spec)."""
    spec = _spec(cfg)
    abstract = L.abstract_params(spec)
    return SH.place_tree(mesh, abstract, SH.param_sharding_rules(
        mesh, abstract, L.axes_tree(spec))), spec


def active_param_count(cfg) -> int:
    """Total params, with routed experts scaled by topk/n_routed."""
    total = 0
    for keys, s in L._leaves(_spec(cfg)):
        n = math.prod(s.shape)
        if cfg.moe and any(k.startswith("we_") for k in keys):
            n = n * cfg.moe.topk // cfg.moe.n_routed
        total += n
    return total


def _batch_sharded(cfg, mesh, shape):
    """The step's data inputs as ``meta`` DTensors over the batch axes; a
    scalar (decode's position) stays a plain tensor, as serving passes
    it."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        out[k] = v if v.ndim == 0 else SH.place(
            mesh, v, SH.batch_spec(mesh, v.shape))
    return out


def _abstract_cache(cfg, shape):
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        args = (cfg, cfg.n_dec, B, S, min(S, ENC_LEN_CAP))
        return ED.abstract_encdec_cache(*args), ED.encdec_cache_axes(*args)
    return LM.abstract_cache(cfg, B, S), LM.cache_axes(cfg, B, S)


def _cache_sharded(cfg, mesh, shape):
    """The serving cache as ``meta`` DTensors: batch over the batch axes,
    the KV sequence over "model", or over every axis where the batch
    does not fill the batch axes (the reference's choice)."""
    B = shape.global_batch
    dp = SH.axis_size(mesh, SH.batch_axes(mesh)) if SH.batch_axes(mesh) \
        else 1
    seq_ax = "kv_seq_model" if B % max(dp, 1) == 0 and B >= dp \
        else "kv_seq_pdm"
    abstract, axes = _abstract_cache(cfg, shape)
    axes = L.tree_map(lambda a: a.replace("kv_seq_model", seq_ax), axes)
    return SH.place_tree(mesh, abstract, SH.param_sharding_rules(
        mesh, abstract, axes))


def build_lowerable(cfg, mesh, shape, *, microbatch: int = 8):
    """(the step, its arguments): ``meta`` DTensors on ``mesh`` for the
    params, AdamW state and cache, the batch over the batch axes. The
    train step takes the whole batch as ``meta`` tensors and shards it
    itself (``make_train_step``), with ``microbatch`` chunks."""
    params, _ = _abstract_params(cfg, mesh)
    if shape.kind == "train":
        step_fn = make_train_step(cfg, AdamWConfig(), mesh,
                                  microbatch=microbatch)
        return step_fn, (params, adamw_init(params),
                         input_specs(cfg, shape), 0)
    batch = _batch_sharded(cfg, mesh, shape)
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            def prefill(params, batch):
                enc = ED.encode(params, batch["frames"], cfg, mesh)
                return ED.decode_train(params, enc, batch["tokens"], cfg,
                                       mesh=mesh, last_only=True)
        elif cfg.family == "vlm":
            def prefill(params, batch):
                return LM.lm_forward(
                    params, batch["tokens"], cfg, mesh=mesh,
                    prefix_embeds=batch["patch_embeds"], return_cache=True,
                    last_only=True)
        else:
            def prefill(params, batch):
                return LM.lm_forward(params, batch["tokens"], cfg,
                                     mesh=mesh, return_cache=True,
                                     last_only=True)
        return prefill, (params, batch)
    cache = _cache_sharded(cfg, mesh, shape)
    if cfg.family == "encdec":
        def decode(params, cache, batch):
            return ED.encdec_decode_step(params, cache, batch["tokens"],
                                         batch["pos"], cfg, mesh)
    else:
        def decode(params, cache, batch):
            return LM.lm_decode_step(params, cache, batch["tokens"],
                                     batch["pos"], cfg, mesh=mesh)
    return decode, (params, cache, batch)


# the collectives a step issues -> the ring-cost op: DTensor's
# functional ones, and c10d's all-reduce (the split decode attention)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "allreduce_": "all-reduce",
}


def _tensors(items) -> list:
    """The tensors among ``items`` and in their lists."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The size of the group a collective's arguments name (the
    functional ops' group name, or c10d's process group)."""
    from torch.distributed import distributed_c10d as c10d
    names = [a for a in args if isinstance(a, str)]
    if names:                    # the functional ops' last string
        return c10d._resolve_process_group(names[-1]).size()
    for a in args:                 # c10d's ops: the group, boxed
        if isinstance(a, torch.ScriptObject):
            return torch.distributed.ProcessGroup.unbox(a).size()
    raise ValueError("a collective without a group")


class StepCost(TorchDispatchMode):
    """The per-device costs of the operators a rank runs on plain tensors
    (its local blocks): an operator with a DTensor argument is left to
    DTensor (``NotImplemented``), whose local operators and collectives
    come back through this mode; DTensor's shape propagation (run under
    a fake mode, on global shapes) is not counted.

    ``flops``: matrix-product FLOPs; ``bytes_accessed``: each non-view
    operator's tensor inputs and outputs; ``created``: the bytes of every
    new output (one whose storage no input has); ``live`` / ``peak_live``:
    those bytes while the tensors are alive, and their most;
    ``collectives[op]``: calls, result bytes and ring wire bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.created = 0
        self.live = 0
        self.peak_live = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        returns = func._schema.returns
        view = bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns)
        if not view:
            self.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                    + sum(_nbytes(t) for t in outs))
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held:
                continue
            held.add(st._cdata)
            n = st.nbytes()
            self.created += n
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_live = max(self.peak_live, self.live)
        op = _COLLECTIVE_OPS.get(packet.__name__.removesuffix("_coalesced"))
        if op is not None:
            nbytes = sum(_nbytes(t) for t in outs)
            p = _group_size(list(args) + list(kwargs.values()))
            rec = self.collectives.setdefault(
                op, {"calls": 0, "bytes": 0.0, "wire_bytes": 0.0})
            rec["calls"] += 1
            rec["bytes"] += nbytes
            rec["wire_bytes"] += RL.ring_wire_bytes(op, nbytes, p)
        return out

    def counts(self) -> Dict[str, float]:
        """The counts as one flat dict (each collective's as
        ``op/calls``, ``op/bytes``, ``op/wire_bytes``)."""
        out = {"flops": self.flops, "bytes": self.bytes_accessed,
               "created": self.created, "peak_live": self.peak_live,
               "ops": self.ops,
               "wire": sum(r["wire_bytes"]
                           for r in self.collectives.values())}
        for op, rec in self.collectives.items():
            for k, v in rec.items():
                out[f"{op}/{k}"] = v
        return out


def _tree_local_bytes(tree) -> int:
    """The bytes of the local blocks of a tree's tensors (a DTensor's
    block, a plain tensor whole)."""
    leaves = [t for t in tree_leaves(tree, is_leaf=SH.is_dtensor)
              if isinstance(t, torch.Tensor)]
    return sum(_nbytes(t.to_local() if SH.is_dtensor(t) else t)
               for t in leaves)


def argument_bytes(cfg, mesh, shape, args) -> int:
    """The step's arguments' local blocks: params, optimizer state and
    cache as placed, the batch as sharded over the batch axes."""
    batch_at = 2 if shape.kind in ("train", "decode") else 1
    return (sum(_tree_local_bytes(a) for i, a in enumerate(args)
                if i != batch_at)
            + _tree_local_bytes(_batch_sharded(cfg, mesh, shape)))


def step_costs(cfg, mesh, shape, microbatch: int = 1) -> Dict[str, float]:
    """One step of (cfg, shape) on ``mesh`` under :class:`StepCost`: its
    counts, and the host seconds it took."""
    fn, args = build_lowerable(cfg, mesh, shape, microbatch=microbatch)
    cost = StepCost()
    t0 = time.perf_counter()
    with cost:
        out = fn(*args)
        del out
    host_s = time.perf_counter() - t0
    del fn, args
    return dict(cost.counts(), host_s=host_s)


def _depth_cfg(cfg, r: int):
    kw = {"repeats": r}
    if cfg.family == "encdec":
        kw.update(n_enc=r, n_dec=r)
    return dataclasses.replace(cfg, **kw)


def full_depth(cfg) -> int:
    return cfg.n_enc if cfg.family == "encdec" else cfg.repeats


def recurrent(cfg) -> bool:
    """The config has a mixer that loops once a token."""
    return any(k.mixer in _RECURRENT for k in cfg.block_pattern + cfg.tail)


@contextlib.contextmanager
def recurrence_steps(steps: int):
    """Within: each mLSTM and sLSTM loop runs its first ``steps``
    timesteps only, its output zero-padded back to the sequence. Every
    other operator of the step runs at the full sequence (DTensor picks
    its strategies by the shapes it meets, so a shorter sequence would
    change them); the loop's counts are affine in ``steps``."""
    saved = SSM._mlstm_steps, SSM._slstm_steps

    def cut(h, S):
        return F.pad(h, (0, 0, 0, S - h.shape[1]))

    def mlstm(carry, q, k, v, i_pre, f_pre):
        if SH.is_dtensor(q):              # its region calls back here
            return saved[0](carry, q, k, v, i_pre, f_pre)
        h, carry = saved[0](carry, *(a[:, :steps]
                                     for a in (q, k, v, i_pre, f_pre)))
        return cut(h, q.shape[1]), carry

    def slstm(p, state, gx, n_heads):
        if SH.is_dtensor(gx):
            return saved[1](p, state, gx, n_heads)
        h, state = saved[1](p, state, gx[:, :steps], n_heads)
        return cut(h, gx.shape[1]), state

    SSM._mlstm_steps, SSM._slstm_steps = mlstm, slstm
    try:
        yield
    finally:
        SSM._mlstm_steps, SSM._slstm_steps = saved


def _affine(a: Dict, b: Dict, x1: float, x2: float, x: float,
            keep=()) -> Dict:
    """Each count at ``x`` on the line through ``a`` (at x1) and ``b``
    (at x2); a count one of them lacks is 0 there. A count named in
    ``keep`` is ``b``'s."""
    out = {}
    for k in set(a) | set(b):
        va, vb = a.get(k, 0.0), b.get(k, 0.0)
        out[k] = vb if k in keep else va + (vb - va) * (x - x1) / (x2 - x1)
    return out


def extrapolated_costs(cfg, mesh, shape, microbatch: int = 1, *,
                       depths=COST_DEPTHS, steps=COST_STEPS,
                       chunks=COST_CHUNKS) -> Dict:
    """The step's counts at full size from cost passes at two depths
    (repeats); for a recurrent config that is not decoding, with its
    loops cut to two counts of timesteps each (``recurrence_steps``);
    for a train step of more microbatches than ``chunks``' largest, at
    two counts of its microbatch chunks each (every chunk the step's
    shape). Every count is affine in each of the three; the live peak is
    the last chunk count's (a chunk after the first adds the same), and
    extrapolated in depth and timesteps (an estimate). ``host_s``: the
    passes' seconds."""
    full_r, S = full_depth(cfg), shape.seq_len
    rs = tuple(min(d, full_r) for d in depths)
    loops = recurrent(cfg) and shape.kind != "decode" and S > max(steps)
    ts = steps if loops else (S,)
    ks = chunks if microbatch > max(chunks) else (microbatch,)
    host = []

    def run(r, t, k):
        sh = dataclasses.replace(
            shape, global_batch=shape.global_batch // microbatch * k)
        with recurrence_steps(t) if loops else contextlib.nullcontext():
            c = step_costs(_depth_cfg(cfg, r), mesh, sh, k)
        host.append(c.pop("host_s"))
        return c

    def over(points, full, f, keep=()):
        if len(set(points)) == 1:
            return f(points[0])
        return _affine(f(points[0]), f(points[1]), *points, full, keep)

    out = over(rs, full_r, lambda r: over(
        ts, S, lambda t: over(ks, microbatch, lambda k: run(r, t, k),
                              keep=("peak_live",))))
    out["host_s"] = sum(host)
    return out


def _tokens(shape) -> int:
    return shape.global_batch * (shape.seq_len
                                 if shape.kind != "decode" else 1)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             outdir: Optional[str] = None, *, microbatch: int = 0,
             overrides: Optional[Dict] = None,
             reduced: bool = False) -> Dict:
    """One LM cell on the production mesh (``multi_pod``: (2, 16, 16)),
    in a world of its ranks (``launch.mesh.dryrun_world``): its
    arguments' bytes at full size, the step's costs extrapolated to full
    depth, the live peak, the collectives and the roofline; written to
    ``outdir/{arch}__{shape}__{mesh}.json`` when given. A shape the
    config does not run is ``skipped`` with the reason. ``reduced``: the
    config's reduced widths (tests)."""
    cfg = dataclasses.replace(configs.get(arch, reduced=reduced),
                              **(overrides or {}))
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "device": "meta"}
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_dev = mesh.size()
    if microbatch == 0:
        microbatch = 8 if multi_pod else 16
    mb = microbatch if shape.kind == "train" else 1
    t0 = time.perf_counter()
    fn, args = build_lowerable(cfg, mesh, shape, microbatch=mb)
    arg_bytes = argument_bytes(cfg, mesh, shape, args)
    del fn, args
    cost = extrapolated_costs(cfg, mesh, shape, mb)
    host_s = time.perf_counter() - t0
    peak = arg_bytes + cost["peak_live"]
    mem = {"argument_bytes": arg_bytes,
           "peak_live_bytes": cost["peak_live"],
           "peak_estimate_bytes": peak,
           "temp_bytes": cost["created"]}
    ops = sorted({k.split("/")[0] for k in cost if "/" in k})
    colls = {op: {k: cost[f"{op}/{k}"]
                  for k in ("calls", "bytes", "wire_bytes")} for op in ops}
    colls["total_wire_bytes"] = cost["wire"]
    dp = SH.axis_size(mesh, SH.batch_axes(mesh))
    tp = SH.axis_size(mesh, "model")
    n_layers = (cfg.n_enc + cfg.n_dec if cfg.family == "encdec"
                else cfg.n_layers)
    cache_dev = 0.0
    if shape.kind == "decode":
        cache_dev = _tree_local_bytes(_abstract_cache(cfg, shape)[0]) / n_dev
    active = active_param_count(cfg)
    ana = RL.analytic_hbm_bytes(
        n_params=L.param_count(_spec(cfg)), n_params_active=active,
        tokens=_tokens(shape), d_model=cfg.d_model, n_layers=n_layers,
        vocab=cfg.vocab_padded, n_dev=n_dev, dp=dp, tp=tp, kind=shape.kind,
        microbatch=mb, cache_bytes_per_dev=cache_dev)
    costs = {"flops": cost["flops"], "bytes accessed": cost["bytes"]}
    rf_args = dict(n_devices=n_dev, tokens=_tokens(shape),
                   n_params_active=active, kind=shape.kind,
                   analytic_bytes=ana)
    cell.update(
        status="ok", host_s=round(host_s, 3),
        cost_host_s=round(cost["host_s"], 3), microbatch=mb,
        cost_depths=[min(d, full_depth(cfg)) for d in COST_DEPTHS],
        cost_steps=(list(COST_STEPS) if recurrent(cfg)
                    and shape.kind != "decode" else None),
        cost_chunks=list(COST_CHUNKS) if mb > max(COST_CHUNKS) else None,
        memory=mem, fits_hbm=bool(peak < HBM_PER_CARD),
        operators=cost["ops"], collectives=colls,
        roofline=RL.roofline(costs, colls, hw=RL.H100, **rf_args),
        roofline_stream=RL.roofline(costs, colls, hw=RL.H100_STREAM,
                                    **rf_args),
        hardware={"roofline": RL.H100.name,
                  "roofline_stream": RL.H100_STREAM.name})
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(cell, f, indent=1)
    return cell


def _summary(cell) -> str:
    s = cell.get("status")
    extra = ""
    if s == "ok":
        rf = cell["roofline"]
        extra = (f" bound={rf['bound_by']}"
                 f" step={rf['roofline_step_s']:.4g}s"
                 f" compute={rf['t_compute_s']:.4g}s"
                 f" memory={rf['t_memory_s']:.4g}s"
                 f" collective={rf['t_collective_s']:.4g}s"
                 f" peak={cell['memory']['peak_estimate_bytes']:.4g}B"
                 f" fits={cell['fits_hbm']} host={cell['host_s']}s")
    elif s == "skipped":
        extra = " " + cell["reason"]
    else:
        extra = " " + cell.get("error", "")
    return (f"[{s:7s}] {cell['arch']:22s} {cell['shape']:12s}"
            f" {cell['mesh']:18s}{extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="the graph cell instead of the LM cells")
    ap.add_argument("--exchange", default="allgather",
                    choices=perfmodel.EXCHANGES)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the graph cell: 512 shards instead of 256")
    ap.add_argument("--algo", default="wcc",
                    choices=sorted(perfmodel.H100_ALGOS))
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.graph:
        return _graph_main(args)
    archs = (configs.ARCH_IDS if (args.all or not args.arch)
             else [args.arch])
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results, failures = [], 0
    for mp in meshes:
        with dryrun_world(math.prod(PRODUCTION[mp][0])):
            for arch in archs:
                for shape in shapes:
                    try:
                        cell = run_cell(arch, shape, mp, args.out)
                    except Exception as e:  # a failed cell fails the run
                        traceback.print_exc()
                        cell = {"arch": arch, "shape": shape,
                                "mesh": ("multipod_2x16x16" if mp
                                         else "pod_16x16"),
                                "status": "FAILED",
                                "error": f"{type(e).__name__}: "
                                         f"{str(e)[:500]}"}
                        failures += 1
                    results.append(cell)
                    print(_summary(cell), flush=True)
    os.makedirs(args.out, exist_ok=True)
    summary = os.path.join(args.out, "summary.json")
    with open(summary, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {summary}; failures={failures}", flush=True)
    return 1 if failures else 0


def _graph_main(args) -> int:
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
