"""The GraVF-M superstep engine on one device, in PyTorch (twin of
``repro.core.engine``), in both of the paper's architectures:

  mode="gravfm"  — apply emits ≤1 update per vertex; the per-shard update
                   arrays are broadcast (a gather over ``src_slot``);
                   scatter runs at the RECEIVER against its
                   destination-partitioned edge list, and the messages are
                   folded per destination by the segment-combine kernel.
  mode="gravf"   — the baseline: scatter runs at the SOURCE shard and the
                   per-edge messages are exchanged shard to shard (an
                   axis transpose of the (P, P, E_pair) pair arrays).

The engine is a global-array program with an explicit leading shard axis
``P`` (all shards on one device, as the JAX engine runs them on one
device) and a leading query axis ``B`` (one for :meth:`Engine.run`, B for
:meth:`Engine.run_batch`, W lanes for a :class:`LaneStepper`).

``backend="kernel"`` lays the edges out into kernel lanes and combines
through :func:`repro_torch.kernels.ops.segment_combine_layout` (the CUDA
kernel on the card, its plain version on the CPU); ``backend="ref"``
combines with the ``scatter_reduce_`` oracle over the unpadded CSC.

The graph data can be demoted to host copies (:meth:`Engine.offload`,
the graph store's spill tier) and promoted back (:meth:`Engine.upload`);
an offloaded engine stages its data to its device for each call, so it
never computes anywhere else. :attr:`Engine.traces` counts the first run
of each program at each shape, where JAX counts compilations.

On the card, with its data resident, :meth:`Engine.run` and
:meth:`Engine.run_batch` run from CUDA graphs of the init and of one
superstep, one pair per batch size and set of query parameters
(:class:`~repro_torch.core.stepper.SuperstepGraph`); a pair holds a carry
between calls, and every pair of the process keeps its intermediates in
one pool, the size of the largest superstep's. On the CPU, while
offloaded, or while another call holds that graph, a call runs the eager
loop, with bit-identical results, and so does :meth:`Engine.run_eager`,
which holds nothing between calls: the service's plans call it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..convert import state_to_numpy
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.layout import DeviceLayout
from . import obs
from .gas import GasKernel
from .partition import PartitionedGraph
from .stepper import (LaneStepper, SuperstepGraph, SuperstepProgram,
                      tree_map, tree_nbytes)

__all__ = ["Engine", "EngineResult", "batch_size", "collect",
           "query_tensors", "resolve_device"]

HARD_SUPERSTEP_CAP = 100_000


class _GravfmData(NamedTuple):
    vert_gid: torch.Tensor       # (P, Vm) int32
    vert_valid: torch.Tensor     # (P, Vm) bool
    out_deg: torch.Tensor        # (P, Vm) int32
    flt_cnt: torch.Tensor        # (P, Vm) int32 remote shards w/ neighbors
    src_slot: torch.Tensor       # (L,) int64 lanes (a gather index)
    src_gid: torch.Tensor        # (L,) int32
    src_outdeg: torch.Tensor     # (L,) int32
    w: torch.Tensor              # (L,) f32
    lane_valid: torch.Tensor     # (L,) bool
    lane_remote: torch.Tensor    # (L,) bool: src shard != dst shard
    seg: torch.Tensor            # (L,) int64 segment ids clipped to S
    seg_take: torch.Tensor       # (L,) int64 segment ids clipped to S-1
    layout: Optional[DeviceLayout]  # the kernel's layout (backend="kernel")


class _GravfData(NamedTuple):
    vert_gid: torch.Tensor       # (P, Vm) int32
    vert_valid: torch.Tensor     # (P, Vm) bool
    out_deg: torch.Tensor        # (P, Vm) int32
    flt_cnt: torch.Tensor        # (P, Vm) int32
    pair_src_slot: torch.Tensor  # (P*P*E2,) int64 src p*Vm + local (gather)
    pair_src_gid: torch.Tensor   # (P, P, E2) int32
    pair_src_outdeg: torch.Tensor  # (P, P, E2) int32
    pair_w: torch.Tensor         # (P, P, E2) f32
    pair_valid: torch.Tensor     # (P, P, E2) bool
    pair_cross: torch.Tensor     # (P, P, 1) bool: src shard != dst shard
    recv_seg: torch.Tensor       # (P*P*E2,) int64 receiver-order segments
    recv_seg_take: torch.Tensor  # the same, clipped to S-1


@dataclasses.dataclass
class EngineResult:
    state: Dict[str, np.ndarray]   # per-vertex global arrays (V,)
    supersteps: int
    messages: int                  # traversed edges (paper's TEPS numerator)
    comm: Dict[str, float]         # measured network words by scheme
    raw_state: Any = None          # (P, Vm) shard-layout state, host numpy


def collect(pg: PartitionedGraph, state) -> Dict[str, np.ndarray]:
    """(P, Vm) shard layout -> (V,) global arrays."""
    out = {}
    for k, v in state.items():
        v = np.asarray(v)
        if v.ndim >= 2 and v.shape[:2] == (pg.num_parts, pg.v_max):
            out[k] = v[pg.part_of, pg.local_of]
        else:
            out[k] = v
    return out


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises rather than fall back when there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


class Engine:
    """Runs one (kernel, graph, mode) triple through the GraVF-M superstep
    loop."""

    def __init__(self, kernel: GasKernel, pg: PartitionedGraph, *,
                 mode: str = "gravfm", backend: str = "kernel",
                 tile_e: int = 512, tile_r: int = 256,
                 params: Optional[Dict[str, Any]] = None, device=None):
        if mode not in ("gravf", "gravfm"):
            raise ValueError(f"mode must be 'gravfm' or 'gravf', "
                             f"got {mode!r}")
        if backend not in ("kernel", "ref"):
            raise ValueError(f"backend must be 'kernel' or 'ref', "
                             f"got {backend!r}")
        self.device = resolve_device(device)
        self.kernel = kernel
        self.pg = pg
        self.mode = mode
        self.backend = backend
        self.params = dict(params or {})
        self.params.setdefault("num_vertices", pg.num_vertices)

        P, Vm = pg.num_parts, pg.v_max
        self._P, self._Vm = P, Vm
        self._num_segments = P * (Vm + 1)
        # remote-shard neighbor count per vertex (paper's filter bitmap)
        flt = pg.nbr_filter.copy()
        flt[np.arange(pg.num_vertices), pg.part_of] = False
        flt_cnt_g = flt.sum(axis=1).astype(np.int32)
        flt_cnt = np.zeros((P, Vm), np.int32)
        flt_cnt[pg.part_of, pg.local_of] = flt_cnt_g

        if mode == "gravfm":
            self._data = self._build_gravfm(flt_cnt, tile_e, tile_r)
        else:
            self._data = self._build_gravf(flt_cnt)
        # Trace accounting: one count the first time each program runs at
        # each shape (run per query-argument set, run_batch per batch size,
        # each stepper program per width). The service's plan cache holds
        # steady-state serving to zero new traces against it.
        self.traces = 0
        self._traced: set = set()
        self._trace_lock = threading.Lock()
        self._device_resident = True
        self._prog = self._make_program()
        self._steppers: Dict[int, LaneStepper] = {}
        # run/run_batch on the card: one superstep graph per batch size
        # and set of query parameters
        self._graphs: Dict[tuple, SuperstepGraph] = {}
        self._graphs_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def _build_gravfm(self, flt_cnt, tile_e, tile_r) -> _GravfmData:
        pg, P, Vm = self.pg, self._P, self._Vm
        S = self._num_segments
        seg_flat = (np.arange(P, dtype=np.int64)[:, None] * (Vm + 1)
                    + pg.in_dst_local).reshape(-1)
        valid_flat = pg.in_valid.reshape(-1)
        # Padding edges already carry dst_local == Vm -> their segment is the
        # shard's discard bin; the array stays sorted.
        layout = None
        if self.backend == "kernel":
            host_layout = kops.build_layout(seg_flat, S, tile_e=tile_e,
                                            tile_r=tile_r)
            layout = host_layout.to(self.device)
            place = host_layout.place
            src_slot = place(pg.in_src_slot.reshape(-1), 0)
            src_gid = place(pg.in_src_gid.reshape(-1), 0)
            src_outdeg = place(pg.in_src_outdeg.reshape(-1), 1)
            w = place(pg.in_w.reshape(-1), 0.0)
            lane_valid = place(valid_flat, False) & host_layout.lane_valid
            seg = place(seg_flat, S)
        else:
            src_slot = pg.in_src_slot.reshape(-1)
            src_gid = pg.in_src_gid.reshape(-1)
            src_outdeg = pg.in_src_outdeg.reshape(-1)
            w = pg.in_w.reshape(-1)
            lane_valid = valid_flat
            seg = seg_flat
        # src shard of each lane vs owning shard of its segment
        lane_remote = (src_slot // Vm != seg // (Vm + 1)) & lane_valid
        seg = np.minimum(seg, S)
        t = self._tensor
        return _GravfmData(
            vert_gid=t(pg.vert_gid, torch.int32),
            vert_valid=t(pg.vert_valid, torch.bool),
            out_deg=t(pg.out_deg, torch.int32),
            flt_cnt=t(flt_cnt, torch.int32),
            src_slot=t(src_slot, torch.int64),
            src_gid=t(src_gid, torch.int32),
            src_outdeg=t(src_outdeg, torch.int32),
            w=t(w, torch.float32),
            lane_valid=t(lane_valid, torch.bool),
            lane_remote=t(lane_remote, torch.bool),
            seg=t(seg, torch.int64),
            seg_take=t(np.minimum(seg, S - 1), torch.int64),
            layout=layout,
        )

    def _build_gravf(self, flt_cnt) -> _GravfData:
        pg, P, Vm = self.pg, self._P, self._Vm
        S = self._num_segments
        # the flat gather index of each pair edge's source update
        src_slot = (np.arange(P, dtype=np.int64)[:, None, None] * Vm
                    + pg.pair_src_local)
        # the unicast exchange is the (src, dst) axis transpose: receiver
        # q's segments over (q, p, e), padding at dst_local == Vm (its
        # shard's discard bin)
        recv_dst = pg.pair_dst_local.swapaxes(0, 1).astype(np.int64)
        recv_seg = (np.arange(P, dtype=np.int64)[:, None, None] * (Vm + 1)
                    + recv_dst).reshape(-1)
        t = self._tensor
        return _GravfData(
            vert_gid=t(pg.vert_gid, torch.int32),
            vert_valid=t(pg.vert_valid, torch.bool),
            out_deg=t(pg.out_deg, torch.int32),
            flt_cnt=t(flt_cnt, torch.int32),
            pair_src_slot=t(src_slot.reshape(-1), torch.int64),
            pair_src_gid=t(pg.pair_src_gid, torch.int32),
            pair_src_outdeg=t(pg.pair_src_outdeg, torch.int32),
            pair_w=t(pg.pair_w, torch.float32),
            pair_valid=t(pg.pair_valid, torch.bool),
            pair_cross=t(~np.eye(P, dtype=bool)[:, :, None], torch.bool),
            recv_seg=t(recv_seg, torch.int64),
            recv_seg_take=t(np.minimum(recv_seg, S - 1), torch.int64),
        )

    def _combine(self, data: _GravfmData, vals, combiner: str):
        if self.backend == "kernel":
            return kops.segment_combine_layout(vals, data.layout, combiner)
        return kref.segment_combine(vals, data.seg, self._num_segments,
                                    combiner)

    def _deliver_gravfm(self, data: _GravfmData, payload, active):
        """Broadcast updates; receiver-side scatter + gather-combine.
        Spans: ``engine.broadcast``, ``engine.scatter``, ``engine.combine``
        (a kernel with a carry scatters and combines it in a second pair),
        ``engine.stats``."""
        k, P, Vm = self.kernel, self._P, self._Vm
        B = payload.shape[0]
        with obs.span("engine.broadcast"):
            # THE broadcast: every shard reads every shard's updates.
            vals = payload.reshape(B, P * Vm).index_select(1, data.src_slot)
            act = (active.reshape(B, P * Vm).index_select(1, data.src_slot)
                   & data.lane_valid)
        with obs.span("engine.scatter"):
            msg = k.scatter(vals, data.w, data.src_gid, data.src_outdeg)
            ident = kops.identity_for(k.combiner, k.msg_dtype)
            masked = torch.where(act, msg, ident)

        with obs.span("engine.combine"):
            acc_full = self._combine(data, masked, k.combiner)
            acc = acc_full.reshape(B, P, Vm + 1)[:, :, :Vm]
            if k.got_from_identity:
                got = acc != ident
            else:
                gv = act.to(torch.int32)
                got_full = self._combine(data, gv, "max")
                got = got_full.reshape(B, P, Vm + 1)[:, :, :Vm] > 0

        carry = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            with obs.span("engine.scatter"):
                cvals = k.scatter_carry(vals, data.w, data.src_gid,
                                        data.src_outdeg)
            with obs.span("engine.combine"):
                acc_at_lane = acc_full.index_select(1, data.seg_take)
                winner = act & (masked == acc_at_lane)
                cmasked = torch.where(winner, cvals, cident)
                carry_full = self._combine(data, cmasked, "min")
                carry = carry_full.reshape(B, P, Vm + 1)[:, :, :Vm]

        with obs.span("engine.stats"):
            n_msgs = act.sum(dim=1)
            n_remote = (act & data.lane_remote).sum(dim=1)
        return acc, got, carry, {"n_msgs": n_msgs, "n_remote": n_remote}

    def _deliver_gravf(self, data: _GravfData, payload, active):
        """Source-side scatter, unicast exchange (paper Fig. 4 left).

        The JAX engine folds this mode with its ``segment_combine`` oracle
        for every backend, with no Pallas kernel; so does the port, with
        the ``scatter_reduce_`` oracle on the engine's device (the
        reference's own design, not a fallback). Spans as
        :meth:`_deliver_gravfm`'s; the exchange is in ``engine.scatter``."""
        k, P, Vm = self.kernel, self._P, self._Vm
        B = payload.shape[0]
        S = self._num_segments
        shape = (B,) + tuple(data.pair_w.shape)
        with obs.span("engine.broadcast"):
            vals = payload.reshape(B, P * Vm).index_select(
                1, data.pair_src_slot).view(shape)
            act = active.reshape(B, P * Vm).index_select(
                1, data.pair_src_slot).view(shape) & data.pair_valid
        with obs.span("engine.scatter"):
            msg = k.scatter(vals, data.pair_w, data.pair_src_gid,
                            data.pair_src_outdeg)
            ident = kops.identity_for(k.combiner, k.msg_dtype)
            masked = torch.where(act, msg, ident)
            # THE unicast exchange: the shard-axis transpose.
            recv = masked.transpose(1, 2).reshape(B, -1)
            recv_act = act.transpose(1, 2).reshape(B, -1)

        with obs.span("engine.combine"):
            acc_full = kref.segment_combine(recv, data.recv_seg, S,
                                            k.combiner)
            acc = acc_full.reshape(B, P, Vm + 1)[:, :, :Vm]
            if k.got_from_identity:
                got = acc != ident
            else:
                got_full = kref.segment_combine(recv_act.to(torch.int32),
                                                data.recv_seg, S, "max")
                got = got_full.reshape(B, P, Vm + 1)[:, :, :Vm] > 0

        carry = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            with obs.span("engine.scatter"):
                cvals = k.scatter_carry(vals, data.pair_w, data.pair_src_gid,
                                        data.pair_src_outdeg)
                crecv = torch.where(act, cvals, cident).transpose(
                    1, 2).reshape(B, -1)
            with obs.span("engine.combine"):
                acc_at_edge = acc_full.index_select(1, data.recv_seg_take)
                winner = recv_act & (recv == acc_at_edge)
                cmasked = torch.where(winner, crecv, cident)
                carry_full = kref.segment_combine(cmasked, data.recv_seg, S,
                                                  "min")
                carry = carry_full.reshape(B, P, Vm + 1)[:, :, :Vm]

        with obs.span("engine.stats"):
            n_msgs = act.flatten(1).sum(dim=1)
            n_remote = (act & data.pair_cross).flatten(1).sum(dim=1)
        return acc, got, carry, {"n_msgs": n_msgs, "n_remote": n_remote}

    # ------------------------------------------------------------------
    def _make_program(self) -> SuperstepProgram:
        """deliver -> gather -> stats -> apply, with the four stats of the
        JAX engine. Counts are int64 (the JAX engine's int32 ``messages``
        wraps past 2**31 traversed edges); the word counts are float32
        running sums added in the same order, so they agree bit for bit."""
        P, device = self._P, self.device
        deliver = (self._deliver_gravfm if self.mode == "gravfm"
                   else self._deliver_gravf)

        def init_stats(batch):
            def zeros(dtype):
                return torch.zeros(batch, dtype=dtype, device=device)
            return {
                "messages": zeros(torch.int64),
                "unicast_words": zeros(torch.float32),
                "bcast_naive_words": zeros(torch.float32),
                "bcast_filtered_words": zeros(torch.float32),
            }

        def update_stats(stats, data, active, aux):
            n_act = active.flatten(1).sum(dim=1)
            n_flt = torch.where(active, data.flt_cnt, 0).flatten(1).sum(dim=1)
            return {
                "messages": stats["messages"] + aux["n_msgs"],
                "unicast_words":
                    stats["unicast_words"] + aux["n_remote"].to(torch.float32),
                "bcast_naive_words":
                    stats["bcast_naive_words"]
                    + (n_act * (P - 1)).to(torch.float32),
                "bcast_filtered_words":
                    stats["bcast_filtered_words"] + n_flt.to(torch.float32),
            }

        prog = SuperstepProgram(self.kernel, deliver,
                                init_stats=init_stats,
                                update_stats=update_stats)
        prog.lanes = int((self._data.src_slot if self.mode == "gravfm"
                          else self._data.pair_src_slot).numel())
        return prog

    # ------------------------------------------------------------------
    @property
    def device_resident(self) -> bool:
        """Whether the graph data lives on the engine's device (vs the
        host copies of the store's spill tier)."""
        return self._device_resident

    @property
    def device_nbytes(self) -> int:
        """Bytes of the engine's graph data on the device (the kernel's
        layout included) — exactly what :meth:`offload` demotes."""
        return tree_nbytes(self._data)

    def offload(self) -> int:
        """Demote the graph data to host copies (pinned when the engine
        runs on the card) — the engine tier of the graph store's host
        spill. Programs and steppers stay; a dispatch while offloaded
        stages the data to the device for that call, so it still runs on
        the device, only slower, until :meth:`upload`. Returns the bytes
        demoted."""
        if not self._device_resident:
            return 0
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)

        def host(t):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            return out.copy_(t)
        data = tree_map(host, self._data)
        self._rebind_data(data, resident=False)
        return tree_nbytes(data)

    def upload(self) -> float:
        """Promote offloaded graph data back to the device. Shapes and
        dtypes are unchanged, so nothing is traced anew (the spill/refault
        contract). Returns the wall seconds the upload took."""
        if self._device_resident:
            return 0.0
        t0 = time.perf_counter()
        data = tree_map(lambda t: t.to(self.device, non_blocking=True),
                        self._data)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._rebind_data(data, resident=True)
        return time.perf_counter() - t0

    def _rebind_data(self, data, *, resident: bool) -> None:
        with self._graphs_lock:
            self._data = data
            self._device_resident = resident
            self._graphs = {}   # they hold the old data's addresses
        for st in list(self._steppers.values()):
            st.bind_data(data)

    def _device_data(self):
        """The graph data on the engine's device: the resident arrays, or
        a copy staged for this call while offloaded."""
        if self._device_resident:
            return self._data
        return tree_map(lambda t: t.to(self.device), self._data)

    def _note_trace(self, key) -> None:
        with self._trace_lock:
            if key not in self._traced:
                self._traced.add(key)
                self.traces += 1

    def _bump_traces(self) -> None:
        with self._trace_lock:
            self.traces += 1

    @property
    def wire_stat(self) -> str:
        """Which stats entry counts the words this mode's scheme puts on
        the wire (filtered broadcast for GraVF-M, per-edge unicast for
        GraVF), surfaced as ``comm["wire_words"]``."""
        return ("bcast_filtered_words" if self.mode == "gravfm"
                else "unicast_words")

    def _result(self, state, superstep, stats, q: int) -> EngineResult:
        """Query ``q`` of host (numpy) state/superstep/stats arrays with a
        leading query axis, as an :class:`EngineResult`."""
        state_q = {kk: np.asarray(v[q]) for kk, v in state.items()}
        comm = {kk: float(v[q]) for kk, v in stats.items()}
        comm["scheme"] = ("gravfm_broadcast" if self.mode == "gravfm"
                          else "gravf_unicast")
        comm["wire_words"] = comm[self.wire_stat]
        messages = int(stats["messages"][q])
        obs.counters.add("engine.messages", messages)
        return EngineResult(
            state=collect(self.pg, state_q),
            supersteps=int(superstep[q]),
            messages=messages,
            comm=comm,
            raw_state=state_q,
        )

    def _graph(self, batch: int, qkw) -> Optional[SuperstepGraph]:
        """The superstep graph at ``batch`` for the query parameters
        ``qkw`` names, its lock taken for this call; None where the call
        runs the eager loop: on the CPU, while the data is offloaded (it
        is staged anew each call), or while another call holds the
        graph."""
        key = (batch,) + tuple(sorted(qkw))
        with self._graphs_lock:
            if self.device.type != "cuda" or not self._device_resident:
                return None
            graph = self._graphs.get(key)
            if graph is None:
                graph = SuperstepGraph(self._prog, self._data, self.params,
                                       batch, self.device)
                self._graphs[key] = graph
        return graph if graph.lock.acquire(blocking=False) else None

    def _run(self, max_supersteps, qkw, batch,
             graph: Optional[SuperstepGraph]) -> "list[EngineResult]":
        cap = max_supersteps or self.kernel.max_supersteps or HARD_SUPERSTEP_CAP
        if graph is None:
            return self._collect(self._prog.run_loop(
                self._device_data(), cap, self.params, qkw, batch), batch)
        try:
            return self._collect(graph.run_loop(cap, qkw), batch)
        finally:
            graph.lock.release()

    def _collect(self, carry, batch) -> "list[EngineResult]":
        with obs.span("engine.collect"):
            state = state_to_numpy(carry.state)
            steps = carry.superstep.cpu().numpy()
            stats = state_to_numpy(carry.stats)
            return [self._result(state, steps, stats, q)
                    for q in range(batch)]

    def _call(self, entry: str, max_supersteps, query,
              graphed: bool) -> "list[EngineResult]":
        with obs.span("engine.call"):
            qkw = query_tensors(self.kernel, query, self.device,
                                batch=entry == "run_batch")
            batch = batch_size(qkw) if qkw else 1
            shape = (entry, batch) if entry == "run_batch" else (entry,)
            self._note_trace(shape + (tuple(sorted(qkw)),))
            graph = self._graph(batch, qkw) if graphed else None
            return self._run(max_supersteps, qkw, batch, graph)

    def run(self, max_supersteps: Optional[int] = None,
            **query_kwargs) -> EngineResult:
        """Single query. ``query_kwargs`` (e.g. ``root=7``) override the
        kernel's defaults in ``init_state``."""
        return self._call("run", max_supersteps, query_kwargs, True)[0]

    def run_batch(self, max_supersteps: Optional[int] = None,
                  **query_arrays) -> "list[EngineResult]":
        """One superstep loop over a leading query axis. ``query_arrays``
        maps the kernel's ``query_params`` (e.g. ``root``) to (B,) arrays.
        Returns one :class:`EngineResult` per query, bit-identical to B
        sequential :meth:`run` calls."""
        return self._call("run_batch", max_supersteps, query_arrays, True)

    def run_eager(self, entry: str, max_supersteps: Optional[int] = None,
                  **query) -> "list[EngineResult]":
        """:meth:`run` (as a list of one) or :meth:`run_batch`, by
        ``entry``, on the eager loop, with the same results and trace
        counts: a call holds its carry and its intermediates only while
        it runs, where a graph pair holds a carry, and a share in the
        graphs' pool, from its capture on. The service's plans call it,
        since the graph store's memory budget charges an engine its data
        alone."""
        if entry not in ("run", "run_batch"):
            raise ValueError(f"entry must be 'run' or 'run_batch', "
                             f"got {entry!r}")
        return self._call(entry, max_supersteps, query, False)

    # ------------------------------------------------------------------
    def make_stepper(self, width: int) -> LaneStepper:
        """A host-drivable ``width``-lane slot array over this engine's
        superstep program — the step-granular entry point the continuous
        scheduler drives (admit / one superstep / probe / retire). Lanes
        run the same batched computation as :meth:`run_batch`, so a lane
        is bit-identical to a solo :meth:`run` of its query whatever
        superstep it was spliced in at. Cached per width: each of its
        programs counts one trace, then slots recycle with no more."""
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        st = self._steppers.get(width)
        if st is None:
            st = LaneStepper(self._prog, self._data, self.params, width,
                             device=self.device,
                             trace_hook=self._bump_traces,
                             wire_stat=self.wire_stat)
            self._steppers[width] = st
        return st

    def lane_result(self, carry_host, lane: int) -> EngineResult:
        """Package one retired lane of a host-fetched stepper carry as an
        :class:`EngineResult` (same fields as :meth:`run`)."""
        return self._result(carry_host.state, carry_host.superstep,
                            carry_host.stats, lane)


def query_tensors(kernel: GasKernel, query_kwargs: Dict[str, Any], device,
                  *, batch: bool) -> Dict[str, torch.Tensor]:
    """Checked query parameters as (B, 1, 1) tensors on ``device``: scalars
    for ``run`` (``batch=False``), (B,) arrays for ``run_batch``."""
    if batch and not query_kwargs:
        raise ValueError(
            "run_batch needs at least one per-query array, e.g. "
            "root=np.array([...]); see GasKernel.query_params")
    unknown = set(query_kwargs) - set(kernel.query_params)
    if unknown:
        raise ValueError(
            f"kernel {kernel.name!r} takes query params "
            f"{tuple(kernel.query_params)}, got unexpected "
            f"{sorted(unknown)}")
    out = {}
    for kk, v in query_kwargs.items():
        t = torch.as_tensor(np.atleast_1d(np.asarray(v)), device=device)
        if t.dim() != 1:
            raise ValueError(f"query parameters must be scalars or (B,) "
                             f"arrays, got shape {tuple(t.shape)}")
        if not batch and t.shape[0] != 1:
            raise ValueError("run takes scalar query parameters; use "
                             "run_batch for arrays")
        out[kk] = t.view(-1, 1, 1)
    return out


def batch_size(qkw: Dict[str, torch.Tensor]) -> int:
    """The common leading size of the query tensors."""
    sizes = {kk: v.shape[0] for kk, v in qkw.items()}
    batch = next(iter(sizes.values()))
    if any(b != batch for b in sizes.values()):
        raise ValueError(f"inconsistent query batch sizes: {sizes}")
    return batch
