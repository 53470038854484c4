"""The GraVF-M superstep engine on one device, in PyTorch (twin of
``repro.core.engine``'s ``Engine(mode="gravfm")``).

apply emits ≤1 update per vertex; the per-shard update arrays are
broadcast (a gather over ``src_slot``); scatter runs at the RECEIVER
against its destination-partitioned edge list, and the messages are
folded per destination by the segment-combine kernel. The engine is a
global-array program with an explicit leading shard axis ``P`` (all
shards on one device, as the JAX engine runs them on one device) and a
leading query axis ``B`` (one for :meth:`Engine.run`, B for
:meth:`Engine.run_batch`).

``backend="kernel"`` lays the edges out into kernel lanes and combines
through :func:`repro_torch.kernels.ops.segment_combine_layout` (the CUDA
kernel on the card, its plain version on the CPU); ``backend="ref"``
combines with the ``scatter_reduce_`` oracle over the unpadded CSC.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..convert import state_to_numpy
from ..kernels import ops as kops
from ..kernels import ref as kref
from .gas import GasKernel
from .partition import PartitionedGraph
from .stepper import SuperstepProgram

__all__ = ["Engine", "EngineResult", "collect", "resolve_device"]

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
    """Runs one (kernel, graph) pair through the GraVF-M superstep loop."""

    def __init__(self, kernel: GasKernel, pg: PartitionedGraph, *,
                 mode: str = "gravfm", backend: str = "kernel",
                 tile_e: int = 512, tile_r: int = 256,
                 params: Optional[Dict[str, Any]] = None, device=None):
        if mode == "gravf":
            raise NotImplementedError(
                "mode='gravf' is not ported yet (ROADMAP §1 item 4, "
                "'mode=\"gravf\"')")
        if mode != "gravfm":
            raise ValueError(f"unknown mode {mode!r}")
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
        # remote-shard neighbor count per vertex (paper's filter bitmap)
        flt = pg.nbr_filter.copy()
        flt[np.arange(pg.num_vertices), pg.part_of] = False
        flt_cnt_g = flt.sum(axis=1).astype(np.int32)
        flt_cnt = np.zeros((P, Vm), np.int32)
        flt_cnt[pg.part_of, pg.local_of] = flt_cnt_g

        self._data = self._build_gravfm(flt_cnt, tile_e, tile_r)
        self._prog = self._make_program()

    # ------------------------------------------------------------------
    def _build_gravfm(self, flt_cnt, tile_e, tile_r) -> _GravfmData:
        pg, P, Vm = self.pg, self._P, self._Vm
        S = P * (Vm + 1)
        seg_flat = (np.arange(P, dtype=np.int64)[:, None] * (Vm + 1)
                    + pg.in_dst_local).reshape(-1)
        valid_flat = pg.in_valid.reshape(-1)
        # Padding edges already carry dst_local == Vm -> their segment is the
        # shard's discard bin; the array stays sorted.
        if self.backend == "kernel":
            layout = kops.build_layout(seg_flat, S, tile_e=tile_e,
                                       tile_r=tile_r)
            self._layout = layout.to(self.device)
            place = layout.place
            src_slot = place(pg.in_src_slot.reshape(-1), 0)
            src_gid = place(pg.in_src_gid.reshape(-1), 0)
            src_outdeg = place(pg.in_src_outdeg.reshape(-1), 1)
            w = place(pg.in_w.reshape(-1), 0.0)
            lane_valid = place(valid_flat, False) & layout.lane_valid
            seg = place(seg_flat, S)
        else:
            self._layout = None
            src_slot = pg.in_src_slot.reshape(-1)
            src_gid = pg.in_src_gid.reshape(-1)
            src_outdeg = pg.in_src_outdeg.reshape(-1)
            w = pg.in_w.reshape(-1)
            lane_valid = valid_flat
            seg = seg_flat
        self._num_segments = S
        # src shard of each lane vs owning shard of its segment
        lane_remote = (src_slot // Vm != seg // (Vm + 1)) & lane_valid
        seg = np.minimum(seg, S)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

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
        )

    def _combine(self, data: _GravfmData, vals, combiner: str):
        if self.backend == "kernel":
            return kops.segment_combine_layout(vals, self._layout, combiner)
        return kref.segment_combine(vals, data.seg, self._num_segments,
                                    combiner)

    def _deliver_gravfm(self, data: _GravfmData, payload, active):
        """Broadcast updates; receiver-side scatter + gather-combine."""
        k, P, Vm = self.kernel, self._P, self._Vm
        B = payload.shape[0]
        # THE broadcast: every shard reads every shard's updates.
        vals = payload.reshape(B, P * Vm).index_select(1, data.src_slot)
        act = (active.reshape(B, P * Vm).index_select(1, data.src_slot)
               & data.lane_valid)
        msg = k.scatter(vals, data.w, data.src_gid, data.src_outdeg)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        masked = torch.where(act, msg, ident)

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
            cvals = k.scatter_carry(vals, data.w, data.src_gid,
                                    data.src_outdeg)
            acc_at_lane = acc_full.index_select(1, data.seg_take)
            winner = act & (masked == acc_at_lane)
            cmasked = torch.where(winner, cvals, cident)
            carry_full = self._combine(data, cmasked, "min")
            carry = carry_full.reshape(B, P, Vm + 1)[:, :, :Vm]

        n_msgs = act.sum(dim=1)
        n_remote = (act & data.lane_remote).sum(dim=1)
        return acc, got, carry, {"n_msgs": n_msgs, "n_remote": n_remote}

    # ------------------------------------------------------------------
    def _make_program(self) -> SuperstepProgram:
        """deliver -> gather -> stats -> apply, with the four stats of the
        JAX engine. Counts are int64 (the JAX engine's int32 ``messages``
        wraps past 2**31 traversed edges); the word counts are float32
        running sums added in the same order, so they agree bit for bit."""
        P, device = self._P, self.device

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

        return SuperstepProgram(self.kernel, self._deliver_gravfm,
                                init_stats=init_stats,
                                update_stats=update_stats)

    # ------------------------------------------------------------------
    @property
    def device_nbytes(self) -> int:
        """Bytes of the engine's graph layout on the device."""
        arrays = list(self._data)
        if self._layout is not None:
            arrays += [self._layout.window_id, self._layout.tile_start,
                       self._layout.rel]
        return int(sum(a.numel() * a.element_size() for a in arrays))

    @property
    def wire_stat(self) -> str:
        """The stats entry that counts the words GraVF-M's filtered
        broadcast puts on the wire, surfaced as ``comm["wire_words"]``."""
        return "bcast_filtered_words"

    def _check_query_kwargs(self, kwargs: Dict[str, Any]) -> None:
        unknown = set(kwargs) - set(self.kernel.query_params)
        if unknown:
            raise ValueError(
                f"kernel {self.kernel.name!r} takes query params "
                f"{tuple(self.kernel.query_params)}, got unexpected "
                f"{sorted(unknown)}")

    def _run(self, max_supersteps, qkw, batch) -> "list[EngineResult]":
        cap = max_supersteps or self.kernel.max_supersteps or HARD_SUPERSTEP_CAP
        carry = self._prog.run_loop(self._data, cap, self.params, qkw, batch)
        state = state_to_numpy(carry.state)
        steps = carry.superstep.cpu().numpy()
        stats = state_to_numpy(carry.stats)
        results = []
        for q in range(batch):
            state_q = {kk: v[q, ...] for kk, v in state.items()}
            comm = {kk: float(v[q]) for kk, v in stats.items()}
            comm["scheme"] = "gravfm_broadcast"
            comm["wire_words"] = comm[self.wire_stat]
            results.append(EngineResult(
                state=collect(self.pg, state_q),
                supersteps=int(steps[q]),
                messages=int(stats["messages"][q]),
                comm=comm,
                raw_state=state_q,
            ))
        return results

    def _query_tensor(self, v) -> torch.Tensor:
        """A per-query parameter as a (B, 1, 1) tensor on the device."""
        t = torch.as_tensor(np.atleast_1d(np.asarray(v)), device=self.device)
        if t.dim() != 1:
            raise ValueError(f"query parameters must be scalars or (B,) "
                             f"arrays, got shape {tuple(t.shape)}")
        return t.view(-1, 1, 1)

    def run(self, max_supersteps: Optional[int] = None,
            **query_kwargs) -> EngineResult:
        """Single query. ``query_kwargs`` (e.g. ``root=7``) override the
        kernel's defaults in ``init_state``."""
        self._check_query_kwargs(query_kwargs)
        qkw = {kk: self._query_tensor(v) for kk, v in query_kwargs.items()}
        if any(t.shape[0] != 1 for t in qkw.values()):
            raise ValueError("run takes scalar query parameters; use "
                             "run_batch for arrays")
        return self._run(max_supersteps, qkw, 1)[0]

    def run_batch(self, max_supersteps: Optional[int] = None,
                  **query_arrays) -> "list[EngineResult]":
        """One superstep loop over a leading query axis. ``query_arrays``
        maps the kernel's ``query_params`` (e.g. ``root``) to (B,) arrays.
        Returns one :class:`EngineResult` per query, bit-identical to B
        sequential :meth:`run` calls."""
        if not query_arrays:
            raise ValueError(
                "run_batch needs at least one per-query array, e.g. "
                "root=np.array([...]); see GasKernel.query_params")
        self._check_query_kwargs(query_arrays)
        qkw = {kk: self._query_tensor(v) for kk, v in query_arrays.items()}
        sizes = {kk: v.shape[0] for kk, v in qkw.items()}
        batch = next(iter(sizes.values()))
        if any(b != batch for b in sizes.values()):
            raise ValueError(f"inconsistent query batch sizes: {sizes}")
        return self._run(max_supersteps, qkw, batch)
