"""The explicit-collective GraVF-M shard engine in PyTorch (twin of
``repro.core.engine_shardmap``'s :class:`ShardEngine`).

The paper's system is a set of shards that share no memory and exchange
updates over an interconnect. Each superstep every shard applies, ships
its updates through one of three exchanges, and folds what it received:

  exchange="allgather" — GraVF-M: every shard's dense update array goes
      to every peer (one all_gather), then receiver-side scatter and a
      segment-combine over the shard's destination-partitioned lanes
      (K2, ``kernels/ops.py:segment_combine_stacked``).
  exchange="unicast"   — the GraVF baseline: per-edge messages built at
      the source, shipped in padded per-(source, destination shard)
      blocks with one all_to_all, folded at the receiver.
  exchange="combined"  — combine at the source: the per-edge messages are
      folded per (destination shard, destination vertex) first (K2 over
      the shard's dst-sorted per-pair lanes), so the all_to_all carries
      one slot per remote destination instead of one per edge.

The receiver-side folds of unicast and combined use the
``scatter_reduce_`` oracle, as the JAX engine uses its oracle there.

The per-shard code is written once over an explicit local-shard axis:
per-vertex arrays are ``(B, S, Vm)``, query axis first, with ``S`` the
shards this process holds (:mod:`repro_torch.core.mesh`): all ``P`` on
one device with :class:`~repro_torch.core.mesh.LocalMesh`, one per rank
with :class:`~repro_torch.core.mesh.ProcessGroupMesh`. States, supersteps,
messages and wire words equal the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..convert import state_to_numpy
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.layout import StackedLayout, build_layout, stack_layouts
from .engine import (HARD_SUPERSTEP_CAP, EngineResult, batch_size, collect,
                     query_tensors)
from .gas import GasKernel
from .mesh import LocalMesh
from .partition import PartitionedGraph
from .stepper import SuperstepProgram

__all__ = ["ShardData", "ShardEngine", "ShardMeta", "build_shard_data"]

EXCHANGES = ("allgather", "unicast", "combined")
_NOT_PORTED = {"ring": "step 3", "frontier": "step 4"}


class ShardData(NamedTuple):
    """The JAX ``ShardData`` fields (numpy, leading shard axis ``P``),
    plus ``tile_start`` and ``comb_tile_start``: the per-shard window tile
    ranges the stacked combine walks."""
    vert_gid: Any        # (P, Vm)
    vert_valid: Any      # (P, Vm)
    out_deg: Any         # (P, Vm)
    flt_cnt: Any         # (P, Vm)
    # CSC lanes in kernel layout (allgather)
    wid: Any             # (P, n_tiles)
    rel: Any             # (P, L)
    window_written: Any  # (P, n_windows)
    tile_start: Any      # (P, n_windows+1)
    src_slot: Any        # (P, L) global slot = part*Vm + local
    src_gid: Any         # (P, L)
    src_outdeg: Any      # (P, L)
    w: Any               # (P, L)
    lane_valid: Any      # (P, L)
    seg: Any             # (P, L) local segment (dst_local; pad Vm)
    # ring buckets: in-edges grouped by SOURCE shard (ring not ported yet)
    rb_src_local: Any    # (P, P, E2)
    rb_src_gid: Any
    rb_src_outdeg: Any
    rb_w: Any
    rb_dst_local: Any
    rb_valid: Any
    # unicast blocks (source-side layout)
    pair_src_local: Any  # (P, P, E2)
    pair_src_gid: Any
    pair_src_outdeg: Any
    pair_w: Any
    pair_valid: Any
    recv_dst_local: Any  # (P, P, E2)
    # combined: source-side dst-sorted lanes over flat (dest shard, dst
    # rank) segments, and the static per-(peer, rank) receive ids
    comb_wid: Any             # (P, comb_tiles)
    comb_rel: Any             # (P, CL)
    comb_written: Any         # (P, comb_windows)
    comb_tile_start: Any      # (P, comb_windows+1)
    comb_src_local: Any       # (P, CL)
    comb_src_gid: Any         # (P, CL)
    comb_src_outdeg: Any      # (P, CL)
    comb_w: Any               # (P, CL)
    comb_valid: Any           # (P, CL)
    comb_seg: Any             # (P, CL) flat q*(R+1)+rank; pad Sc
    comb_recv_dst_local: Any  # (P, P, comb_max)


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    P: int
    v_max: int
    e_pair_max: int
    n_tiles: int
    n_windows: int
    tile_e: int
    tile_r: int
    num_vertices: int
    frontier_capacities: tuple = ()
    comb_max: int = 0        # padded distinct remote dsts per shard pair
    comb_tiles: int = 0
    comb_windows: int = 0


def _placed(layouts, rows: Sequence[np.ndarray], fill) -> np.ndarray:
    """Per-shard edge arrays scattered into each shard's kernel lanes,
    padded to the longest shard's lane count with ``fill``."""
    L = max(lo.num_lanes for lo in layouts)
    out = np.full((len(layouts), L), fill, rows[0].dtype)
    for p, lo in enumerate(layouts):
        out[p, :lo.num_lanes] = lo.place(rows[p], fill)
    return out


def _build_shard_layouts(pg: PartitionedGraph, tile_e: int, tile_r: int):
    """Per-shard CSC layouts padded to a common tile count."""
    P, Vm = pg.num_parts, pg.v_max
    layouts = [build_layout(pg.in_dst_local[p].astype(np.int64), Vm + 1,
                            tile_e=tile_e, tile_r=tile_r) for p in range(P)]
    st, n_tiles, n_windows = stack_layouts(layouts)
    return (dict(wid=st["window_id"], rel=st["rel"],
                 window_written=st["window_written"],
                 tile_start=st["tile_start"],
                 src_slot=_placed(layouts, pg.in_src_slot, 0),
                 src_gid=_placed(layouts, pg.in_src_gid, 0),
                 src_outdeg=_placed(layouts, pg.in_src_outdeg, 1),
                 w=_placed(layouts, pg.in_w, np.float32(0.0)),
                 lane_valid=_placed(layouts, pg.in_valid, False),
                 seg=_placed(layouts, pg.in_dst_local, Vm)),
            n_tiles, n_windows)


def _build_combined_layouts(pg: PartitionedGraph, tile_e: int, tile_r: int):
    """Source-side layout for the combined exchange: each shard's edges,
    dst-sorted within each destination-shard bucket, as a kernel layout
    over the flat segment id ``q*(R+1) + dst_rank`` (the bucket's discard
    bin is rank R, so the flat ids stay sorted). The combine over it
    yields the per-(peer, rank) partials that go on the wire."""
    cb = pg.combined_buckets()
    P = pg.num_parts
    R = cb["comb_max"]
    Sc = P * (R + 1)
    seg_all = (np.arange(P, dtype=np.int64)[None, :, None] * (R + 1)
               + cb["dst_rank"].astype(np.int64)).reshape(P, -1)
    layouts = [build_layout(seg_all[p], Sc, tile_e=tile_e, tile_r=tile_r)
               for p in range(P)]
    st, n_tiles, n_windows = stack_layouts(layouts)

    def flat(name):
        return cb[name].reshape(P, -1)

    return (dict(comb_wid=st["window_id"], comb_rel=st["rel"],
                 comb_written=st["window_written"],
                 comb_tile_start=st["tile_start"],
                 comb_src_local=_placed(layouts, flat("src_local"), 0),
                 comb_src_gid=_placed(layouts, flat("src_gid"), 0),
                 comb_src_outdeg=_placed(layouts, flat("src_outdeg"), 1),
                 comb_w=_placed(layouts, flat("w"), np.float32(0.0)),
                 comb_valid=_placed(layouts, flat("valid"), False),
                 comb_seg=_placed(layouts, seg_all.astype(np.int32), Sc),
                 comb_recv_dst_local=np.ascontiguousarray(
                     cb["comb_dst"].swapaxes(0, 1))),
            R, n_tiles, n_windows)


def build_shard_data(pg: PartitionedGraph, *, tile_e: int = 512,
                     tile_r: int = 256) -> tuple:
    """(ShardData of numpy arrays, ShardMeta), as the JAX engine builds
    them (plus the two ``tile_start`` fields)."""
    P, Vm = pg.num_parts, pg.v_max
    lanes, n_tiles, n_windows = _build_shard_layouts(pg, tile_e, tile_r)
    comb, comb_max, comb_tiles, comb_windows = _build_combined_layouts(
        pg, tile_e, tile_r)

    flt = pg.nbr_filter.copy()
    flt[np.arange(pg.num_vertices), pg.part_of] = False
    flt_cnt = np.zeros((P, Vm), np.int32)
    flt_cnt[pg.part_of, pg.local_of] = flt.sum(axis=1).astype(np.int32)

    # ring buckets: shard p's in-edges grouped by source shard q =
    # transpose of the pair (source-side) layout. src_local is local to q.
    rb = dict(
        rb_src_local=pg.pair_src_local.swapaxes(0, 1),
        rb_src_gid=pg.pair_src_gid.swapaxes(0, 1),
        rb_src_outdeg=pg.pair_src_outdeg.swapaxes(0, 1),
        rb_w=pg.pair_w.swapaxes(0, 1),
        rb_dst_local=pg.pair_dst_local.swapaxes(0, 1),
        rb_valid=pg.pair_valid.swapaxes(0, 1),
    )
    data = ShardData(
        vert_gid=pg.vert_gid, vert_valid=pg.vert_valid, out_deg=pg.out_deg,
        flt_cnt=flt_cnt,
        **lanes,
        **{k: np.ascontiguousarray(v) for k, v in rb.items()},
        pair_src_local=pg.pair_src_local, pair_src_gid=pg.pair_src_gid,
        pair_src_outdeg=pg.pair_src_outdeg, pair_w=pg.pair_w,
        pair_valid=pg.pair_valid,
        recv_dst_local=pg.pair_dst_local.swapaxes(0, 1),
        **comb,
    )
    # frontier capacity buckets: powers of four from Vm/16 up to Vm
    caps = []
    c = max(64, Vm // 16)
    while c < Vm:
        caps.append(c)
        c *= 4
    caps.append(Vm)
    meta = ShardMeta(P=P, v_max=Vm, e_pair_max=pg.e_pair_max,
                     n_tiles=n_tiles, n_windows=n_windows,
                     tile_e=tile_e, tile_r=tile_r,
                     num_vertices=pg.num_vertices,
                     frontier_capacities=tuple(caps),
                     comb_max=comb_max, comb_tiles=comb_tiles,
                     comb_windows=comb_windows)
    return data, meta


# The ShardData fields each exchange reads on the device (the set the JAX
# engine's ``abstract_shard_data`` names, less what no code here reads:
# ``flt_cnt``, and ``wid``/``window_written``, which the stacked combine
# replaces with ``tile_start``). Gather indices go up as int64.
_VERTEX_FIELDS = ("vert_gid", "vert_valid", "out_deg")
_EXCHANGE_FIELDS = {
    "allgather": ("src_slot", "src_gid", "src_outdeg", "w", "lane_valid",
                  "seg"),
    "unicast": ("pair_src_local", "pair_src_gid", "pair_src_outdeg",
                "pair_w", "pair_valid", "recv_dst_local"),
    "combined": ("comb_src_local", "comb_src_gid", "comb_src_outdeg",
                 "comb_w", "comb_valid", "comb_seg", "comb_recv_dst_local"),
}
_KERNEL_FIELDS = {"allgather": ("tile_start", "rel"),
                  "combined": ("comb_tile_start", "comb_rel")}
_INDEX_FIELDS = ("src_slot", "seg", "pair_src_local", "recv_dst_local",
                 "comb_src_local", "comb_seg", "comb_recv_dst_local")


def _take(acc: torch.Tensor, ident, seg: torch.Tensor) -> torch.Tensor:
    """Each lane's fold value: ``acc_pad[..., min(seg, n)]``, where
    ``acc_pad`` is ``acc`` (B, S, n) with one identity bin appended, and
    ``seg`` is (S, N)."""
    n = acc.shape[-1]
    acc_pad = torch.cat([acc, acc.new_full(acc.shape[:-1] + (1,), ident)],
                        dim=-1)
    index = seg.clamp(max=n).expand(acc.shape[:-2] + seg.shape)
    return torch.gather(acc_pad, -1, index)


def _gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x[b, s, src[s, ...]]``: a per-vertex (B, S, Vm) array read at
    each lane's local source vertex, shape (B,) + src.shape."""
    index = src.reshape(src.shape[0], -1)
    index = index.expand((x.shape[0],) + index.shape)
    return torch.gather(x, 2, index).view((x.shape[0],) + src.shape)


class ShardEngine:
    """Runs one (kernel, graph) pair over the shards of a mesh."""

    def __init__(self, kernel: GasKernel, pg: PartitionedGraph, *,
                 mesh=None, exchange: str = "allgather",
                 backend: str = "kernel", tile_e: int = 512,
                 tile_r: int = 256, params: Optional[Dict[str, Any]] = None,
                 shard_data: Optional[tuple] = None):
        """``mesh`` defaults to ``LocalMesh(pg.num_parts)`` on the card.
        ``shard_data`` is ``build_shard_data(pg, tile_e=, tile_r=)``'s
        result, to share one host build between engines."""
        if exchange in _NOT_PORTED:
            raise NotImplementedError(
                f"exchange={exchange!r} is not ported yet (ROADMAP §1 item "
                f"7, {_NOT_PORTED[exchange]})")
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        if backend not in ("kernel", "ref"):
            raise ValueError(f"backend must be 'kernel' or 'ref', "
                             f"got {backend!r}")
        self.mesh = LocalMesh(pg.num_parts) if mesh is None else mesh
        if self.mesh.num_shards != pg.num_parts:
            raise ValueError(f"mesh has {self.mesh.num_shards} shards, the "
                             f"graph {pg.num_parts}")
        self.device = self.mesh.device
        self.kernel = kernel
        self.pg = pg
        self.exchange = exchange
        self.backend = backend
        self.params = dict(params or {})
        self.params.setdefault("num_vertices", pg.num_vertices)
        if shard_data is None:
            shard_data = build_shard_data(pg, tile_e=tile_e, tile_r=tile_r)
        np_data, self.meta = shard_data
        if (self.meta.tile_e, self.meta.tile_r) != (tile_e, tile_r):
            raise ValueError("shard_data was built with other tiles")
        self._data = self._upload(np_data)
        m = self.meta
        self._csc = self._comb = None
        if backend == "kernel" and exchange == "allgather":
            self._csc = StackedLayout(self._data.tile_start, self._data.rel,
                                      tile_e, tile_r, m.v_max + 1)
        if backend == "kernel" and exchange == "combined":
            self._comb = StackedLayout(
                self._data.comb_tile_start, self._data.comb_rel, tile_e,
                tile_r, m.P * (m.comb_max + 1))
        # wire words a shard puts on the wire each superstep
        words = {"allgather": m.v_max * (m.P - 1),
                 "unicast": m.e_pair_max * (m.P - 1),
                 "combined": 2 * m.comb_max * (m.P - 1)}[exchange]
        self._words = torch.tensor(words, dtype=torch.float32,
                                   device=self.device)
        self._prog = self._make_program()

    def _upload(self, np_data: ShardData) -> ShardData:
        """This process's shards of the fields the exchange reads, on the
        mesh's device; every other field is None."""
        names = _VERTEX_FIELDS + _EXCHANGE_FIELDS[self.exchange]
        if self.backend == "kernel":
            names += _KERNEL_FIELDS.get(self.exchange, ())
        out = dict.fromkeys(ShardData._fields)
        for name in names:
            a = np.ascontiguousarray(getattr(np_data, name)[self.mesh.shards])
            t = torch.as_tensor(a, device=self.device)
            out[name] = t.long() if name in _INDEX_FIELDS else t
        return ShardData(**out)

    # ---------------- per-shard combines -------------------------------
    def _local_combine(self, d: ShardData, masked, combiner):
        """Per-shard combine over the CSC lanes: (B, S, Vm+1)."""
        if self._csc is not None:
            return kops.segment_combine_stacked(masked, self._csc, combiner)
        return kref.segment_combine(masked, d.seg, self.meta.v_max + 1,
                                    combiner)

    def _comb_combine(self, d: ShardData, masked, combiner):
        """Source-side combine over the combined lanes: one output slot
        per (destination shard, dst rank), (B, S, P*(R+1))."""
        if self._comb is not None:
            return kops.segment_combine_stacked(masked, self._comb, combiner)
        m = self.meta
        return kref.segment_combine(masked, d.comb_seg,
                                    m.P * (m.comb_max + 1), combiner)

    def _consume(self, d: ShardData, upd, upd_act):
        """Receiver-side scatter + gather against the local CSC lanes,
        given every shard's (B, P*Vm) update array."""
        k, Vm = self.kernel, self.meta.v_max
        B, S = upd.shape[0], d.src_slot.shape[0]
        idx = d.src_slot.view(-1)
        vals = upd.index_select(1, idx).view(B, S, -1)
        act = upd_act.index_select(1, idx).view(B, S, -1) & d.lane_valid
        msg = k.scatter(vals, d.w, d.src_gid, d.src_outdeg)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        masked = torch.where(act, msg, ident)
        acc = self._local_combine(d, masked, k.combiner)[..., :Vm]
        if k.got_from_identity:
            got = acc != ident
        else:
            got = self._local_combine(d, act.to(torch.int32),
                                      "max")[..., :Vm] > 0
        carry = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, d.w, d.src_gid, d.src_outdeg)
            winner = act & (masked == _take(acc, ident, d.seg))
            carry = self._local_combine(
                d, torch.where(winner, cvals, cident), "min")[..., :Vm]
        return acc, got, carry, act.sum(dim=2)

    def _fold_received(self, recv, recv_act, crecv, seg):
        """Receiver-side fold of all_to_all blocks (B, S, P, N) whose slots
        land on the local vertices ``seg`` (S, P, N): the oracle combine
        of the key, of the mail bit and, for a carry, of the winners'
        carries (the lexicographic (key, carry) fold of unicast)."""
        k, Vm = self.kernel, self.meta.v_max
        B, S = recv.shape[:2]
        seg = seg.reshape(S, -1)
        recv, recv_act = recv.reshape(B, S, -1), recv_act.reshape(B, S, -1)
        acc = kref.segment_combine(recv, seg, Vm, k.combiner)
        got = kref.segment_combine(recv_act.to(torch.int32), seg, Vm,
                                   "max") > 0
        carry = None
        if crecv is not None:
            ident = kops.identity_for(k.combiner, k.msg_dtype)
            cident = kops.identity_for("min", k.carry_dtype)
            winner = recv_act & (recv == _take(acc, ident, seg))
            carry = kref.segment_combine(
                torch.where(winner, crecv.reshape(B, S, -1), cident), seg,
                Vm, "min")
        return acc, got, carry

    # ---------------- exchanges -----------------------------------------
    def _deliver_allgather(self, d: ShardData, payload, active):
        B = payload.shape[0]
        upd = self.mesh.all_gather(payload).reshape(B, -1)    # (B, P*Vm)
        upd_act = self.mesh.all_gather(active).reshape(B, -1)
        acc, got, carry, n_msgs = self._consume(d, upd, upd_act)
        return acc, got, carry, {"n_msgs": n_msgs, "words": self._words}

    def _deliver_unicast(self, d: ShardData, payload, active):
        """GraVF baseline: source-side scatter + all_to_all blocks of
        ``e_pair_max`` padded edge slots per (shard, peer)."""
        k, mesh = self.kernel, self.mesh
        vals = _gather_src(payload, d.pair_src_local)       # (B, S, P, E2)
        act = _gather_src(active, d.pair_src_local) & d.pair_valid
        msg = k.scatter(vals, d.pair_w, d.pair_src_gid, d.pair_src_outdeg)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        recv = mesh.all_to_all(torch.where(act, msg, ident))
        recv_act = mesh.all_to_all(act)
        crecv = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, d.pair_w, d.pair_src_gid,
                                    d.pair_src_outdeg)
            crecv = mesh.all_to_all(torch.where(act, cvals, cident))
        acc, got, carry = self._fold_received(recv, recv_act, crecv,
                                              d.recv_dst_local)
        n_msgs = act.flatten(2).sum(dim=2)
        return acc, got, carry, {"n_msgs": n_msgs, "words": self._words}

    def _deliver_combined(self, d: ShardData, payload, active):
        """Combine at the source: fold the per-edge messages to one
        partial per (destination shard, destination vertex) before the
        wire, then all_to_all blocks of ``comb_max`` slots; the receiver
        merges the partials with the same monoid (exact for min/max; SSSP's
        carry rides the same two-level winner select as unicast)."""
        k, m, mesh = self.kernel, self.meta, self.mesh
        R = m.comb_max
        vals = _gather_src(payload, d.comb_src_local)       # (B, S, CL)
        act = _gather_src(active, d.comb_src_local) & d.comb_valid
        msg = k.scatter(vals, d.comb_w, d.comb_src_gid, d.comb_src_outdeg)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        masked = torch.where(act, msg, ident)
        B, S = masked.shape[:2]

        def slots(x):
            """(B, S, P*(R+1)) segments -> the (B, S, P, R) wire slots."""
            return x.reshape(B, S, m.P, R + 1)[..., :R]

        accs = self._comb_combine(d, masked, k.combiner)   # (B, S, P*(R+1))
        send_act = slots(self._comb_combine(d, act.to(torch.int32),
                                            "max")) > 0
        recv = mesh.all_to_all(slots(accs))
        recv_act = mesh.all_to_all(send_act)
        crecv = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, d.comb_w, d.comb_src_gid,
                                    d.comb_src_outdeg)
            # source-level winner: the edge whose key equals its (dest,
            # rank) slot's combined key; the min carry breaks ties
            win = act & (masked == _take(accs, ident, d.comb_seg))
            csend = self._comb_combine(d, torch.where(win, cvals, cident),
                                       "min")
            crecv = mesh.all_to_all(slots(csend))
        acc, got, carry = self._fold_received(recv, recv_act, crecv,
                                              d.comb_recv_dst_local)
        return acc, got, carry, {"n_msgs": act.sum(dim=2),
                                 "words": self._words}

    # ---------------- superstep program ---------------------------------
    def _make_program(self) -> SuperstepProgram:
        """Per-shard running stats, as the JAX engine keeps them: int64
        ``messages`` (the JAX engine's int32 sum wraps past 2**31) and
        float32 ``words``, both (B, S); the termination bit is reduced
        across the mesh (``pmax``)."""
        S, device, mesh = self._data.vert_gid.shape[0], self.device, self.mesh
        deliver = {"allgather": self._deliver_allgather,
                   "unicast": self._deliver_unicast,
                   "combined": self._deliver_combined}[self.exchange]

        def init_stats(batch):
            return {"messages": torch.zeros(batch, S, dtype=torch.int64,
                                            device=device),
                    "words": torch.zeros(batch, S, dtype=torch.float32,
                                         device=device)}

        def update_stats(stats, data, active, aux):
            return {"messages": stats["messages"] + aux["n_msgs"],
                    "words": stats["words"] + aux["words"]}

        def global_any(live):
            return mesh.pmax(live.to(torch.int32)) > 0

        return SuperstepProgram(self.kernel, deliver, init_stats=init_stats,
                                update_stats=update_stats,
                                global_any=global_any)

    # ---------------- entry points --------------------------------------
    def _global_state(self, v: torch.Tensor) -> torch.Tensor:
        """A state leaf over every shard: per-vertex (B, S, Vm) leaves are
        all-gathered to (B, P, Vm); a per-query leaf (B,) is held once by
        every shard, (B, P), as the JAX engine returns it."""
        if v.dim() < 3:
            v = v.unsqueeze(1).expand(v.shape[0], self._data.vert_gid.shape[0])
        return self.mesh.all_gather(v)

    def _result_comm(self, words: float) -> Dict[str, Any]:
        return {"exchange_words": words, "wire_words": words,
                "exchange": self.exchange,
                "scheme": f"shard_{self.exchange}"}

    def _run(self, max_supersteps, qkw, batch, per_query_words: bool):
        cap = (max_supersteps or self.kernel.max_supersteps
               or HARD_SUPERSTEP_CAP)
        c = self._prog.run_loop(self._data, cap, self.params, qkw, batch)
        mesh = self.mesh
        messages = mesh.psum(c.stats["messages"], dim=1).cpu().numpy()
        if per_query_words:
            words = mesh.psum(c.stats["words"], dim=1).cpu().numpy()
        else:   # the batch shares the wire: one total, summed per shard
            words = np.full(batch, mesh.psum(c.stats["words"].sum(dim=0),
                                             dim=0).item(), np.float32)
        state = state_to_numpy({kk: self._global_state(v)
                                for kk, v in c.state.items()})
        steps = c.superstep.cpu().numpy()
        results = []
        for q in range(batch):
            state_q = {kk: v[q] for kk, v in state.items()}
            results.append(EngineResult(
                state=collect(self.pg, state_q),
                supersteps=int(steps[q]),
                messages=int(messages[q]),
                comm=self._result_comm(float(words[q])),
                raw_state=state_q,
            ))
        return results

    @staticmethod
    def _no_overlap(overlap: bool) -> None:
        if overlap:
            raise NotImplementedError(
                "overlap=True (the pipelined exchanges) is not ported yet "
                "(ROADMAP §1 item 7, step 5)")

    def run(self, max_supersteps: Optional[int] = None,
            overlap: bool = False, **query_kwargs) -> EngineResult:
        """Single query; ``query_kwargs`` (e.g. ``root=7``) override the
        kernel's defaults. Every process of the mesh returns the whole
        (global) result."""
        self._no_overlap(overlap)
        qkw = query_tensors(self.kernel, query_kwargs, self.device,
                            batch=False)
        return self._run(max_supersteps, qkw, 1, per_query_words=True)[0]

    def run_batch(self, max_supersteps: Optional[int] = None,
                  overlap: bool = False,
                  **query_arrays) -> "list[EngineResult]":
        """One superstep loop over a leading query axis, each query equal
        to its solo :meth:`run`; ``exchange_words`` is the whole batch's,
        on every entry (the queries share the wire)."""
        self._no_overlap(overlap)
        qkw = query_tensors(self.kernel, query_arrays, self.device,
                            batch=True)
        return self._run(max_supersteps, qkw, batch_size(qkw),
                         per_query_words=False)

    @property
    def device_nbytes(self) -> int:
        """Bytes of this process's shards of the layout on the device."""
        return int(sum(t.numel() * t.element_size() for t in self._data
                       if t is not None))

    # ---------------- not ported yet ------------------------------------
    def make_stepper(self, width: int, overlap: bool = False):
        raise NotImplementedError(
            "ShardEngine.make_stepper (ShardLaneStepper) is not ported yet "
            "(ROADMAP §1 item 7, step 6)")

    def lane_result(self, carry_host, lane: int):
        raise NotImplementedError(
            "ShardEngine.lane_result (ShardLaneStepper) is not ported yet "
            "(ROADMAP §1 item 7, step 6)")

    def offload(self) -> int:
        raise NotImplementedError(
            "ShardEngine.offload is not ported yet (ROADMAP §1 item 7, "
            "step 7)")

    def upload(self) -> float:
        raise NotImplementedError(
            "ShardEngine.upload is not ported yet (ROADMAP §1 item 7, "
            "step 7)")
