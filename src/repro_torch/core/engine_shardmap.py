"""The explicit-collective GraVF-M shard engine in PyTorch (twin of
``repro.core.engine_shardmap``'s :class:`ShardEngine` and
:class:`ShardLaneStepper`).

The paper's system is a set of shards that share no memory and exchange
updates over an interconnect. Each superstep every shard applies, ships
its updates through one of five exchanges, and folds what it received:

  exchange="allgather" — GraVF-M: every shard's dense update array goes
      to every peer (one all_gather), then receiver-side scatter and a
      segment-combine over the shard's destination-partitioned lanes
      (K2, ``kernels/ops.py:segment_combine_stacked``).
  exchange="ring"      — the floating-barrier analogue (§4.3): the
      broadcast as P-1 ``ppermute`` hops around the mesh ring; each shard
      folds the chunk it holds against the bucket of edges whose source
      shard sent it, hop by hop, before apply runs.
  exchange="frontier"  — each shard compacts its ACTIVE updates into a
      capacity-bounded (id, payload) buffer; the smallest capacity bucket
      that holds the largest frontier is broadcast, then consumed as
      allgather's (K2).
  exchange="unicast"   — the GraVF baseline: per-edge messages built at
      the source, shipped in padded per-(source, destination shard)
      blocks with one all_to_all, folded at the receiver.
  exchange="combined"  — combine at the source: the per-edge messages are
      folded per (destination shard, destination vertex) first (K2 over
      the shard's dst-sorted per-pair lanes), so the all_to_all carries
      one slot per remote destination instead of one per edge.

The ring's per-bucket folds and the receiver-side folds of unicast and
combined use the ``scatter_reduce_`` oracle, as the JAX engine uses its
oracle there.

Every exchange also has an overlapped (pipelined) schedule, chosen per
run or stepper with ``overlap=True``, that issues the next transfer
before it folds the current one: allgather and frontier as P
``ppermute`` hops placed into each shard's own receive arrays; the ring
issues hop i+1 before folding chunk i; unicast and combined send their
blocks in ``OVERLAP_WINDOWS`` column windows, window k+1 in flight while
window k folds, the windows merged lexicographically (exact for min and
max only: an ``add`` combiner raises ValueError there). The results,
messages and reported words equal the synchronous schedule's; on a
``LocalMesh`` there is no wire and so nothing to overlap.

The per-shard code is written once over an explicit local-shard axis:
per-vertex arrays are ``(B, S, Vm)``, query axis first, with ``S`` the
shards this process holds (:mod:`repro_torch.core.mesh`): all ``P`` on
one device with :class:`~repro_torch.core.mesh.LocalMesh`, one per rank
with :class:`~repro_torch.core.mesh.ProcessGroupMesh`. States, supersteps,
messages and wire words equal the JAX engine's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..convert import state_to_numpy
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.layout import build_layout, stack_layouts, stacked_layout
from .engine import (HARD_SUPERSTEP_CAP, EngineResult, batch_size, collect,
                     query_tensors)
from .gas import GasKernel
from .mesh import LocalMesh
from .partition import PartitionedGraph
from .stepper import (LaneStepper, StepCarry, SuperstepProgram, _sync,
                      tree_map, tree_nbytes)

__all__ = ["EXCHANGES", "ShardData", "ShardEngine", "ShardLaneStepper",
           "ShardMeta", "abstract_shard_data", "build_shard_data"]

EXCHANGES = ("allgather", "ring", "frontier", "unicast", "combined")


class ShardData(NamedTuple):
    """The JAX ``ShardData`` fields (numpy, leading shard axis ``P``),
    plus ``tile_start`` and ``comb_tile_start``: the per-shard window tile
    ranges the stacked combine walks. An engine's device copy also holds
    the stacked kernel layouts built from them (``csc``, ``comb``)."""
    vert_gid: Any        # (P, Vm)
    vert_valid: Any      # (P, Vm)
    out_deg: Any         # (P, Vm)
    flt_cnt: Any         # (P, Vm)
    # CSC lanes in kernel layout (allgather, frontier)
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
    # ring buckets: in-edges grouped by SOURCE shard
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
    # device only: the stacked layouts K2 folds over (backend="kernel")
    csc: Any = None           # StackedLayout of tile_start/rel
    comb: Any = None          # StackedLayout of comb_tile_start/comb_rel


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
_CSC_FIELDS = ("src_slot", "src_gid", "src_outdeg", "w", "lane_valid", "seg")
_RING_FIELDS = ("rb_src_local", "rb_src_gid", "rb_src_outdeg", "rb_w",
                "rb_dst_local", "rb_valid")
_EXCHANGE_FIELDS = {
    "allgather": _CSC_FIELDS,
    "ring": _RING_FIELDS,
    "frontier": _CSC_FIELDS,
    "unicast": ("pair_src_local", "pair_src_gid", "pair_src_outdeg",
                "pair_w", "pair_valid", "recv_dst_local"),
    "combined": ("comb_src_local", "comb_src_gid", "comb_src_outdeg",
                 "comb_w", "comb_valid", "comb_seg", "comb_recv_dst_local"),
}
_KERNEL_FIELDS = {"allgather": ("tile_start", "rel"),
                  "frontier": ("tile_start", "rel"),
                  "combined": ("comb_tile_start", "comb_rel")}
_INDEX_FIELDS = ("src_slot", "seg", "rb_src_local", "rb_dst_local",
                 "pair_src_local", "recv_dst_local", "comb_src_local",
                 "comb_seg", "comb_recv_dst_local")


def abstract_shard_data(meta: ShardMeta,
                        exchange: str = "allgather") -> ShardData:
    """Stand-ins on the ``meta`` device for the dry-run (no allocation):
    the fields that ``exchange`` reads on the device with
    ``backend="ref"``, at the port's shapes and dtypes, every other field
    None. The shapes are the JAX ``abstract_shard_data``'s; the gather
    indices (``_INDEX_FIELDS``) are int64, 8 bytes a lane where JAX's are
    int32."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, "
                         f"got {exchange!r}")
    P, Vm, E2 = meta.P, meta.v_max, meta.e_pair_max
    lanes = {"src_": (P, meta.n_tiles * meta.tile_e),
             "rb_": (P, P, E2), "pair_": (P, P, E2),
             "comb_": (P, meta.comb_tiles * meta.tile_e)}
    shapes = {"vert_gid": (P, Vm), "vert_valid": (P, Vm), "out_deg": (P, Vm),
              "w": lanes["src_"], "lane_valid": lanes["src_"],
              "seg": lanes["src_"], "recv_dst_local": (P, P, E2),
              "comb_recv_dst_local": (P, P, meta.comb_max)}
    out = dict.fromkeys(ShardData._fields)
    for name in _VERTEX_FIELDS + _EXCHANGE_FIELDS[exchange]:
        shape = shapes.get(name) or next(
            v for k, v in lanes.items() if name.startswith(k))
        if name in _INDEX_FIELDS:
            dtype = torch.int64
        elif name.endswith("valid"):
            dtype = torch.bool
        elif name.endswith("w"):
            dtype = torch.float32
        else:
            dtype = torch.int32
        out[name] = torch.empty(shape, dtype=dtype, device="meta")
    return ShardData(**out)


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


def _hop_order(a: np.ndarray) -> np.ndarray:
    """A (P, P, ...) ring-bucket field in the order the ring consumes it:
    ``out[p, i] = a[p, (p - i) % P]``, the bucket of the chunk shard ``p``
    holds at hop ``i`` (the chunk of source shard ``p - i``)."""
    P = a.shape[0]
    shard = np.arange(P)[:, None]
    return np.ascontiguousarray(a[shard, (shard - np.arange(P)) % P])


class ShardEngine:
    """Runs one (kernel, graph) pair over the shards of a mesh."""

    # Column windows of the overlapped all_to_all pipelines (unicast and
    # combined): the collective for window k+1 is issued before window k
    # is folded.
    OVERLAP_WINDOWS = 4

    def __init__(self, kernel: GasKernel, pg_or_meta, *,
                 mesh=None, exchange: str = "allgather",
                 backend: str = "kernel", tile_e: int = 512,
                 tile_r: int = 256, params: Optional[Dict[str, Any]] = None,
                 shard_data: Optional[tuple] = None):
        """``pg_or_meta`` is a :class:`PartitionedGraph`, or a
        :class:`ShardMeta` for the dry-run: such an engine holds no data,
        runs ``backend="ref"`` (the kernel's work list is built from real
        data on the host) and serves :meth:`superstep_fn` over
        :func:`abstract_shard_data`. ``mesh`` defaults to
        ``LocalMesh(P)`` on the card. ``shard_data`` is
        ``build_shard_data(pg, tile_e=, tile_r=)``'s result, to share one
        host build between engines."""
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, "
                             f"got {exchange!r}")
        if backend not in ("kernel", "ref"):
            raise ValueError(f"backend must be 'kernel' or 'ref', "
                             f"got {backend!r}")
        graph = isinstance(pg_or_meta, PartitionedGraph)
        if not graph and backend != "ref":
            raise ValueError("an engine over a ShardMeta runs "
                             "backend='ref'")
        P = pg_or_meta.num_parts if graph else pg_or_meta.P
        self.mesh = LocalMesh(P) if mesh is None else mesh
        if self.mesh.num_shards != P:
            raise ValueError(f"mesh has {self.mesh.num_shards} shards, the "
                             f"graph {P}")
        self.device = self.mesh.device
        self.kernel = kernel
        self.exchange = exchange
        self.backend = backend
        self.params = dict(params or {})
        if graph:
            self.pg = pg_or_meta
            if shard_data is None:
                shard_data = build_shard_data(pg_or_meta, tile_e=tile_e,
                                              tile_r=tile_r)
            np_data, self.meta = shard_data
            if (self.meta.tile_e, self.meta.tile_r) != (tile_e, tile_r):
                raise ValueError("shard_data was built with other tiles")
            self._data = self._upload(np_data)
        else:
            self.pg, self.meta, self._data = None, pg_or_meta, None
        self.params.setdefault("num_vertices", self.meta.num_vertices)
        m, dev = self.meta, self.device
        # wire words a shard puts on the wire each superstep (frontier's
        # depend on the superstep's frontier: _frontier_buffers)
        words = {"allgather": m.v_max * (m.P - 1),
                 "ring": m.v_max * (m.P - 1),
                 "frontier": 0,
                 "unicast": m.e_pair_max * (m.P - 1),
                 "combined": 2 * m.comb_max * (m.P - 1)}[exchange]
        self._words = torch.tensor(words, dtype=torch.float32, device=dev)
        # the global ids of this process's shards, and the peer whose
        # chunk each of them holds at ring hop i: (P, S)
        shard = torch.arange(self.mesh.shards.start, self.mesh.shards.stop,
                             device=dev)
        self._shard = shard
        self._hop_peer = (shard[None, :]
                          - torch.arange(m.P, device=dev)[:, None]) % m.P
        if exchange == "frontier":
            self._caps_host = tuple(m.frontier_capacities)
            self._caps = torch.tensor(self._caps_host, dtype=torch.int64,
                                      device=dev)
            self._vids = torch.arange(m.v_max, device=dev)
        # Trace accounting, as Engine's: one count the first time each
        # program runs at each shape (run per superstep cap, query-argument
        # set and schedule, run_batch per batch size too, each stepper
        # program per width and schedule).
        self.traces = 0
        self._traced: set = set()
        self._trace_lock = threading.Lock()
        self._device_resident = graph
        # one program per schedule; the overlapped one is built on first
        # use (it refuses an add combiner on unicast/combined); both share
        # this engine's device data
        self._progs: Dict[bool, SuperstepProgram] = {
            False: self._make_program(False)}
        self._steppers: Dict[Any, "ShardLaneStepper"] = {}

    def _upload(self, np_data: ShardData) -> ShardData:
        """This process's shards of the fields the exchange reads, on the
        mesh's device (the ring's buckets in hop order, ``_hop_order``),
        with the stacked kernel layouts in ``csc``/``comb``; every other
        field is None."""
        names = _VERTEX_FIELDS + _EXCHANGE_FIELDS[self.exchange]
        if self.backend == "kernel":
            names += _KERNEL_FIELDS.get(self.exchange, ())
        out = dict.fromkeys(ShardData._fields)
        for name in names:
            a = getattr(np_data, name)
            if name in _RING_FIELDS:
                a = _hop_order(a)
            a = np.ascontiguousarray(a[self.mesh.shards])
            t = torch.as_tensor(a, device=self.device)
            out[name] = t.long() if name in _INDEX_FIELDS else t
        m = self.meta
        if out["tile_start"] is not None:
            out["csc"] = stacked_layout(out["tile_start"], out["rel"],
                                        m.tile_e, m.tile_r, m.v_max + 1)
        if out["comb_tile_start"] is not None:
            out["comb"] = stacked_layout(
                out["comb_tile_start"], out["comb_rel"], m.tile_e, m.tile_r,
                m.P * (m.comb_max + 1))
        return ShardData(**out)

    # ---------------- per-shard combines -------------------------------
    def _local_combine(self, d: ShardData, masked, combiner):
        """Per-shard combine over the CSC lanes: (B, S, Vm+1)."""
        if d.csc is not None:
            return kops.segment_combine_stacked(masked, d.csc, combiner)
        return kref.segment_combine(masked, d.seg, self.meta.v_max + 1,
                                    combiner)

    def _comb_combine(self, d: ShardData, masked, combiner):
        """Source-side combine over the combined lanes: one output slot
        per (destination shard, dst rank), (B, S, P*(R+1))."""
        if d.comb is not None:
            return kops.segment_combine_stacked(masked, d.comb, combiner)
        m = self.meta
        return kref.segment_combine(masked, d.comb_seg,
                                    m.P * (m.comb_max + 1), combiner)

    def _consume(self, d: ShardData, upd, upd_act):
        """Receiver-side scatter + gather against the local CSC lanes,
        given every shard's update array: (B, P*Vm) shared by the local
        shards, or (B, S, P*Vm), one per local shard."""
        k, Vm = self.kernel, self.meta.v_max
        B, S = upd.shape[0], d.src_slot.shape[0]
        if upd.dim() == 2:
            idx = d.src_slot.view(-1)
            vals = upd.index_select(1, idx).view(B, S, -1)
            act = upd_act.index_select(1, idx).view(B, S, -1)
        else:
            idx = d.src_slot.expand((B,) + d.src_slot.shape)
            vals = torch.gather(upd, 2, idx)
            act = torch.gather(upd_act, 2, idx)
        act = act & d.lane_valid
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

    # ---------------- two-operand folds (ring, windowed pipelines) ------
    def _combine2(self, a, b):
        """Two-operand fold of the kernel's combiner monoid."""
        k = self.kernel
        if k.combiner == "add":
            return a + b
        return torch.minimum(a, b) if k.combiner == "min" else \
            torch.maximum(a, b)

    def _merge_carry(self, ckey, ccar, acc_q, car_q):
        """Lexicographic fold of (key, carry) candidates: the two-level
        winner select the ring and the windowed folds use to keep SSSP's
        carried parent equal to the one-shot fold's."""
        better = acc_q < ckey if self.kernel.combiner == "min" \
            else acc_q > ckey
        ccar = torch.where(better, car_q,
                           torch.where(acc_q == ckey,
                                       torch.minimum(ccar, car_q), ccar))
        return self._combine2(ckey, acc_q), ccar

    def _empty_fold(self, B: int, S: int):
        """The accumulators a fold of partials starts from: key at the
        identity, no mail, carry at the min identity (None without one)."""
        k, Vm, dev = self.kernel, self.meta.v_max, self.device
        acc = torch.full((B, S, Vm), kops.identity_for(k.combiner,
                                                       k.msg_dtype),
                         dtype=k.msg_dtype, device=dev)
        got = torch.zeros((B, S, Vm), dtype=torch.bool, device=dev)
        ccar = None
        if k.carry_dtype is not None:
            ccar = torch.full((B, S, Vm), kops.identity_for(
                "min", k.carry_dtype), dtype=k.carry_dtype, device=dev)
        return acc, got, ccar

    def _fold_partial(self, acc, ccar, acc_q, car_q):
        if ccar is not None:
            return self._merge_carry(acc, ccar, acc_q, car_q)
        return self._combine2(acc, acc_q), None

    # ---------------- exchanges -----------------------------------------
    def _deliver_allgather(self, d: ShardData, payload, active):
        B = payload.shape[0]
        upd = self.mesh.all_gather(payload).reshape(B, -1)    # (B, P*Vm)
        upd_act = self.mesh.all_gather(active).reshape(B, -1)
        acc, got, carry, n_msgs = self._consume(d, upd, upd_act)
        return acc, got, carry, {"n_msgs": n_msgs, "words": self._words}

    def _deliver_allgather_ov(self, d: ShardData, payload, active):
        """Pipelined allgather: the broadcast as P ppermute hops placed
        into each shard's own receive array (the gather's result), the
        next hop issued before a chunk is placed; then one receiver-side
        consume, so everything equals the one-shot gather."""
        mesh, P = self.mesh, self.meta.P
        B, S, Vm = payload.shape
        upd = payload.new_empty((B, S, P, Vm))
        upd_act = active.new_empty((B, S, P, Vm))
        local = torch.arange(S, device=self.device)
        cur = (payload, active)
        for i in range(P):
            nxt = ([mesh.ppermute_async(t) for t in cur] if i + 1 < P
                   else None)
            upd[:, local, self._hop_peer[i]] = cur[0]
            upd_act[:, local, self._hop_peer[i]] = cur[1]
            if nxt is not None:
                cur = tuple(h.wait() for h in nxt)
        acc, got, carry, n_msgs = self._consume(
            d, upd.view(B, S, P * Vm), upd_act.view(B, S, P * Vm))
        return acc, got, carry, {"n_msgs": n_msgs, "words": self._words}

    def _ring_bucket_consume(self, d: ShardData, i: int, chunk_p, chunk_a):
        """Scatter+gather the edges whose source shard sent the chunk each
        shard holds at hop ``i`` (bucket ``i`` of the hop-ordered fields),
        folded by the oracle as the reference folds them."""
        k, Vm = self.kernel, self.meta.v_max
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        b_src, w = d.rb_src_local[:, i], d.rb_w[:, i]
        gid, outdeg = d.rb_src_gid[:, i], d.rb_src_outdeg[:, i]
        seg = d.rb_dst_local[:, i]
        vals = _gather_src(chunk_p, b_src)                  # (B, S, E2)
        act = _gather_src(chunk_a, b_src) & d.rb_valid[:, i]
        masked = torch.where(act, k.scatter(vals, w, gid, outdeg), ident)
        acc_q = kref.segment_combine(masked, seg, Vm, k.combiner)
        got_q = kref.segment_combine(act.to(torch.int32), seg, Vm,
                                     "max") > 0
        car_q = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, w, gid, outdeg)
            win = act & (masked == _take(acc_q, ident, seg))
            car_q = kref.segment_combine(torch.where(win, cvals, cident),
                                         seg, Vm, "min")
        return acc_q, got_q, car_q, act.sum(dim=2)

    def _ring(self, d: ShardData, payload, active, overlap: bool):
        """P-hop ppermute ring: each shard folds the chunk it holds against
        the matching source-shard bucket, hop by hop in the same order in
        both schedules; the overlapped one issues hop i+1's transfer
        before folding chunk i, the synchronous one after."""
        mesh, P = self.mesh, self.meta.P
        B, S = payload.shape[:2]
        acc, got, ccar = self._empty_fold(B, S)
        n_msgs = 0
        cur = (payload, active)
        for i in range(P):
            last = i + 1 == P
            nxt = (None if last or not overlap
                   else [mesh.ppermute_async(t) for t in cur])
            acc_q, got_q, car_q, nm = self._ring_bucket_consume(d, i, *cur)
            acc, ccar = self._fold_partial(acc, ccar, acc_q, car_q)
            got = got | got_q
            n_msgs = n_msgs + nm
            if nxt is not None:
                cur = tuple(h.wait() for h in nxt)
            elif not last:
                cur = tuple(mesh.ppermute(t) for t in cur)
        # the ring moves the same dense words as allgather, in P-1 hops
        return acc, got, ccar, {"n_msgs": n_msgs, "words": self._words}

    def _deliver_ring(self, d: ShardData, payload, active):
        return self._ring(d, payload, active, overlap=False)

    def _deliver_ring_ov(self, d: ShardData, payload, active):
        return self._ring(d, payload, active, overlap=True)

    def _frontier_buffers(self, payload, active):
        """Each shard's active updates compacted, in vertex order, into a
        (B, S, cap) buffer of (global slot, payload, valid), with ``cap``
        the smallest capacity bucket that holds the largest frontier of
        the batch. The bucket is picked on the host after one read of the
        all-reduced frontier sizes (the JAX engine switches on the
        device); a larger buffer than a query's own bucket changes no
        value, and each query's words are its own bucket's, as JAX's.
        On the ``meta`` device (the dry-run) nothing can be read: the
        buffer takes the largest bucket, the most bytes a superstep can
        move, which is what JAX's ``lax.switch`` traces too."""
        m, mesh = self.meta, self.mesh
        B, S, Vm = active.shape
        n_max = mesh.pmax(active.sum(dim=2), dim=1)               # (B,)
        sel = torch.searchsorted(self._caps, n_max).clamp(
            max=len(self._caps_host) - 1)
        words = (self._caps[sel] * (2 * (m.P - 1))).to(torch.float32)
        cap = self._caps_host[-1 if active.is_meta else int(sel.max())]
        pos = torch.where(active, active.cumsum(dim=2) - 1, cap)
        ids = torch.full((B, S, cap + 1), Vm, dtype=torch.int64,
                         device=self.device)
        ids = ids.scatter_(2, pos, self._vids.expand(B, S, Vm))[..., :cap]
        valid = ids < Vm
        safe = ids.clamp(max=Vm - 1)
        slots = self._shard.view(1, S, 1) * Vm + safe
        return slots, torch.gather(payload, 2, safe), valid, words[:, None]

    def _deliver_frontier(self, d: ShardData, payload, active):
        """Compact ACTIVE updates to (id, payload) pairs and broadcast the
        smallest sufficient capacity bucket. Slot owners are unique, so
        the scatter-set of the received pairs is exact."""
        k, m, mesh = self.kernel, self.meta, self.mesh
        B = payload.shape[0]
        slots, pay, valid, words = self._frontier_buffers(payload, active)
        drop = m.P * m.v_max
        valid_all = mesh.all_gather(valid).reshape(B, -1)
        tgt = torch.where(valid_all, mesh.all_gather(slots).reshape(B, -1),
                          drop)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        pf = pay.new_full((B, drop + 1), ident).scatter_(
            1, tgt, mesh.all_gather(pay).reshape(B, -1))
        af = valid.new_zeros((B, drop + 1)).scatter_(1, tgt, valid_all)
        acc, got, carry, n_msgs = self._consume(d, pf[:, :drop],
                                                af[:, :drop])
        return acc, got, carry, {"n_msgs": n_msgs, "words": words}

    def _deliver_frontier_ov(self, d: ShardData, payload, active):
        """Pipelined frontier: the same compact buffers ring around in P
        ppermute hops, each arriving chunk scatter-set into the shard's
        own receive arrays while the next hop is in flight."""
        k, m, mesh = self.kernel, self.meta, self.mesh
        B, S = payload.shape[:2]
        slots, pay, valid, words = self._frontier_buffers(payload, active)
        drop = m.P * m.v_max
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        pf = pay.new_full((B, S, drop + 1), ident)
        af = valid.new_zeros((B, S, drop + 1))
        cur = (slots, pay, valid)
        for i in range(m.P):
            nxt = ([mesh.ppermute_async(t) for t in cur] if i + 1 < m.P
                   else None)
            tgt = torch.where(cur[2], cur[0], drop)
            pf.scatter_(2, tgt, cur[1])
            af.scatter_(2, tgt, cur[2])
            if nxt is not None:
                cur = tuple(h.wait() for h in nxt)
        acc, got, carry, n_msgs = self._consume(d, pf[..., :drop],
                                                af[..., :drop])
        return acc, got, carry, {"n_msgs": n_msgs, "words": words}

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
        k, mesh = self.kernel, self.mesh
        act, send, send_act, csend = self._combined_send(
            d, payload, active, with_act=True)
        recv = mesh.all_to_all(send)
        recv_act = mesh.all_to_all(send_act)
        crecv = None if csend is None else mesh.all_to_all(csend)
        acc, got, carry = self._fold_received(recv, recv_act, crecv,
                                              d.comb_recv_dst_local)
        return acc, got, carry, {"n_msgs": act.sum(dim=2),
                                 "words": self._words}

    def _combined_send(self, d: ShardData, payload, active, with_act: bool):
        """The combined exchange's source side: the lanes' mail bits and
        the per-(peer, rank) wire slots (B, S, P, R) of the key, of the
        mail bit (``with_act``, else None) and of the winners' carries
        (None without a carry), folded by K2."""
        k, m = self.kernel, self.meta
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
        send_act = None
        if with_act:
            send_act = slots(self._comb_combine(d, act.to(torch.int32),
                                                "max")) > 0
        csend = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, d.comb_w, d.comb_src_gid,
                                    d.comb_src_outdeg)
            # source-level winner: the edge whose key equals its (dest,
            # rank) slot's combined key; the min carry breaks ties
            win = act & (masked == _take(accs, ident, d.comb_seg))
            csend = slots(self._comb_combine(
                d, torch.where(win, cvals, cident), "min"))
        return act, slots(accs), send_act, csend

    # ---------------- overlapped all_to_all pipelines -------------------
    def _n_windows(self, extent: int) -> int:
        return max(1, min(self.OVERLAP_WINDOWS, int(extent)))

    @staticmethod
    def _window3(a: torch.Tensor, n_win: int, cw: int, fill):
        """(..., P, E) -> (..., P, n_win, cw) column windows, padded with
        ``fill``."""
        pad = n_win * cw - a.shape[-1]
        if pad:
            a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), fill)], -1)
        return a.reshape(a.shape[:-1] + (n_win, cw))

    def _window_pipeline(self, seg3, masked3, act3, c3, n_win: int):
        """The chunked all_to_all pipeline of the overlapped unicast and
        combined exchanges: window k+1's collectives are issued before
        window k's receive block is folded. Per-window partials merge
        lexicographically (``_merge_carry``), exact for min/max. ``act3``
        None drops the mail-bit stream (a ``got_from_identity`` kernel:
        mail is ``recv != identity``); ``c3`` None drops the carry's."""
        k, Vm, mesh = self.kernel, self.meta.v_max, self.mesh
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        B, S = masked3.shape[:2]

        def issue(w):
            return [None if x is None else mesh.all_to_all_async(x[..., w, :])
                    for x in (masked3, act3, c3)]

        acc, got, ccar = self._empty_fold(B, S)
        pending = issue(0)
        for w in range(n_win):
            nxt = issue(w + 1) if w + 1 < n_win else None
            bp, ba, bc = (None if h is None else h.wait() for h in pending)
            seg_w = seg3[..., w, :].reshape(S, -1)
            recv = bp.reshape(B, S, -1)
            acc_w = kref.segment_combine(recv, seg_w, Vm, k.combiner)
            if ba is not None:
                ract = ba.reshape(B, S, -1)
                got = got | (kref.segment_combine(
                    ract.to(torch.int32), seg_w, Vm, "max") > 0)
            else:
                ract = recv != ident
            car_w = None
            if bc is not None:
                cident = kops.identity_for("min", k.carry_dtype)
                win = ract & (recv == _take(acc_w, ident, seg_w))
                car_w = kref.segment_combine(
                    torch.where(win, bc.reshape(B, S, -1), cident), seg_w,
                    Vm, "min")
            acc, ccar = self._fold_partial(acc, ccar, acc_w, car_w)
            pending = nxt
        if act3 is None:
            got = acc != ident
        return acc, got, ccar

    def _deliver_unicast_ov(self, d: ShardData, payload, active):
        """Overlapped GraVF baseline: the per-pair message blocks cross
        the wire in column windows, window k+1 in flight while window k
        folds at the receiver."""
        k, m = self.kernel, self.meta
        vals = _gather_src(payload, d.pair_src_local)       # (B, S, P, E2)
        act = _gather_src(active, d.pair_src_local) & d.pair_valid
        msg = k.scatter(vals, d.pair_w, d.pair_src_gid, d.pair_src_outdeg)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        n_win = self._n_windows(m.e_pair_max)
        cw = -(-m.e_pair_max // n_win)
        masked3 = self._window3(torch.where(act, msg, ident), n_win, cw,
                                ident)
        seg3 = self._window3(d.recv_dst_local, n_win, cw, m.v_max)
        act3 = (None if k.got_from_identity
                else self._window3(act, n_win, cw, False))
        c3 = None
        if k.carry_dtype is not None:
            cident = kops.identity_for("min", k.carry_dtype)
            cvals = k.scatter_carry(vals, d.pair_w, d.pair_src_gid,
                                    d.pair_src_outdeg)
            c3 = self._window3(torch.where(act, cvals, cident), n_win, cw,
                               cident)
        acc, got, carry = self._window_pipeline(seg3, masked3, act3, c3,
                                                n_win)
        # the words reported are the synchronous schedule's, so the stats
        # of both schedules compare
        return acc, got, carry, {"n_msgs": act.flatten(2).sum(dim=2),
                                 "words": self._words}

    def _deliver_combined_ov(self, d: ShardData, payload, active):
        """Overlapped combine-at-source: the source-side combine is the
        synchronous one (K2); the per-(peer, rank) slot blocks cross the
        wire in column windows behind the receiver fold."""
        k, m = self.kernel, self.meta
        R = m.comb_max
        act, send, send_act, csend = self._combined_send(
            d, payload, active, with_act=not k.got_from_identity)
        ident = kops.identity_for(k.combiner, k.msg_dtype)
        n_win = self._n_windows(R)
        cw = -(-R // n_win) if R else 0
        masked3 = self._window3(send, n_win, cw, ident)
        seg3 = self._window3(d.comb_recv_dst_local, n_win, cw, m.v_max)
        act3 = (None if send_act is None
                else self._window3(send_act, n_win, cw, False))
        c3 = None
        if csend is not None:
            c3 = self._window3(csend, n_win, cw,
                               kops.identity_for("min", k.carry_dtype))
        acc, got, carry = self._window_pipeline(seg3, masked3, act3, c3,
                                                n_win)
        return acc, got, carry, {"n_msgs": act.sum(dim=2),
                                 "words": self._words}

    # ---------------- superstep programs --------------------------------
    def _prog_for(self, overlap: bool) -> SuperstepProgram:
        """The superstep program of one schedule, built on first use."""
        overlap = bool(overlap)
        prog = self._progs.get(overlap)
        if prog is None:
            prog = self._progs[overlap] = self._make_program(overlap)
        return prog

    def _make_program(self, overlap: bool = False) -> SuperstepProgram:
        """Per-shard running stats, as the JAX engine keeps them: int64
        ``messages`` (the JAX engine's int32 sum wraps past 2**31) and
        float32 ``words``, both (B, S); the termination bit is reduced
        across the mesh (``pmax``)."""
        if overlap and self.exchange in ("unicast", "combined") \
                and self.kernel.combiner not in ("min", "max"):
            raise ValueError(
                "overlap=True windows the all_to_all receiver fold, which "
                "is only exact for min/max combiners; kernel "
                f"{self.kernel.name!r} combines with "
                f"{self.kernel.combiner!r}")
        mesh, device = self.mesh, self.device
        S = mesh.shards.stop - mesh.shards.start
        deliver = getattr(self, f"_deliver_{self.exchange}"
                          + ("_ov" if overlap else ""))

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

    # ---------------- dry-run hook --------------------------------------
    def superstep_fn(self):
        """One full synchronous superstep (deliver, gather, apply) as a
        function of ``(data, payload, active, state, superstep)``, the
        unit the dry-run runs on ``meta`` tensors: ``data`` is a
        :class:`ShardData` (``abstract_shard_data``), the others are a
        carry's leaves, ``superstep`` (B,) int32. Returns the next
        :class:`StepCarry`, its stats those of this superstep alone."""
        prog = self._prog_for(False)

        def superstep(data, payload, active, state, superstep):
            carry = StepCarry(state, payload, active, superstep,
                              prog.init_stats(superstep.shape[0]))
            return prog.step(data, carry)

        return superstep

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

    def _run(self, max_supersteps, qkw, batch, per_query_words: bool,
             overlap: bool):
        cap = (max_supersteps or self.kernel.max_supersteps
               or HARD_SUPERSTEP_CAP)
        prog = self._prog_for(overlap)
        self._note_trace(("run" if per_query_words else "run_batch", cap,
                          batch, tuple(sorted(qkw)), bool(overlap)))
        c = prog.run_loop(self._device_data(), cap, self.params, qkw, batch)
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

    def run(self, max_supersteps: Optional[int] = None,
            overlap: bool = False, **query_kwargs) -> EngineResult:
        """Single query; ``query_kwargs`` (e.g. ``root=7``) override the
        kernel's defaults. ``overlap=True`` runs the pipelined exchange
        schedule (the same results). Every process of the mesh returns
        the whole (global) result."""
        qkw = query_tensors(self.kernel, query_kwargs, self.device,
                            batch=False)
        return self._run(max_supersteps, qkw, 1, per_query_words=True,
                         overlap=overlap)[0]

    def run_batch(self, max_supersteps: Optional[int] = None,
                  overlap: bool = False,
                  **query_arrays) -> "list[EngineResult]":
        """One superstep loop over a leading query axis, each query equal
        to its solo :meth:`run`; ``exchange_words`` is the whole batch's,
        on every entry (the queries share the wire)."""
        qkw = query_tensors(self.kernel, query_arrays, self.device,
                            batch=True)
        return self._run(max_supersteps, qkw, batch_size(qkw),
                         per_query_words=False, overlap=overlap)

    # ---------------- trace accounting ----------------------------------
    def _note_trace(self, key) -> None:
        with self._trace_lock:
            if key not in self._traced:
                self._traced.add(key)
                self.traces += 1

    def _bump_traces(self) -> None:
        with self._trace_lock:
            self.traces += 1

    # ---------------- residency (see Engine.offload/upload) -------------
    @property
    def device_nbytes(self) -> int:
        """Bytes of this process's shards of the layout on the device (the
        kernel's stacked layouts included) — what :meth:`offload`
        demotes."""
        return tree_nbytes(self._data)

    @property
    def device_resident(self) -> bool:
        return self._device_resident

    def offload(self) -> int:
        """Demote the shard data to host copies (pinned when the engine
        runs on the card). Programs and steppers stay; a dispatch while
        offloaded stages the data to the device for that call, so it
        still runs there. Returns the bytes demoted."""
        if not self._device_resident:
            return 0
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)

        def host(t):
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=cuda).copy_(t)
        data = tree_map(host, self._data)
        self._rebind_data(data, resident=False)
        return tree_nbytes(data)

    def upload(self) -> float:
        """Promote offloaded shard data back to the device; nothing runs
        anew. Returns the wall seconds the upload took."""
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
        self._data = data
        self._device_resident = resident
        for st in list(self._steppers.values()):
            st.bind_data(data)

    def _device_data(self) -> ShardData:
        """The shard data on the device: the resident tensors, or a copy
        staged for this call while offloaded."""
        if self._device_resident:
            return self._data
        return tree_map(lambda t: t.to(self.device), self._data)

    # ---------------- step-granular entry point -------------------------
    def make_stepper(self, width: int,
                     overlap: bool = False) -> "ShardLaneStepper":
        """A host-drivable ``width``-lane slot array over the mesh (see
        ``Engine.make_stepper``): one superstep of every lane per call,
        with admit/retire between supersteps. Cached per (width,
        overlap); both schedules share this engine's device data, so
        toggling ``overlap`` per request runs nothing anew once both
        steppers are warm."""
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        key = (width, bool(overlap))
        st = self._steppers.get(key)
        if st is None:
            st = self._steppers[key] = ShardLaneStepper(self, width,
                                                        overlap=overlap)
        return st

    def lane_result(self, carry_host, lane: int) -> EngineResult:
        """Package one retired lane of a :meth:`ShardLaneStepper.fetch`
        carry as an :class:`EngineResult` (the fields of :meth:`run`);
        the per-shard stats are summed over the shard axis."""
        state_q = {}
        for kk, v in carry_host.state.items():
            v = np.asarray(v)[lane]
            # a per-query leaf, once per shard as run returns it
            state_q[kk] = v if v.ndim else np.full(self.meta.P, v, v.dtype)
        return EngineResult(
            state=collect(self.pg, state_q),
            supersteps=int(carry_host.superstep[lane]),
            messages=int(carry_host.stats["messages"][lane].sum()),
            comm=self._result_comm(
                float(carry_host.stats["words"][lane].sum())),
            raw_state=state_q,
        )


class ShardLaneStepper(LaneStepper):
    """W-lane continuous-stepping handle over a :class:`ShardEngine`
    (twin of the JAX ``ShardLaneStepper``).

    The verbs and their return contract are ``LaneStepper``'s. The carry
    keeps the port's query-first layout: per-vertex leaves are
    ``(W, S, Vm)`` and the stats ``(W, S)``, where the JAX carry is
    ``(P, W, ...)`` (its transpose); the superstep counters and
    per-query state leaves are ``(W,)``, held once for every shard.
    Each step runs the engine's exchange once for all W lanes. The
    packed probe holds each lane's alive bit (any vertex of any shard),
    its superstep counter and the wire words of every shard and lane,
    read to the host once per init/admit/step/restore; as the JAX
    stepper's probe, it counts no trace.

    ``fetch`` returns the whole mesh's carry (all-gathered across the
    processes of a ``ProcessGroupMesh``); ``fetch_lane`` returns one
    lane's slices of this process's shards, which is what ``restore``
    splices back. Profiled steps split a superstep into exchange (the
    deliver and the receiver fold), apply and probe; an overlapped
    stepper also times the synchronous exchange on the same carry
    (``exchange_serial``, its output unused), the denominator of the
    service's overlap efficiency.
    """

    def __init__(self, eng: ShardEngine, width: int, overlap: bool = False):
        self.eng = eng
        self.overlap = bool(overlap)
        prog = eng._prog_for(self.overlap)
        super().__init__(prog, eng._data, eng.params, width,
                         device=eng.device, trace_hook=eng._bump_traces,
                         wire_stat="words")
        self._probe = self._probe_of
        self._exchange_p = self._program("exchange", prog.step_exchange)
        self._exchange_serial_p = None
        if self.overlap:
            self._exchange_serial_p = self._program(
                "exchange_serial", eng._prog_for(False).step_exchange)

    def _wire_words(self, carry: StepCarry) -> torch.Tensor:
        return self.eng.mesh.psum(carry.stats["words"].sum())

    def fetch(self, carry: StepCarry) -> StepCarry:
        """Host copy of the whole mesh's carry: per-shard leaves
        all-gathered to (W, P, ...)."""
        mesh = self.eng.mesh
        return tree_map(
            lambda a: (mesh.all_gather(a) if a.dim() >= 2 else a).cpu()
            .numpy(), carry)

    def _profiled_step(self, carry: StepCarry, alive: np.ndarray):
        """Exchange / apply / probe with a device synchronize and a host
        timing boundary after each: the same ops and select as the fused
        step (the same results)."""
        d, alive_dev = self._dev(), self._lanes(alive)
        phases: Dict[str, float] = {}
        _sync(self.device)
        if self._exchange_serial_p is not None:
            t = time.perf_counter()
            self._exchange_serial_p(d, carry)
            _sync(self.device)
            phases["exchange_serial"] = time.perf_counter() - t
        t = time.perf_counter()
        mid = self._exchange_p(d, carry)
        _sync(self.device)
        now = time.perf_counter()
        phases["exchange"] = now - t
        t = now
        new = self._apply_p(d, carry, mid, alive_dev)
        _sync(self.device)
        now = time.perf_counter()
        phases["apply"] = now - t
        t = now
        new, act, steps = self._unpack((new, self._probe(new)))
        phases["probe"] = time.perf_counter() - t
        self.last_phases = phases
        return new, act, steps
