"""Step-granular superstep core (twin of ``repro.core.stepper``).

One superstep = deliver (broadcast + receiver-side scatter +
gather-combine) -> gather -> stats -> next apply, over an explicit
:class:`StepCarry` whose every leaf leads with the query axis ``B``.
JAX runs the loop as one ``lax.while_loop`` (vmapped for a batch); here
:meth:`SuperstepProgram.run_loop` drives it from the host with one read
of the termination bits per superstep, and freezes finished queries with
:func:`select_lanes` — the explicit form of the freeze ``vmap`` of a
``while_loop`` performs — so a batched query is bit-identical to a solo
run of it. On the card, :class:`SuperstepGraph` runs the same loop from
CUDA graphs of the init and of one superstep over static carry buffers.

:class:`LaneStepper` is the host-drivable W-lane handle over the same
program that the service's continuous scheduler drives (admit / one
superstep / probe / retire, and the park/restore verbs of a preemptible
lane); :class:`LaneTable`, :class:`LaneMeta` and :class:`LaneCheckpoint`
(copied from the JAX package, which keeps them framework-free) hold the
lane lifecycle on top of it. Where JAX counts a program's compilations at
trace time, a stepper counts the first run of each of its programs (its
width is fixed), and each init/admit/step/restore reads the lane-active
bits, the superstep counters and the wire words to the host in one
packed read.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from ..kernels import edge_gather
from . import obs

__all__ = ["StepCarry", "SuperstepProgram", "SuperstepGraph", "LaneStepper",
           "LaneStepperBase", "select_lanes", "select_lanes_into",
           "tree_map", "tree_nbytes",
           "LaneMeta", "LaneCheckpoint", "LaneTable", "lane_dtype",
           "PRIORITY_BOOST_S"]

# One request-priority level is worth this many seconds of deadline
# urgency. Kept finite (rather than a lexicographic priority dimension)
# so a parked lane's deadline-aging credit can eventually exceed ANY
# priority boost — the starvation-freedom guarantee.
PRIORITY_BOOST_S = 60.0


class StepCarry(NamedTuple):
    """Everything the in-flight queries own between supersteps."""
    state: Dict[str, torch.Tensor]  # leaves (B, P, Vm) or (B,)
    payload: torch.Tensor           # (B, P, Vm) pending update values
    active: torch.Tensor            # (B, P, Vm) pending update mask
    superstep: torch.Tensor         # (B,) int32 supersteps completed
    stats: Dict[str, torch.Tensor]  # (B,) running counters


def _map(fn, *carries):
    """Apply ``fn`` leaf-wise over StepCarry/dict/tensor structures."""
    first = carries[0]
    if isinstance(first, StepCarry):
        return StepCarry(*(_map(fn, *parts) for parts in zip(*carries)))
    if isinstance(first, dict):
        return {k: _map(fn, *(c[k] for c in carries)) for k in first}
    return fn(*carries)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a structure of named tuples, dicts
    and tensors (an engine's graph data, a layout, a carry); everything
    else (sizes, None) is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_nbytes(tree) -> int:
    """Bytes of every tensor (or host numpy array: a fetched carry) of
    such a structure."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, tuple):
        return 0
    return int(sum(tree_nbytes(x) for x in tree))


def select_lanes(mask: torch.Tensor, new, old):
    """Per-query carry select: queries where ``mask`` ((B,) bool) is True
    take ``new``, the rest keep ``old``."""
    def sel(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
    return _map(sel, new, old)


def select_lanes_into(mask: torch.Tensor, new, carry) -> None:
    """:func:`select_lanes` written into ``carry``'s own tensors: queries
    where ``mask`` is True take ``new``, the rest keep what they hold."""
    def sel(n, o):
        torch.where(mask.view((-1,) + (1,) * (o.dim() - 1)), n, o, out=o)
    _map(sel, new, carry)


def _over_queries(x: torch.Tensor, batch: int, vshape) -> torch.Tensor:
    """Broadcast a leaf over the query axis: per-vertex leaves (trailing
    ``vshape``) to (B, *vshape), per-query scalars to (B,)."""
    if x.dim() >= 2:
        return x.expand((batch,) + tuple(vshape))
    return x.expand(batch)


class SuperstepProgram:
    """init/step/alive for one (kernel, graph layout, deliver) triple.

    ``deliver(data, payload, active)`` returns ``(acc, got, carry_vals,
    aux)`` where ``aux`` is a dict of per-superstep counts folded into
    the running stats by ``update_stats(stats, data, active, aux)``.
    ``data`` needs ``vert_gid``, ``out_deg`` and ``vert_valid``, (P, Vm)
    (or the process's own shards of them). ``global_any`` reduces the
    (B,) live bits of this process's shards across the mesh (the
    identity for the one-device engine, ``pmax`` for the shard engine).

    Its phases are :mod:`obs` spans (``engine.init``, ``engine.sync``,
    ``engine.superstep`` and inside it ``engine.gather``,
    ``engine.stats``, ``engine.apply``, ``engine.freeze``; the deliver
    adds its own). ``lanes`` is the lane count one deliver passes over
    per query, padding included, which ``engine.lanes_scanned`` counts;
    0 (a program whose engine sets none) counts nothing.
    """

    lanes: int = 0

    def __init__(self, kernel, deliver: Callable[..., Any], *,
                 init_stats: Callable[[int], Dict[str, torch.Tensor]],
                 update_stats: Callable[..., Dict[str, torch.Tensor]],
                 global_any: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None):
        self.kernel = kernel
        self.deliver = deliver
        self.init_stats = init_stats
        self.update_stats = update_stats
        self.global_any = global_any or (lambda b: b)

    def _applied(self, data, state, superstep):
        batch = superstep.shape[0]
        vshape = data.vert_gid.shape
        with obs.span("engine.apply"):
            state, payload, active = self.kernel.apply(
                state, data.vert_gid, data.out_deg, superstep)
            active = _over_queries(active, batch, vshape) & data.vert_valid
            return state, _over_queries(payload, batch, vshape), active

    def init_carry(self, data, params: Dict[str, Any],
                   query_kwargs: Dict[str, Any], batch: int) -> StepCarry:
        """Kernel ``init_state`` + the superstep-0 ``apply`` (paper §4.3:
        "the barrier is injected into the apply modules")."""
        vshape = data.vert_gid.shape
        with obs.span("engine.init"):
            state = self.kernel.init_state(data.vert_gid, data.out_deg,
                                           data.vert_valid,
                                           **{**params, **query_kwargs})
            state = {k: _over_queries(v, batch, vshape).contiguous()
                     for k, v in state.items()}
            s = torch.zeros(batch, dtype=torch.int32,
                            device=data.vert_gid.device)
            state, payload, active = self._applied(data, state, s)
            return StepCarry(state, payload, active, s,
                             self.init_stats(batch))

    def step_deliver(self, data, carry: StepCarry):
        return self.deliver(data, carry.payload, carry.active)

    def step_combine(self, data, carry: StepCarry, delivered) -> StepCarry:
        k = self.kernel
        state, payload, active, s, stats = carry
        acc, got, carry_v, aux = delivered
        with obs.span("engine.gather"):
            if k.carry_dtype is not None:
                state = k.gather(state, acc, carry_v, got, s)
            else:
                state = k.gather(state, acc, got, s)
        with obs.span("engine.stats"):
            stats = self.update_stats(stats, data, active, aux)
        return StepCarry(state, payload, active, s, stats)

    def step_exchange(self, data, carry: StepCarry) -> StepCarry:
        return self.step_combine(data, carry, self.step_deliver(data, carry))

    def step_apply(self, data, mid: StepCarry) -> StepCarry:
        state, _, _, s, stats = mid
        s = s + 1
        state, payload, active = self._applied(data, state, s)
        return StepCarry(state, payload, active, s, stats)

    def step(self, data, carry: StepCarry) -> StepCarry:
        return self.step_apply(data, self.step_exchange(data, carry))

    def alive(self, carry: StepCarry) -> torch.Tensor:
        """(B,) bool: any vertex of the query still active, on any shard
        of the mesh."""
        return self.global_any(carry.active.flatten(1).any(dim=1))

    def run_loop(self, data, cap: int, params: Dict[str, Any],
                 query_kwargs: Dict[str, Any], batch: int) -> StepCarry:
        """Run every query to quiescence (or ``cap`` supersteps); finished
        queries are frozen. One host read of the live bits a superstep,
        after they are reduced across the mesh, so every process of a
        mesh takes the same number of supersteps."""
        carry = self.init_carry(data, params, query_kwargs, batch)
        dispatches = 0
        while True:
            with obs.span("engine.sync"):
                live = self.alive(carry) & (carry.superstep < cap)
                done = not bool(live.any())
            if done:
                break
            with obs.span("engine.superstep"):
                new = self.step(data, carry)
                with obs.span("engine.freeze"):
                    carry = select_lanes(live, new, carry)
                # the step's own carry must not live on into the next
                # step: it would raise the device's peak by a carry
                del new
            dispatches += 1
        self.count(dispatches, batch)
        return carry

    def count(self, dispatches: int, batch: int) -> None:
        """Add a loop's step dispatches to ``engine.supersteps`` and the
        lanes they scanned to ``engine.lanes_scanned``."""
        obs.counters.add("engine.supersteps", dispatches)
        if self.lanes:
            obs.counters.add("engine.lanes_scanned",
                             dispatches * batch * self.lanes)


class SuperstepGraph:
    """The loop of :meth:`SuperstepProgram.run_loop` at one batch size and
    one set of query parameters, run from two CUDA graphs.

    Both update one set of static carry buffers in place. The init graph
    writes :meth:`SuperstepProgram.init_carry` of the static query
    tensors into them, and the live bits; the step graph holds one
    superstep: :meth:`SuperstepProgram.step`, the freeze into the
    buffers, the next superstep's live bits. Either copies the live bits
    to a pinned host buffer. Each call copies its query tensors in, fills
    the superstep cap (a device scalar) and replays the init graph; the
    host then waits on an event (``engine.sync``) and reads the live bits
    once a superstep, as the eager loop does, so states, supersteps and
    stats are bit-identical to it. A call thus allocates no carry of its
    own on the device. A graph pair holds its carry, and its
    intermediates lie in the one pool that all superstep graphs of the
    process share (:func:`_capture`). The first call runs the init and its
    first superstep eagerly (the warm-up), and both graphs are captured
    after it. They hold the addresses of ``data``, so an engine drops
    them when it rebinds its data. The kernel's functions read nothing
    back to the host, as under the JAX engine's ``jit``.

    ``lock`` is held by the call that runs the loop: the buffers are its
    until it has read its results from them."""

    def __init__(self, prog: SuperstepProgram, data, params: Dict[str, Any],
                 batch: int, device: torch.device):
        self.prog, self.data, self.batch = prog, data, batch
        self.params = dict(params)
        self.lock = threading.Lock()
        self.graph = self.init_graph = None
        self.carry: Optional[StepCarry] = None
        self.query: Optional[Dict[str, torch.Tensor]] = None
        cuda = device.type == "cuda"
        self.cap = torch.zeros((), dtype=torch.int32, device=device)
        self.live = torch.zeros(batch, dtype=torch.bool, device=device)
        self.live_host = torch.zeros(batch, dtype=torch.bool,
                                     pin_memory=cuda)
        self.ready = torch.cuda.Event() if cuda else None
        self.launches = (0, 0)       # K1 and K2 launches a replay makes

    def _live_bits(self) -> None:
        c = self.carry
        torch.bitwise_and(self.prog.alive(c), c.superstep < self.cap,
                          out=self.live)
        self.live_host.copy_(self.live, non_blocking=True)

    def _init(self) -> None:
        init = self.prog.init_carry(self.data, self.params, self.query,
                                    self.batch)
        if self.carry is None:
            self.carry = _map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=t.device), init)
        _map(lambda dst, src: dst.copy_(src), self.carry, init)
        del init
        self._live_bits()

    def _body(self) -> None:
        new = self.prog.step(self.data, self.carry)
        with obs.span("engine.freeze"):
            select_lanes_into(self.live, new, self.carry)
        del new
        self._live_bits()

    def _capture(self) -> None:
        k1, k2 = edge_gather.recorded()
        self.graph, self.init_graph = _capture(self._body, self._init)
        n1, n2 = edge_gather.recorded()
        self.launches = (n1 - k1, n2 - k2)
        obs.counters.add("engine.graph_captures", 1)

    def run_loop(self, cap: int,
                 query_kwargs: Dict[str, torch.Tensor]) -> StepCarry:
        """Run every query to quiescence (or ``cap`` supersteps); returns
        the static carry, which the caller reads before it releases
        ``lock``."""
        if self.query is None:
            self.query = {k: v.clone() for k, v in query_kwargs.items()}
        else:
            for k, v in query_kwargs.items():
                self.query[k].copy_(v)
        self.cap.fill_(min(cap, torch.iinfo(torch.int32).max))
        if self.init_graph is None:
            self._init()
        else:
            self.init_graph.replay()
        dispatches = replays = 0
        while True:
            with obs.span("engine.sync"):
                if self.ready is not None:
                    self.ready.record()
                    self.ready.synchronize()
                done = not self.live_host.numpy().any()
            if done:
                break
            with obs.span("engine.superstep"):
                if self.graph is None:
                    self._body()
                    self._capture()
                else:
                    self.graph.replay()
                    edge_gather.add_launches(*self.launches)
                    replays += 1
            dispatches += 1
        self.prog.count(dispatches, self.batch)
        obs.counters.add("engine.graph_replays", replays)
        return self.carry


_CAPTURE_LOCK = threading.Lock()
# The one pool that every superstep graph of the process captures into,
# per device: a graph's intermediates are dead when its replay ends (the
# carry lives outside the pool), and replays run one after another on
# the default stream, so the pool holds the largest superstep's
# intermediates, not the sum over engines and batch sizes.
_POOLS: Dict[int, Any] = {}


def _capture(*bodies: Callable[[], None]) -> "list[torch.cuda.CUDAGraph]":
    """Each body's work on the card as a CUDA graph, captured on a side
    stream into the process's pool (:data:`_POOLS`); no body runs a
    kernel here. One capture at a time in the process: other threads'
    eager work on the card goes on beside it."""
    graphs = []
    with _CAPTURE_LOCK:
        device = torch.cuda.current_device()
        if device not in _POOLS:
            _POOLS[device] = torch.cuda.graph_pool_handle()
        for body in bodies:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=_POOLS[device],
                                  capture_error_mode="thread_local"):
                body()
            graphs.append(graph)
    return graphs


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a host timing boundary)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LaneStepperBase:
    """Host-side plumbing of a lane stepper (twin of the JAX
    ``LaneStepperBase``): the (carry, lane_active, supersteps) return
    contract, the query-array upload, the host fetches, and the first-run
    trace accounting. A subclass builds the programs ``_init``,
    ``_admit``, ``_step``, ``_probe``, ``_fetch_lane``, ``_restore`` and
    the profiled phase programs ``_deliver_p``, ``_combine_p`` and
    ``_apply_p`` with :meth:`_program`.

    ``bind_data`` swaps the graph data the programs run over (the
    engine's offload/upload). Data that is not on the stepper's device
    (an offloaded engine's host copies) is staged to the device for each
    call: an offloaded stepper still computes on its device."""

    # cumulative wire words (across all lanes) as of the last dispatch;
    # LaneTable.step turns consecutive values into per-superstep deltas
    # for the trace bus
    last_wire_words: float = 0.0

    # Opt-in phase profiling: when True, ``step`` dispatches the
    # superstep as separate phase programs with a device synchronize and
    # a host timing boundary between them and leaves the wall split in
    # ``last_phases`` ({phase: seconds}); the fused step leaves it None.
    # The phases run the same ops and the same lane select as the fused
    # step, so results are bit-identical.
    profile: bool = False
    last_phases: Optional[Dict[str, float]] = None

    def __init__(self, data, width: int, device: torch.device, *,
                 trace_hook: Optional[Callable[[], None]] = None):
        self._data = data
        self.width = width
        self.device = device
        self._hook = trace_hook or (lambda: None)
        self._ran: set = set()

    def _program(self, name: str, fn: Callable[..., Any]):
        """``fn`` that counts one trace (through ``trace_hook``) the first
        time it runs: the port's counterpart of a jitted program traced
        once per width."""
        def call(*args):
            if name not in self._ran:
                self._ran.add(name)
                self._hook()
            return fn(*args)
        return call

    def _dev(self):
        """The graph data on the stepper's device (staged for this call
        when the engine is offloaded)."""
        return tree_map(lambda t: t.to(self.device), self._data)

    def _lanes(self, mask: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask, bool), device=self.device)

    def _unpack(self, out):
        """(carry, packed) -> (carry, lane_active (W,) bool, supersteps (W,)
        int32): ONE device-to-host read of the packed probe."""
        carry, packed = out
        with obs.span("engine.sync"):
            host = packed.cpu().numpy()
        w = self.width
        if host.shape[0] > 2 * w:
            self.last_wire_words = float(host[2 * w])
        return carry, host[:w] > 0, host[w:2 * w].astype(np.int32)

    def _qdev(self, qkw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v),
                                   device=self.device).view(-1, 1, 1)
                for k, v in qkw.items()}

    def probe(self, carry: StepCarry):
        host = self._probe(carry).cpu().numpy()
        w = self.width
        return host[:w] > 0, host[w:2 * w].astype(np.int32)

    def fetch(self, carry: StepCarry) -> StepCarry:
        return _map(lambda a: a.cpu().numpy(), carry)

    def fetch_lane(self, carry: StepCarry, lane: int) -> StepCarry:
        """Host copy of exactly ONE lane's carry slice (the checkpoint
        payload): only that lane's bytes cross to the host, not the whole
        slot array."""
        return _map(lambda a: a.cpu().numpy(),
                    self._fetch_lane(carry, int(lane)))

    def restore(self, carry: StepCarry, lane_carry: StepCarry,
                fresh: np.ndarray):
        """Splice a checkpointed lane's carry back into ``fresh`` slots of
        the in-flight slot array — the admit-path select with the parked
        carry instead of a fresh ``init_carry``, so the lane resumes
        bit-identically from its parked superstep (state, superstep
        counter and running stats all survive verbatim)."""
        lane_dev = _map(lambda a: torch.as_tensor(a, device=self.device),
                        lane_carry)
        return self._unpack(self._restore(carry, lane_dev,
                                          self._lanes(fresh)))

    def bind_data(self, data) -> None:
        """Swap the graph data the programs run over — the engine's
        offload/upload across the store's host-spill tier. Shapes and
        dtypes match the original, so no program runs anew."""
        self._data = data


class LaneStepper(LaneStepperBase):
    """Host-drivable fixed-width slot array over a SuperstepProgram.

    ``init``/``admit``/``step``/``restore`` return ``(carry, lane_active
    (W,), supersteps (W,))``: the probe runs in the same call and its
    lane bits, superstep counters and wire-words sum come back in one
    packed host read, so the continuous scheduler's steady state costs
    one read per superstep.

      init(qkw)                -> all W lanes initialized
      admit(carry, qkw, fresh) -> ``fresh`` lanes re-initialized
      step(carry, alive)       -> one superstep for ``alive`` lanes,
                                  everything else frozen
      probe(carry)             -> host (lane_active (W,), supersteps (W,))
      fetch(carry)             -> host copy of the whole carry
    """

    def __init__(self, prog: SuperstepProgram, data, params: Dict[str, Any],
                 width: int, *, device,
                 trace_hook: Optional[Callable[[], None]] = None,
                 wire_stat: Optional[str] = None):
        super().__init__(data, width, torch.device(device),
                         trace_hook=trace_hook)
        self._prog, self._wire_stat = prog, wire_stat
        probe_of = self._probe_of

        def init_fn(d, qkw):
            c = prog.init_carry(d, params, qkw, width)
            return c, probe_of(c)

        def admit_fn(d, carry, qkw, fresh):
            new = prog.init_carry(d, params, qkw, width)
            with obs.span("engine.freeze"):
                c = select_lanes(fresh, new, carry)
            return c, probe_of(c)

        def step_fn(d, carry, alive):
            with obs.span("engine.superstep"):
                new = prog.step(d, carry)
                with obs.span("engine.freeze"):
                    c = select_lanes(alive, new, carry)
                del new
                return c, probe_of(c)

        # profiled-mode phase programs: the same superstep as step_fn, cut
        # at the scatter / combine / apply boundaries so the host can time
        # each
        def deliver_fn(d, carry):
            return prog.step_deliver(d, carry)

        def combine_fn(d, carry, delivered):
            return prog.step_combine(d, carry, delivered)

        def apply_fn(d, carry, mid, alive):
            new = prog.step_apply(d, mid)
            with obs.span("engine.freeze"):
                return select_lanes(alive, new, carry)

        def fetch_lane_fn(carry, lane):
            return _map(lambda a: a[lane], carry)

        def restore_fn(carry, lane_carry, fresh):
            new = _map(lambda leaf: leaf.unsqueeze(0).expand(
                (width,) + tuple(leaf.shape)), lane_carry)
            with obs.span("engine.freeze"):
                c = select_lanes(fresh, new, carry)
            return c, probe_of(c)

        self._init = self._program("init", init_fn)
        self._admit = self._program("admit", admit_fn)
        self._step = self._program("step", step_fn)
        self._probe = self._program("probe", probe_of)
        self._fetch_lane = self._program("fetch_lane", fetch_lane_fn)
        self._restore = self._program("restore", restore_fn)
        self._deliver_p = self._program("deliver", deliver_fn)
        self._combine_p = self._program("combine", combine_fn)
        self._apply_p = self._program("apply", apply_fn)

    def _probe_of(self, carry: StepCarry) -> torch.Tensor:
        """Lane bits, superstep counters and (when the engine names its
        wire stat) the lanes' wire-words sum, packed for one read."""
        parts = [self._prog.alive(carry).to(torch.float64),
                 carry.superstep.to(torch.float64)]
        if self._wire_stat is not None:
            parts.append(self._wire_words(carry).to(torch.float64).view(1))
        return torch.cat(parts)

    def _wire_words(self, carry: StepCarry) -> torch.Tensor:
        return carry.stats[self._wire_stat].sum()

    def init(self, qkw: Dict[str, np.ndarray]):
        return self._unpack(self._init(self._dev(), self._qdev(qkw)))

    def admit(self, carry: StepCarry, qkw: Dict[str, np.ndarray],
              fresh: np.ndarray):
        return self._unpack(self._admit(self._dev(), carry, self._qdev(qkw),
                                        self._lanes(fresh)))

    def step(self, carry: StepCarry, alive: np.ndarray):
        if self._prog.lanes:
            obs.counters.add("engine.lanes_scanned",
                             self.width * self._prog.lanes)
        if not self.profile:
            self.last_phases = None
            return self._unpack(self._step(self._dev(), carry,
                                           self._lanes(alive)))
        return self._profiled_step(carry, alive)

    def _profiled_step(self, carry: StepCarry, alive: np.ndarray):
        """One superstep as four phase dispatches with a device
        synchronize and a host timing boundary after each. Same ops and
        the same select as the fused path (bit-identical results); the
        extra syncs are the profiling overhead."""
        d, alive_dev = self._dev(), self._lanes(alive)
        phases: Dict[str, float] = {}
        _sync(self.device)
        t = time.perf_counter()
        delivered = self._deliver_p(d, carry)
        _sync(self.device)
        now = time.perf_counter()
        phases["scatter"] = now - t
        t = now
        mid = self._combine_p(d, carry, delivered)
        _sync(self.device)
        now = time.perf_counter()
        phases["combine"] = now - t
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


# ---------------------------------------------------------------------------
# lane lifecycle: LaneTable + checkpoint/restore
# ---------------------------------------------------------------------------

def lane_dtype(value) -> np.dtype:
    """Canonical lane-array dtype for a query kwarg (matches the int32 /
    float32 the kernels run with, so admits never change signature)."""
    a = np.asarray(value)
    if a.dtype.kind in "iub":
        return np.dtype(np.int32)
    if a.dtype.kind == "f":
        return np.dtype(np.float32)
    return a.dtype


@dataclasses.dataclass
class LaneMeta:
    """Per-lane scheduling metadata. ``payload`` is opaque to the core
    (the service stores its (request, future) pair there); everything
    else is what admission, preemption and depth packing decide on.

    ``credit_s`` is the deadline-aging credit a lane accrues while
    parked: the scheduler subtracts it from ``deadline_s`` when ranking,
    so a repeatedly preempted query becomes monotonically more urgent
    and cannot starve (and, once restored, is not the first victim of
    the next preemption)."""

    payload: Any
    qkw: Dict[str, Any]
    tenant: str = "default"
    priority: int = 0
    deadline_s: float = float("inf")
    predicted_depth: float = 0.0
    credit_s: float = 0.0
    parks: int = 0
    seq: int = 0
    # depth-prediction bucket label ("d<decile>" of the root's degree,
    # or None): which per-bucket depth EWMA predicted_depth came from —
    # retirement scores the observation back into the same bucket
    depth_bucket: Optional[str] = None

    def effective_deadline(self) -> float:
        """Scalar urgency (smaller = more urgent): the deadline minus
        the aging credit, with each priority level worth
        :data:`PRIORITY_BOOST_S` seconds. Priority therefore dominates
        ordinary deadline spreads, while a long-parked lane's credit
        grows without bound and eventually outranks any priority."""
        return (self.deadline_s - self.credit_s
                - PRIORITY_BOOST_S * float(self.priority))


@dataclasses.dataclass
class LaneCheckpoint:
    """One parked lane: the host copy of its carry slice plus its
    metadata. ``restore`` splices the carry back into a free slot and
    the query resumes bit-identically from ``superstep`` — state,
    superstep counter and running stats are all part of the carry."""

    carry: StepCarry
    meta: LaneMeta
    superstep: int
    nbytes: int


class LaneTable:
    """First-class lane lifecycle for one stepper's W-wide slot array.

    Owns slot occupancy, the device carry + host probe mirrors
    (``act``/``steps``), the per-lane kwarg arrays, and the per-lane
    :class:`LaneMeta`. The scheduler's policy (who gets a slot, who is
    preempted) stays outside; the mechanics of the four lifecycle verbs
    live here:

      admit(assignments)    — splice fresh queries into free slots (one
                              lane-masked device call for all of them)
      step(alive)           — one superstep for the alive lanes
      checkpoint(slot)      — fetch ONLY that lane's carry slice to host
                              and free the slot (zero re-traces; the
                              preemption "park" half)
      restore(slot, ckpt)   — splice a parked carry back into a free
                              slot via the admit-path select; the lane
                              resumes bit-identically from its parked
                              superstep

    Freed/parked lanes' stale device carry stays in place until a later
    admit/restore overwrites it — the lane-masked select never steps an
    unoccupied lane, so it is inert.

    ``trace`` is an optional duck-typed event bus (anything with an
    ``emit(kind, **fields)`` method — in practice the service layer's
    ``TraceBus``; the core stays import-free of the service package).
    When set, ``step`` emits one ``superstep`` event per dispatch with
    the lane→query attribution (slot -> meta.seq) of the lanes that
    actually stepped, so a query span can be reconstructed into its
    active vs parked intervals.
    """

    def __init__(self, stepper, width: int, query_params, *,
                 trace=None, label: Optional[str] = None,
                 devices: Tuple[str, ...] = ()):
        self.stepper = stepper
        self.width = width
        self.query_params = tuple(query_params)
        self.trace = trace
        self.label = label
        # mesh device attribution for superstep events (shard steppers
        # dispatch to every device of their 1-D graph mesh; () for
        # single-device tables keeps those events unchanged)
        self.devices = tuple(devices)
        self.meta: List[Optional[LaneMeta]] = [None] * width
        self.carry = None
        self.act: Optional[np.ndarray] = None    # (W,) lane-alive probe
        self.steps: Optional[np.ndarray] = None  # (W,) lane supersteps
        self._qkw: Optional[Dict[str, np.ndarray]] = None

    # ---------------- occupancy ---------------------------------------
    @property
    def occupied(self) -> np.ndarray:
        return np.array([m is not None for m in self.meta], bool)

    def in_flight(self) -> int:
        return sum(m is not None for m in self.meta)

    def free_slots(self) -> List[int]:
        return [i for i, m in enumerate(self.meta) if m is None]

    def lanes_of(self, tenant: str) -> int:
        return sum(1 for m in self.meta
                   if m is not None and m.tenant == tenant)

    def active_slots(self) -> List[int]:
        return [i for i, m in enumerate(self.meta) if m is not None]

    def alive_mask(self, cap: int) -> np.ndarray:
        return self.occupied & self.act & (self.steps < cap)

    def done_slots(self, cap: int) -> List[int]:
        """Occupied lanes whose termination mask flipped or that hit the
        superstep cap — ready to retire."""
        return [i for i in range(self.width)
                if self.meta[i] is not None
                and (not self.act[i] or self.steps[i] >= cap)]

    def lane_nbytes(self) -> int:
        """Host bytes one lane's checkpoint occupies (every carry leaf's
        lane axis divides its bytes evenly across the W lanes)."""
        if self.carry is None:
            return 0
        return tree_nbytes(self.carry) // self.width

    def predicted_remaining(self, slot: int, residual: float = 1.0
                            ) -> float:
        """Predicted supersteps this lane still needs: its admission-time
        depth prediction minus observed progress; a lane that outlived
        its prediction falls back to the class's observed-depth residual
        (the expected overshoot), floored at one superstep."""
        m = self.meta[slot]
        rem = m.predicted_depth - float(self.steps[slot])
        return rem if rem > 0 else max(float(residual), 1.0)

    # ---------------- lifecycle verbs ---------------------------------
    def _ensure_qkw(self, meta: LaneMeta) -> None:
        if self._qkw is None:
            # lane arrays keyed by the kernel's DECLARED params (not one
            # request's keys), seeded with this request's values — idle
            # lanes then hold a valid query, like the bucketed batcher's
            # padding lanes
            self._qkw = {p: np.full((self.width,), meta.qkw[p],
                                    dtype=lane_dtype(meta.qkw[p]))
                         for p in self.query_params}

    def admit(self, assignments: Dict[int, LaneMeta]) -> None:
        """Splice fresh queries into the given free slots — one
        lane-masked ``init_carry`` select for all of them."""
        if not assignments:
            return
        fresh = np.zeros(self.width, bool)
        # install EVERY meta before anything that can raise: a failure
        # below (missing declared param, device error) then finds all
        # affected lanes in the table, so the class-failure path can
        # resolve their futures instead of stranding them
        for slot, meta in assignments.items():
            assert self.meta[slot] is None, f"slot {slot} occupied"
            self.meta[slot] = meta
            fresh[slot] = True
        for slot, meta in assignments.items():
            self._ensure_qkw(meta)
            for p in self._qkw:
                # a missing declared param raises here and fails the
                # class loudly instead of silently reusing the slot's
                # previous occupant's value
                self._qkw[p][slot] = meta.qkw[p]
        if self.carry is None:
            self.carry, self.act, self.steps = self.stepper.init(self._qkw)
        else:
            self.carry, self.act, self.steps = self.stepper.admit(
                self.carry, self._qkw, fresh)

    def step(self, alive: np.ndarray) -> None:  # analysis: host
        if self.trace is None:
            self.carry, self.act, self.steps = self.stepper.step(
                self.carry, alive)
            return
        # lane->query attribution captured BEFORE the dispatch (a lane
        # that retires this superstep must still be attributed to it)
        lanes = {int(i): self.meta[i].seq
                 for i in np.flatnonzero(alive) if self.meta[i] is not None}
        w0 = getattr(self.stepper, "last_wire_words", 0.0)
        t0 = time.perf_counter()
        self.carry, self.act, self.steps = self.stepper.step(
            self.carry, alive)
        # the probe arrays in the return are host numpy, so perf_counter
        # here bounds the full dispatch+sync, not just the enqueue
        w1 = getattr(self.stepper, "last_wire_words", 0.0)
        extra = {}
        ph = getattr(self.stepper, "last_phases", None)
        if ph is not None:
            # profiled mode: the measured scatter/combine/apply/probe
            # wall split rides the event (Perfetto args pane / L_* term
            # comparison against perfmodel.phase_projection)
            extra["phase"] = dict(ph)
        if self.devices:
            # per-device attribution: the mesh devices this dispatch
            # fanned out to (single-device tables omit the column)
            extra["devices"] = list(self.devices)
        self.trace.emit("superstep", klass=self.label,
                        ts=t0, dur_s=time.perf_counter() - t0,
                        lanes=lanes, n_alive=len(lanes),
                        words=max(0.0, w1 - w0), **extra)

    def fetch(self) -> StepCarry:
        return self.stepper.fetch(self.carry)

    def release(self, slot: int) -> LaneMeta:
        """Free one retired lane's slot; returns its metadata."""
        meta = self.meta[slot]
        self.meta[slot] = None
        return meta

    def checkpoint(self, slot: int) -> LaneCheckpoint:
        """Park one lane: fetch its carry slice to host and free the
        slot. The device never sees a shape change, so parking
        re-traces nothing."""
        meta = self.meta[slot]
        assert meta is not None, f"slot {slot} is empty"
        nbytes = self.lane_nbytes()
        lane = self.stepper.fetch_lane(self.carry, slot)
        self.meta[slot] = None
        meta.parks += 1
        return LaneCheckpoint(carry=lane, meta=meta,
                              superstep=int(self.steps[slot]),
                              nbytes=nbytes)

    def restore(self, slot: int, ckpt: LaneCheckpoint) -> None:
        """Un-park a checkpointed lane into a free slot. The splice goes
        through the same lane-masked select as ``admit``, so the resumed
        computation is bit-identical to never having been parked."""
        assert self.meta[slot] is None, f"slot {slot} occupied"
        meta = ckpt.meta
        # meta first (see admit): a failure in the splice below must
        # leave the lane visible to the class-failure path
        self.meta[slot] = meta
        self._ensure_qkw(meta)
        for p in self._qkw:
            self._qkw[p][slot] = meta.qkw[p]
        if self.carry is None:
            # empty table: materialize a carry first (idle lanes hold a
            # valid dummy query), then overwrite the restored slot
            self.carry, self.act, self.steps = self.stepper.init(self._qkw)
        fresh = np.zeros(self.width, bool)
        fresh[slot] = True
        self.carry, self.act, self.steps = self.stepper.restore(
            self.carry, ckpt.carry, fresh)

    def clear(self) -> List[LaneMeta]:
        """Drop every lane (class failure path); returns the metadata of
        the lanes that were occupied."""
        out = [m for m in self.meta if m is not None]
        self.meta = [None] * self.width
        self.carry = self.act = self.steps = None
        return out
