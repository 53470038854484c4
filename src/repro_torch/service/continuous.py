"""Continuous batching with a preemptible lane lifecycle.

The port's copy of ``repro.service.continuous``, over the port's
``LaneTable``, ``LaneMeta`` and ``LaneCheckpoint``.

The bucketed batcher (batching.py) forms a batch, runs it to
completion, and only then looks at the queue again — so a BFS that
quiesces in 3 supersteps waits for the batch's 12-superstep straggler,
and new arrivals wait for the whole loop to drain. This module instead
holds a fixed-width *slot array* per query class — a
:class:`~repro_torch.core.stepper.LaneTable` over the engine's step-granular
:class:`~repro_torch.core.stepper.LaneStepper` — and drives it one superstep
at a time:

  * after every superstep, slots whose per-query termination mask
    flipped are **retired** — their Futures resolve immediately, at
    their own depth, not the batch maximum;
  * freed slots are **refilled** from the class queues between
    supersteps by re-running ``init_carry`` for just those lanes (a
    lane-masked select — the device never sees a shape change, so
    steady-state recycling re-traces nothing).

Each lane's computation is the same vmapped program ``run_batch``
executes, so a query spliced in at in-flight superstep t is
bit-identical to a solo ``Engine.run`` (asserted in
tests/test_continuous.py).

The lane lifecycle is **preemptible** (queued → active → parked →
active → retired):

  * admission is **deadline-priority**: within a tenant's queue the
    most urgent request (highest ``QueryRequest.priority``, then
    earliest aged deadline) takes the next free lane; requests with
    comparable urgency are ordered by **predicted depth** (the
    admission cost model's per-class depth EWMA), so co-scheduled lanes
    tend to retire together and retire-fetches amortize;
  * when a tight-deadline request arrives and every slot is busy, the
    scheduler **preempts** the active lane with the latest effective
    deadline (tie-broken by highest predicted remaining depth —
    observed progress against the depth EWMA, falling back to the
    class's observed-depth residual once a lane outlives its
    prediction). The victim's carry is checkpointed to host
    (``LaneTable.checkpoint`` — only that lane's slice moves, zero
    re-traces) and parked in a bounded :class:`ParkedQueue` charged
    against the graph store's spill budget; the freed slot takes the
    urgent arrival in the same admission window;
  * parked lanes **age**: every second parked earns ``aging_rate``
    seconds of deadline credit, so a preempted query becomes
    monotonically more urgent, is restored ahead of fresh arrivals once
    its aged deadline wins, and — keeping its credit after restore —
    is not the next preemption's first victim. Restoration
    (``LaneTable.restore``) splices the parked carry back through the
    admit-path select, resuming bit-identically from the parked
    superstep.

Multi-tenancy is unchanged underneath: queues are per tenant
within a class, free lanes are handed out by weighted stride scheduling
with soft lane caps, and each active class holds a
:class:`~repro_torch.store.GraphLease` pin from first submit until its last
lane retires (parked lanes keep the class — and so the pin — alive).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import obs
from ..core.stepper import LaneCheckpoint, LaneMeta, LaneTable, tree_nbytes
from .batching import QueryClass, QueryRequest
from .plans import StepperPlan

__all__ = ["ContinuousScheduler", "ParkedQueue", "class_key"]

# the longest a pump waits for a submit that counted itself to take the
# lock (``_let_arrivals_in``); it ends in microseconds unless the lock's
# owner is busy or blocked
ARRIVAL_WAIT_S = 1.0


def class_key(qclass: QueryClass) -> str:
    """Stable string key for per-class cost-model stats. Overlapped
    shard classes get a ``~ov`` suffix: the pipelined schedule has a
    different superstep cost structure (exchange off the critical
    path), so sharing EWMAs/roofline accumulators with the synchronous
    schedule would blur both."""
    base = (f"{qclass.graph_id}@v{qclass.version}/"
            f"{qclass.kernel}/{qclass.mode}")
    if getattr(qclass, "exchange", ""):
        base += f"+{qclass.exchange}"
        if getattr(qclass, "overlap", False):
            base += "~ov"
    return base


@dataclasses.dataclass
class _Parked:
    """One parked lane: its checkpoint plus when it was parked (the
    deadline-aging clock)."""
    ckpt: LaneCheckpoint
    parked_at_s: float

    def aged_key(self, now_s: float, aging_rate: float) -> float:
        return (self.ckpt.meta.effective_deadline()
                - aging_rate * (now_s - self.parked_at_s))


class ParkedQueue:
    """Bounded host-side queue of preempted lanes for one query class.

    Every park is charged against the graph store's **spill budget**
    (the parked carry is exactly the kind of host-resident bytes the
    spill tier accounts): ``try_park`` calls the charge hook first and
    refuses the park — so the preemption simply does not happen — when
    the budget is exhausted. ``pop_best`` returns the entry with the
    most urgent *aged* deadline and releases its charge."""

    def __init__(self, charge: Optional[Callable[[int], bool]] = None,
                 release: Optional[Callable[[int], None]] = None):
        self._charge = charge
        self._release = release
        self.entries: List[_Parked] = []

    def __len__(self) -> int:
        return len(self.entries)

    def reserve(self, nbytes: int) -> bool:
        """Charge ``nbytes`` ahead of the checkpoint fetch (refused =
        no preemption)."""
        return self._charge is None or self._charge(nbytes)

    def refund(self, nbytes: int) -> None:
        if self._release is not None:
            self._release(nbytes)

    def park(self, ckpt: LaneCheckpoint, now_s: float) -> _Parked:
        entry = _Parked(ckpt, now_s)
        self.entries.append(entry)
        return entry

    def peek_key(self, now_s: float, aging_rate: float):
        if not self.entries:
            return None
        return min(e.aged_key(now_s, aging_rate) for e in self.entries)

    def pop_best(self, now_s: float, aging_rate: float
                 ) -> Optional[_Parked]:
        if not self.entries:
            return None
        # by position, not ``list.remove``: that compares entries with
        # ``==``, which on two parked carries (numpy arrays) raises
        i = min(range(len(self.entries)),
                key=lambda j: self.entries[j].aged_key(now_s, aging_rate))
        best = self.entries.pop(i)
        self.refund(best.ckpt.nbytes)
        return best

    def drain(self) -> List[_Parked]:
        """Remove (and un-charge) everything — the class-failure path."""
        out, self.entries = self.entries, []
        for e in out:
            self.refund(e.ckpt.nbytes)
        return out


class _ClassRun:
    """One query class's lane table + per-tenant queues + graph pin +
    parked lanes."""

    def __init__(self, splan: StepperPlan, slots: int, cap: int, lease,
                 parked: ParkedQueue, *, trace=None,
                 label: Optional[str] = None):
        self.splan = splan
        self.cap = cap
        self.lease = lease                      # GraphLease or None
        # per-device attribution for shard classes: the mesh devices
        # every superstep dispatch runs on (() for single-device plans)
        mesh = getattr(splan.engine, "mesh", None)
        self.devices: tuple = (
            tuple(mesh.devices) if mesh is not None else ())
        self.table = LaneTable(splan.stepper, slots, splan.query_params,
                               trace=trace, label=label,
                               devices=self.devices)
        self.queues: "Dict[str, collections.deque]" = {}
        self.passes: Dict[str, float] = {}      # stride-scheduling state
        self.parked = parked

    def in_flight(self) -> int:
        return self.table.in_flight()

    def queued(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def lanes_of(self, tenant: str) -> int:
        return self.table.lanes_of(tenant)

    def idle(self) -> bool:
        return (self.queued() == 0 and self.in_flight() == 0
                and len(self.parked) == 0)

    def close(self) -> None:
        if self.lease is not None:
            self.lease.release()
            self.lease = None


class ContinuousScheduler:
    """Slot-array scheduler over step-granular engine plans.

    ``pump()`` advances every class with work by exactly one superstep
    (retire -> admit/restore/preempt -> step); callers loop it —
    synchronously (``drain``) or from the service's scheduler thread.
    Not re-entrant: all public methods serialize on one lock, so a
    ``submit`` racing a ``pump`` just lands in the queue for the next
    inter-superstep admission window. Reads like :meth:`backlog` /
    :meth:`pending` / :meth:`parked` take the same lock, so a stats
    snapshot can never observe a half-spliced slot array (see
    tests/test_continuous.py)."""

    def __init__(self, *, slots: int = 16,
                 max_supersteps: Optional[int] = None,
                 stats=None,
                 get_stepper: Callable[[QueryClass], StepperPlan] = None,
                 on_result: Callable[..., None] = None,
                 tenant_weight: Callable[[str], float] = None,
                 acquire: Callable[[QueryClass], Any] = None,
                 preemption: bool = True,
                 aging_rate: float = 4.0,
                 depth_bucket_s: float = 0.1,
                 preempt_margin_s: float = 0.05,
                 park_charge: Callable[[int], bool] = None,
                 park_release: Callable[[int], None] = None,
                 depth_bucket_of: Callable[
                     [QueryClass, QueryRequest], Optional[str]] = None,
                 trace=None, metrics=None, profile: bool = False):
        assert slots >= 1
        self.slots = slots
        self.max_supersteps = max_supersteps
        self.stats = stats
        # duck-typed event bus (service.trace.TraceBus); None = no tracing
        self.trace = trace
        # duck-typed metrics registry (service.metrics.MetricsRegistry);
        # None = no per-class phase histograms
        self.metrics = metrics
        # when True every class's stepper runs in profiled mode (phase
        # wall split on superstep events + phase histograms)
        self.profile = profile
        self.preemption = preemption
        self.aging_rate = aging_rate
        self.depth_bucket_s = depth_bucket_s
        # a park+restore costs two device splices and a host round trip:
        # only preempt when the arrival is at least this much more
        # urgent than the victim (microsecond-level arrival jitter must
        # never thrash lanes)
        self.preempt_margin_s = preempt_margin_s
        self._get_stepper = get_stepper
        self._on_result = on_result or (lambda req, res, version=0: None)
        self._weight = tenant_weight or (lambda tenant: 1.0)
        self._acquire = acquire or (lambda qclass: None)
        self._park_charge = park_charge
        self._park_release = park_release
        # optional (qclass, request) -> depth-bucket label (e.g. the
        # root's degree decile, "d0".."d9"); sharpens the admission
        # predictor's depth EWMA per bucket. None = class-wide EWMA.
        self._depth_bucket_of = depth_bucket_of
        self._classes: Dict[QueryClass, _ClassRun] = {}
        self._lock = threading.RLock()  # lock: scheduler
        # the admission window between supersteps (_let_arrivals_in):
        # each submit waiting for the lock, by ticket, with the event it
        # sets once it has the lock
        self._arrivals: Dict[int, threading.Event] = {}
        self._tickets = itertools.count()

    # ---------------- admission ---------------------------------------
    def _predict_depth(self, qclass: QueryClass,
                       bucket: Optional[str] = None) -> float:
        if self.stats is None:
            return 0.0
        if bucket:
            _, depth = self.stats.class_cost_model(class_key(qclass),
                                                   bucket=bucket)
        else:
            # plain call keeps duck-typed stats without the bucket
            # keyword working (no bucket to pass anyway)
            _, depth = self.stats.class_cost_model(class_key(qclass))
        return float(depth) if depth is not None else 0.0

    def _depth_residual(self, qclass: QueryClass) -> float:
        if self.stats is None:
            return 1.0
        resid = self.stats.depth_residual(class_key(qclass))
        return float(resid) if resid is not None else 1.0

    def submit(self, qclass: QueryClass, req: QueryRequest, fut) -> None:
        ticket, entered = next(self._tickets), threading.Event()
        self._arrivals[ticket] = entered     # dict ops are atomic
        with self._lock:
            del self._arrivals[ticket]
            entered.set()
            cr = self._classes.get(qclass)
            if cr is None:
                # pin the graph version BEFORE compiling against it: the
                # lease both faults an evicted graph back in and blocks
                # eviction for as long as this class has work
                lease = self._acquire(qclass)
                try:
                    splan = self._get_stepper(qclass)
                except Exception:
                    if lease is not None:
                        lease.release()
                    raise
                from ..core.engine import HARD_SUPERSTEP_CAP
                cap = (self.max_supersteps
                       or splan.engine.kernel.max_supersteps
                       or HARD_SUPERSTEP_CAP)
                cr = _ClassRun(splan, self.slots, cap, lease,
                               ParkedQueue(self._park_charge,
                                           self._park_release),
                               trace=self.trace,
                               label=class_key(qclass))
                # profiled mode is a stepper-level switch: flip it when
                # the class's stepper enters service (steppers are
                # engine-cached per width, so a re-created class run
                # keeps the mode consistent)
                splan.stepper.profile = self.profile
                self._classes[qclass] = cr
            q = cr.queues.get(req.tenant)
            if q is None:
                q = cr.queues[req.tenant] = collections.deque()
            if not q:
                # (re)activating tenant: sync its stride pass to the
                # current frontier so it neither monopolizes lanes (pass
                # stuck at 0) nor is penalized for having been idle
                active = [cr.passes[t] for t, qq in cr.queues.items()
                          if (qq or cr.lanes_of(t)) and t in cr.passes]
                floor = min(active) if active else 0.0
                cr.passes[req.tenant] = max(
                    cr.passes.get(req.tenant, 0.0), floor)
            bucket = (self._depth_bucket_of(qclass, req)
                      if self._depth_bucket_of is not None else None)
            meta = LaneMeta(
                payload=(req, fut), qkw=dict(req.query_kwargs),
                tenant=req.tenant,
                priority=int(getattr(req, "priority", 0)),
                deadline_s=req.deadline_s,
                predicted_depth=self._predict_depth(qclass, bucket),
                seq=int(getattr(req, "qid", 0)),
                depth_bucket=bucket)
            q.append(meta)
            self._emit("queue", qid=meta.seq, tenant=req.tenant,
                       klass=class_key(qclass), priority=meta.priority,
                       predicted_depth=meta.predicted_depth)

    def _emit(self, kind: str, **fields) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **fields)

    def backlog(self, qclass: QueryClass) -> int:
        """Queued (not yet admitted) depth for one class. Taken under
        the scheduler lock: a concurrent pump's slot splice is never
        half-observed."""
        with self._lock:
            cr = self._classes.get(qclass)
            return cr.queued() if cr else 0

    def pending(self) -> int:
        """Queued + in-flight + parked queries across all classes
        (lock-consistent, see :meth:`backlog`)."""
        with self._lock:
            return sum(cr.queued() + cr.in_flight() + len(cr.parked)
                       for cr in self._classes.values())

    def parked(self) -> int:
        """Currently parked (preempted, not yet restored) lanes.
        (Parked BYTES are accounted authoritatively by the GraphStore —
        ``store_parked_bytes`` in the service stats.)"""
        with self._lock:
            return sum(len(cr.parked) for cr in self._classes.values())

    def has_work(self) -> bool:
        return self.pending() > 0

    # ---------------- the superstep pump ------------------------------
    def _let_arrivals_in(self) -> None:
        """Open the admission window before the next superstep takes
        the lock. ``threading`` locks are not fair: a pump that releases
        the lock and takes it again at once mostly wins it back from a
        ``submit`` that is waiting for it, so a submit that raced a
        drain could wait out the whole drain. Every ``submit`` enters an
        event in ``_arrivals`` before it waits for the lock and sets it
        once it has the lock; this waits for the events there on entry
        (later arrivals cannot hold the pump back, and an event once set
        stays set, so several pumping threads miss no wakeup). A pump on
        a thread that already owns the lock (a done-callback that
        queries) does not wait: the submits cannot enter before it
        returns. ``ARRIVAL_WAIT_S`` bounds the wait when the lock's owner
        is itself waiting on this thread."""
        if self._lock._is_owned():
            return
        end = time.monotonic() + ARRIVAL_WAIT_S
        for entered in tuple(self._arrivals.copy().values()):
            if not entered.wait(max(0.0, end - time.monotonic())):
                return

    def pump(self) -> int:
        """One superstep for every class with work; returns the number
        of queries retired. Classes that go idle release their graph
        pin (the store may then evict the graph under budget
        pressure). A ``submit`` already waiting for the lock enters
        before the superstep."""
        retired = 0
        self._let_arrivals_in()
        with self._lock:
            for qclass, cr in list(self._classes.items()):
                retired += self._pump_class(qclass, cr)
                self._reap_if_idle(qclass)
        return retired

    def drain(self, qclass: Optional[QueryClass] = None,
              max_pumps: int = 1_000_000) -> int:
        """Pump until ``qclass`` (or everything) has no queued,
        in-flight or parked queries; returns total retired. The
        scheduler lock is released between supersteps (each pump takes
        it internally), so the between-supersteps admission window stays
        open during a drain: a concurrent ``submit`` lands in the very
        drain it raced with instead of blocking until the whole drain
        finishes."""
        total = 0
        for _ in range(max_pumps):
            if qclass is None:
                if not self.has_work():
                    break
                total += self.pump()
            else:
                self._let_arrivals_in()
                with self._lock:
                    cr = self._classes.get(qclass)
                    if cr is None or cr.idle():
                        self._reap_if_idle(qclass)
                        break
                    total += self._pump_class(qclass, cr)
                    self._reap_if_idle(qclass)
        return total

    # ---------------- internals ---------------------------------------
    def _reap_if_idle(self, qclass: QueryClass) -> None:
        cr = self._classes.get(qclass)
        if cr is not None and cr.idle():
            cr.close()
            del self._classes[qclass]

    def _pump_class(self, qclass: QueryClass, cr: _ClassRun) -> int:
        if cr.idle():
            return 0
        try:
            return self._pump_class_inner(qclass, cr)
        except Exception as exc:    # noqa: BLE001 — fail the slot array
            # Mirror the bucketed batcher's contract: a device/program
            # error must resolve every affected Future, not strand them
            # (and not kill the async scheduler thread). The class state
            # resets; the next submit starts clean.
            self._fail_class(cr, exc)
            return 0

    def _fail_class(self, cr: _ClassRun, exc: Exception) -> None:
        err = type(exc).__name__

        def _emit_err(meta):
            self._emit("retire", qid=meta.seq, tenant=meta.tenant,
                       klass=cr.table.label, reason="error", error=err)

        for meta in cr.table.clear():
            meta.payload[1].set_exception(exc)
            _emit_err(meta)
        for entry in cr.parked.drain():
            entry.ckpt.meta.payload[1].set_exception(exc)
            _emit_err(entry.ckpt.meta)
        for q in cr.queues.values():
            while q:
                meta = q.popleft()
                fut = meta.payload[1]
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)
                    _emit_err(meta)

    def _pump_class_inner(self, qclass: QueryClass, cr: _ClassRun) -> int:
        # retire everything the previous pump's step finished, FIRST,
        # so its freed slots are refilled and stepped in this very pump
        # (no lane idles a superstep while the queue is non-empty)
        retired = self._retire(qclass, cr) if cr.table.carry is not None \
            else 0
        self._admit(qclass, cr)
        if cr.table.carry is None or cr.in_flight() == 0:
            return retired
        # fresh lanes come back from admit with their probe bits, so a
        # dead-on-arrival query is excluded here and retired below at 0
        # supersteps — the stepper analogue of Engine.run's pre-loop
        # cond check
        alive = cr.table.alive_mask(cr.cap)
        if not alive.any():
            return retired + self._retire(qclass, cr)
        eng = cr.splan.engine
        traces0 = eng.traces
        t0 = time.perf_counter()
        cr.table.step(alive)
        wall = time.perf_counter() - t0   # probe return synced the device
        if self.stats is not None:
            self.stats.record_pump_step()
            if eng.traces == traces0:
                self.stats.record_busy(wall, class_key=class_key(qclass))
                self.stats.record_superstep_time(class_key(qclass), wall)
            else:
                # a traced step's wall is compile time, not execution:
                # it would poison the cost model (and, with admission
                # control on, shed the class forever) AND inflate
                # busy_time_s, understating qps_busy/TEPS for the run
                self.stats.record_compile(wall)
        if eng.traces == traces0:
            ck = class_key(qclass)
            # profiled mode: per-class phase histograms + exchange
            # overlap accounting (compile walls excluded for the same
            # reason as above)
            phases = getattr(cr.splan.stepper, "last_phases", None)
            if phases:
                if self.stats is not None and "exchange" in phases:
                    # exposed = the serving schedule's exchange wall;
                    # total = the serial-reference wall (profiled
                    # overlapped steppers time both; synchronous ones
                    # have no reference, so exposed == total -> 1.0)
                    self.stats.record_exchange_overlap(
                        ck, phases["exchange"],
                        phases.get("exchange_serial", phases["exchange"]))
                if self.metrics is not None:
                    for phase, secs in phases.items():
                        self.metrics.observe(
                            "gravfm_superstep_phase_seconds", secs,
                            help="Measured superstep wall split by phase "
                                 "(profiled mode)",
                            **{"class": ck, "phase": phase})
            if self.metrics is not None and cr.devices:
                # per-device attribution: every mesh device ran this
                # superstep's shard_map dispatch
                for dev in cr.devices:
                    self.metrics.inc(
                        "gravfm_device_supersteps_total", 1,
                        help="Supersteps dispatched per mesh device "
                             "(shard classes)",
                        **{"class": ck, "device": dev})
        return retired

    # ---------------- queue selection ----------------------------------
    def _order_key(self, meta: LaneMeta):
        """Within-tenant pop order: deadline-priority first (priority,
        then aged deadline, bucketized so near-simultaneous deadlines
        tie), then predicted depth — so, urgency permitting, the refill
        co-schedules lanes of similar predicted depth and they retire
        together (one retire-fetch instead of W)."""
        dl = meta.effective_deadline()
        if self.depth_bucket_s > 0 and math.isfinite(dl):
            dl = math.floor(dl / self.depth_bucket_s)
        return (dl, meta.predicted_depth, meta.seq)

    def _stride_tenant(self, cr: _ClassRun) -> Optional[str]:
        """Weighted fair-share pick: among tenants with queued work, the
        one with the lowest stride pass wins the free lane — subject to
        a soft lane cap (its weighted share of the slot array, rounded
        up) whenever other tenants are also waiting."""
        nonempty = [t for t, q in cr.queues.items() if q]
        if not nonempty:
            return None
        eligible = nonempty
        if len(nonempty) > 1:
            total_w = sum(self._weight(t) for t in nonempty)
            under_cap = [
                t for t in nonempty
                if cr.lanes_of(t) < max(1, int(np.ceil(
                    cr.table.width * self._weight(t) / total_w)))]
            if under_cap:
                eligible = under_cap
        return min(eligible, key=lambda t: (cr.passes.get(t, 0.0), t))

    def _pop_from(self, cr: _ClassRun, tenant: str) -> Optional[LaneMeta]:
        """Pop the tenant's best item by deadline-priority/depth order
        and transition its Future to RUNNING; cancelled stragglers are
        dropped on the way."""
        q = cr.queues[tenant]
        while q:
            best = min(q, key=self._order_key)
            q.remove(best)
            if best.payload[1].set_running_or_notify_cancel():
                cr.passes[tenant] = (cr.passes.get(tenant, 0.0)
                                     + 1.0 / self._weight(tenant))
                return best
        return None

    def _next_item(self, cr: _ClassRun) -> Optional[LaneMeta]:
        while True:
            tenant = self._stride_tenant(cr)
            if tenant is None:
                return None
            item = self._pop_from(cr, tenant)
            if item is not None:
                return item
            # tenant's queue was all cancelled stragglers — re-pick

    def _pop_urgent(self, cr: _ClassRun, threshold
                    ) -> Optional[LaneMeta]:
        """Pop the most urgent queued item strictly more urgent than
        ``threshold`` (any tenant — a tight deadline overrides fair
        share; the tenant's stride pass is still charged)."""
        while True:
            cands = [(m.effective_deadline(), t)
                     for t, q in cr.queues.items() for m in q]
            if not cands:
                return None
            key, tenant = min(cands)
            if not key < threshold:
                return None
            q = cr.queues[tenant]
            best = min(q, key=lambda m: m.effective_deadline())
            q.remove(best)
            if best.payload[1].set_running_or_notify_cancel():
                cr.passes[tenant] = (cr.passes.get(tenant, 0.0)
                                     + 1.0 / self._weight(tenant))
                return best
            # cancelled — re-scan

    # ---------------- admit / restore / preempt ------------------------
    def _admit(self, qclass: QueryClass, cr: _ClassRun) -> None:
        """The between-supersteps admission window: restore parked lanes
        and splice queued queries into free slots by deadline priority,
        then preempt for still-queued tight-deadline arrivals."""
        # drop cancelled stragglers up front: they must neither divert a
        # slot from a parked lane (their deadline would poison the peek
        # below) nor pin the class as pending forever (pre-purge, a
        # tenant whose queue was ALL cancelled could live-lock the
        # stride pick and starve other tenants)
        for q in cr.queues.values():
            for m in [m for m in q if m.payload[1].cancelled()]:
                q.remove(m)
        if cr.queued() == 0 and len(cr.parked) == 0:
            return
        now = time.perf_counter()
        assignments: Dict[int, LaneMeta] = {}
        touched: set = set()
        try:
            for slot in cr.table.free_slots():
                parked_key = cr.parked.peek_key(now, self.aging_rate)
                # compare against what the fair-share pick would
                # actually admit (the stride-selected tenant's most
                # urgent item), not the global queue minimum — a parked
                # lane more urgent than the real admit candidate must
                # win the slot
                tenant = self._stride_tenant(cr)
                queue_key = (min(m.effective_deadline()
                                 for m in cr.queues[tenant])
                             if tenant is not None else None)
                if parked_key is None and queue_key is None:
                    break
                if parked_key is not None and (queue_key is None
                                               or parked_key <= queue_key):
                    self._restore_parked(cr, slot, now)
                    touched.add(slot)
                    continue
                # pop from the tenant we already stride-selected for the
                # peek above (re-running the selection would both waste
                # a scan and risk disagreeing with the comparison)
                item = self._pop_from(cr, tenant)
                if item is None:
                    # a cancel raced the peek; retry parked, else re-pick
                    if cr.parked.peek_key(now, self.aging_rate) is not None:
                        self._restore_parked(cr, slot, now)
                        touched.add(slot)
                        continue
                    item = self._next_item(cr)
                    if item is None:
                        break
                assignments[slot] = item
                touched.add(slot)
            if assignments:
                cr.table.admit(assignments)
                for slot, meta in assignments.items():
                    self._emit("admit", qid=meta.seq, tenant=meta.tenant,
                               klass=cr.table.label, reason="fresh",
                               slot=slot)
                    if self.stats is not None:
                        # submit->lane wait (the SLO watchdog's
                        # queue_wait_p95 rule reads the percentile)
                        self.stats.record_queue_wait(
                            (now - meta.payload[0].arrival_s) * 1e3)
        except BaseException as exc:   # noqa: BLE001 — no stranding
            # popped-but-not-yet-installed items are invisible to
            # _fail_class (they are in neither the table, the queues,
            # nor the parked queue) — resolve them here, then let the
            # pump's guard fail the rest of the class. Metas the table
            # DID install (admit raises after installing) are skipped:
            # _fail_class owns those.
            for meta in assignments.values():
                if not any(m is meta for m in cr.table.meta):
                    meta.payload[1].set_exception(exc)
            raise
        if self.preemption:
            self._preempt_for_queued(qclass, cr, now, touched)

    def _restore_parked(self, cr: _ClassRun, slot: int,
                        now: float) -> None:
        entry = cr.parked.pop_best(now, self.aging_rate)
        meta = entry.ckpt.meta
        # fold the accrued aging into the lane's deadline credit: once
        # restored it stays more urgent than fresh arrivals, so it is
        # not immediately re-parked (anti-thrash + starvation freedom)
        meta.credit_s += self.aging_rate * (now - entry.parked_at_s)
        t0 = time.perf_counter()
        cr.table.restore(slot, entry.ckpt)
        wall = time.perf_counter() - t0
        if self.stats is not None:
            self.stats.record_restore(wall)
        self._emit("restore", qid=meta.seq, tenant=meta.tenant,
                   klass=cr.table.label, dur_s=wall, slot=slot,
                   parked_s=now - entry.parked_at_s,
                   superstep=entry.ckpt.superstep)

    def _preempt_for_queued(self, qclass: QueryClass, cr: _ClassRun,
                            now: float, touched: set) -> None:
        """Deadline-priority preemption: while a queued request is
        strictly more urgent than the laxest active lane, park that lane
        (latest effective deadline; ties broken toward the highest
        predicted remaining depth — evicting the lane that would hold
        its slot longest) and admit the urgent request into the freed
        slot in the same admission window."""
        resid = self._depth_residual(qclass)
        for _ in range(cr.table.width):
            if cr.queued() == 0:
                return
            cands = [s for s in cr.table.active_slots()
                     if s not in touched]
            if not cands:
                return
            victim = max(cands, key=lambda s: (
                cr.table.meta[s].effective_deadline(),
                cr.table.predicted_remaining(s, resid)))
            vmeta = cr.table.meta[victim]
            if (vmeta.predicted_depth > 0
                    and cr.table.predicted_remaining(victim, resid)
                    <= 1.0):
                return      # victim retires next pump anyway
            nbytes = cr.table.lane_nbytes()
            if not cr.parked.reserve(nbytes):
                return      # park budget exhausted: no preemption
            urgent = self._pop_urgent(
                cr, vmeta.effective_deadline() - self.preempt_margin_s)
            if urgent is None:
                cr.parked.refund(nbytes)
                return
            t0 = time.perf_counter()
            try:
                ckpt = cr.table.checkpoint(victim)
            except BaseException as exc:  # noqa: BLE001 — no stranding
                # the victim is still in the table (_fail_class covers
                # it), but the popped urgent request and the byte
                # reservation are local — resolve and refund them here
                cr.parked.refund(nbytes)
                urgent.payload[1].set_exception(exc)
                raise
            wall = time.perf_counter() - t0
            cr.parked.park(ckpt, now)
            self._emit("park", qid=vmeta.seq, tenant=vmeta.tenant,
                       klass=cr.table.label, dur_s=wall, slot=victim,
                       by=urgent.seq, superstep=ckpt.superstep)
            cr.table.admit({victim: urgent})
            self._emit("admit", qid=urgent.seq, tenant=urgent.tenant,
                       klass=cr.table.label, reason="preempt",
                       slot=victim, victim=vmeta.seq)
            touched.add(victim)
            if self.stats is not None:
                self.stats.record_preempt(wall)

    # ---------------- retirement ---------------------------------------
    def _retire(self, qclass: QueryClass, cr: _ClassRun) -> int:
        """Resolve every occupied lane whose termination mask flipped
        (or that hit the superstep cap); free its slot."""
        done = cr.table.done_slots(cr.cap)
        if not done:
            return 0
        with obs.span("service.retire_fetch"):
            host = cr.table.fetch()
        if self.stats is not None:
            self.stats.record_carry_fetch(tree_nbytes(host))
        now = time.perf_counter()
        for i in done:
            meta = cr.table.release(i)
            req, fut = meta.payload
            try:
                res = cr.splan.engine.lane_result(host, i)
            except Exception as exc:    # noqa: BLE001 — fail one lane
                fut.set_exception(exc)
                self._emit("retire", qid=meta.seq, tenant=req.tenant,
                           klass=cr.table.label, reason="error",
                           error=type(exc).__name__)
                continue
            fut.set_result(res)
            latency_ms = (now - req.arrival_s) * 1e3
            # positive slack = retired before the deadline; negative =
            # a deadline miss (an infinite deadline never misses)
            slack_s = req.deadline_s - now
            missed = slack_s < 0
            if self.stats is not None:
                self.stats.record_retire(
                    messages=res.messages, latency_ms=latency_ms,
                    class_key=class_key(qclass),
                    wire_words=float((getattr(res, "comm", None) or {})
                                     .get("wire_words", 0.0)))
                self.stats.record_query_depth(
                    class_key(qclass), res.supersteps,
                    bucket=getattr(meta, "depth_bucket", None))
                if meta.predicted_depth > 0:
                    self.stats.record_depth_error(
                        class_key(qclass),
                        abs(res.supersteps - meta.predicted_depth))
                self.stats.record_tenant(
                    req.tenant, completed=1, messages=res.messages,
                    latency_ms=latency_ms,
                    deadline_misses=1 if missed else 0)
                if missed:
                    self.stats.record_deadline_miss()
            self._emit("retire", qid=meta.seq, tenant=req.tenant,
                       klass=cr.table.label, reason="retired",
                       supersteps=int(res.supersteps),
                       messages=int(res.messages),
                       deadline_slack_s=(slack_s if math.isfinite(slack_s)
                                         else None),
                       parks=meta.parks)
            self._on_result(req, res, qclass.version)
        return len(done)
