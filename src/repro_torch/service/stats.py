"""Service observability: counters + latency/throughput accounting.

The port's own copy of ``repro.service.stats`` (numpy only): the port
imports nothing of the JAX package.

One :class:`ServiceStats` instance is shared by the plan cache, the
batcher, and the server, so a single ``snapshot()`` is the service's
stats endpoint: queries/sec, p50/p95 latency, TEPS (traversed edges per
second — the paper's §6 throughput metric, here aggregated over every
query the service executed), and the plan-cache hit/miss/trace counters
the zero-retrace guarantee is asserted against.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ServiceStats", "percentile"]


def percentile(values: List[float], q: float) -> float:
    """Linearly interpolated percentile (q in [0, 100]); 0.0 on empty
    input. (The previous nearest-rank form used ``int(round(...))``,
    whose banker's rounding made e.g. p50 of two samples unstable —
    flipping between the lower and upper sample as the window grew.)"""
    if not values:
        return 0.0
    vs = sorted(values)
    pos = min(max(q, 0.0), 100.0) / 100.0 * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    frac = pos - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


@dataclasses.dataclass
class ServiceStats:
    """Thread-safe rolling counters for the query service."""

    queries_submitted: int = 0
    queries_completed: int = 0
    queries_shed: int = 0           # rejected by admission control
    batches_dispatched: int = 0
    batch_pad_queries: int = 0      # padding lanes added to hit a bucket
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_traces: int = 0            # jit traces across all cached engines
    result_cache_hits: int = 0      # memoized EngineResults served
    preemptions: int = 0            # lanes parked for tighter deadlines
    lane_restores: int = 0          # parked lanes spliced back in
    # checkpoint vs restore walls are SEPARATE counters: the two halves
    # of a preemption have different cost structures (park = one-lane
    # device->host fetch, restore = broadcast+select splice) and a
    # regression in either used to hide in their sum
    park_ms: float = 0.0            # wall spent checkpointing (parking)
    restore_ms: float = 0.0         # wall spent restoring parked lanes
    deadline_misses: int = 0        # queries retired past their deadline
    supersteps_total: int = 0
    messages_total: int = 0         # traversed edges (TEPS numerator)
    wire_words_total: float = 0.0   # exchange words moved across shards
    carry_fetch_bytes_total: int = 0  # whole-carry fetches to the host
    busy_time_s: float = 0.0        # wall time spent EXECUTING dispatches
    compile_time_s: float = 0.0     # wall time spent tracing/compiling

    # Percentiles come from a bounded window of recent latencies so a
    # long-running service neither leaks memory nor pays O(total-queries)
    # sorts in snapshot().
    latency_window: int = 8192
    # EWMA smoothing for the per-class superstep wall-time / depth
    # estimates that admission control extrapolates from.
    ewma_alpha: float = 0.2

    def __post_init__(self):
        self._lock = threading.Lock()  # lock: stats
        self._latencies_ms = collections.deque(maxlen=self.latency_window)
        # queue-wait (submit -> lane/batch admission) window: the SLO
        # watchdog's queue_wait_p95 rule reads these percentiles
        self._queue_waits_ms = collections.deque(maxlen=self.latency_window)
        self._started_at = time.perf_counter()
        # per-tenant breakdown (submitted/completed/shed/messages and a
        # bounded latency window) for the multi-tenant stats endpoint
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._tenant_lat: Dict[str, collections.deque] = {}
        # per query-class key: EWMA of one superstep's wall time (ms) and
        # of supersteps-per-query — the service's cost model for deciding
        # whether a deadline is still feasible given the backlog. The
        # depth table additionally holds per-root-degree-decile sub-keys
        # ("<class>|d<decile>"): roots in different degree deciles have
        # systematically different BFS/SSSP depths, so bucketing the
        # EWMA sharpens depth packing and victim selection. Lookups fall
        # back to the plain class key until the bucket has been observed.
        self._step_ms_ewma: Dict[str, float] = {}
        self._depth_ewma: Dict[str, float] = {}
        # EWMA of |observed - predicted| supersteps per class: the
        # depth-prediction residual the preemption victim ranking falls
        # back to once a lane outlives its prediction, and the
        # ``depth_pred_abs_err`` health metric in snapshot()
        self._depth_err_ewma: Dict[str, float] = {}
        # per query-class CUMULATIVE accounting (messages / execution
        # busy seconds / completions) — the measured side of the
        # roofline_efficiency metric. The projected side comes from the
        # injected projector (set_roofline_projector): class key ->
        # perfmodel.limits()["T_sys"] TEPS, or None when unknown.
        self._class_acc: Dict[str, Dict[str, float]] = {}
        self._roofline_fn: Optional[Callable[[str], Optional[float]]] = None

    # ------------------------------------------------------------------
    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self.queries_submitted += n

    def _class_acc_of(self, class_key: str) -> Dict[str, float]:
        acc = self._class_acc.get(class_key)
        if acc is None:
            acc = self._class_acc[class_key] = {
                "messages": 0.0, "busy_s": 0.0, "completed": 0.0,
                "wire_words": 0.0,
                # exchange overlap accounting (profiled shard steppers):
                # exposed = wall the exchange actually spent on the
                # critical path under the serving schedule; total = the
                # same superstep's serial-reference exchange wall
                "exposed_exchange_s": 0.0, "total_exchange_s": 0.0}
        return acc

    def record_batch(self, n_queries: int, n_pad: int, wall_s: float,
                     messages: int, supersteps: int,
                     latencies_ms: List[float],
                     class_key: Optional[str] = None,
                     wire_words: float = 0.0) -> None:
        with self._lock:
            self.batches_dispatched += 1
            self.queries_completed += n_queries
            self.batch_pad_queries += n_pad
            self.busy_time_s += wall_s
            self.messages_total += messages
            self.supersteps_total += supersteps
            self.wire_words_total += wire_words
            self._latencies_ms.extend(latencies_ms)
            if class_key is not None:
                acc = self._class_acc_of(class_key)
                acc["messages"] += messages
                acc["busy_s"] += wall_s
                acc["completed"] += n_queries
                acc["wire_words"] += wire_words

    def record_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.plan_cache_hits += 1
            else:
                self.plan_cache_misses += 1

    def record_traces(self, n: int) -> None:
        with self._lock:
            self.plan_traces += n

    def record_result_hit(self, latency_ms: float) -> None:
        """A memoized result resolved a query without execution (the
        caller also folds it into the tenant breakdown via
        ``record_tenant(..., result_hits=1)``)."""
        with self._lock:
            self.result_cache_hits += 1
            self.queries_completed += 1
            self._latencies_ms.append(latency_ms)

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.queries_shed += n

    def record_queue_wait(self, wait_ms: float) -> None:
        """One query's submit->admission wait (recorded where a request
        leaves a queue for a lane or a dispatched batch)."""
        with self._lock:
            self._queue_waits_ms.append(wait_ms)

    # ---- per-tenant breakdown -----------------------------------------
    def _tenant(self, tenant: str) -> Dict[str, float]:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "submitted": 0, "completed": 0, "shed": 0, "messages": 0,
                "result_cache_hits": 0, "deadline_misses": 0}
            # same window as the aggregate percentiles: a hardcoded 512
            # here used to give tenant p95s different (shorter-memory)
            # semantics than the service-wide ones
            self._tenant_lat[tenant] = collections.deque(
                maxlen=self.latency_window)
        return t

    def record_tenant(self, tenant: str, *, submitted: int = 0,
                      completed: int = 0, shed: int = 0, messages: int = 0,
                      result_hits: int = 0, deadline_misses: int = 0,
                      latency_ms: Optional[float] = None) -> None:
        """Fold one event into ``tenant``'s breakdown (the service calls
        this alongside the aggregate counters)."""
        with self._lock:
            t = self._tenant(tenant)
            t["submitted"] += submitted
            t["completed"] += completed
            t["shed"] += shed
            t["messages"] += messages
            t["result_cache_hits"] += result_hits
            t["deadline_misses"] += deadline_misses
            if latency_ms is not None:
                self._tenant_lat[tenant].append(latency_ms)

    def tenant_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {**vals,
                           "latency_p50_ms": percentile(
                               list(self._tenant_lat[name]), 50),
                           "latency_p95_ms": percentile(
                               list(self._tenant_lat[name]), 95)}
                    for name, vals in self._tenants.items()}

    # ---- per-class cost model (admission control / continuous) --------
    def _ewma(self, table: Dict[str, float], key: str, x: float) -> None:
        prev = table.get(key)
        table[key] = x if prev is None else (
            self.ewma_alpha * x + (1.0 - self.ewma_alpha) * prev)

    def record_busy(self, wall_s: float,
                    class_key: Optional[str] = None) -> None:
        """Wall time spent driving the engine (continuous pump steps —
        bucketed dispatch accounts its own via record_batch). Execution
        only: compile walls go to :meth:`record_compile`. ``class_key``
        additionally attributes the wall to that class's roofline
        accounting."""
        with self._lock:
            self.busy_time_s += wall_s
            if class_key is not None:
                self._class_acc_of(class_key)["busy_s"] += wall_s

    def record_compile(self, wall_s: float) -> None:
        """Wall time spent tracing/compiling a dispatch. Kept out of
        ``busy_time_s`` so ``qps_busy``/TEPS (whose denominator it is)
        reflect steady-state execution, not one-off compiles."""
        with self._lock:
            self.compile_time_s += wall_s

    def record_superstep_time(self, class_key: str, wall_s: float,
                              n_steps: int = 1) -> None:
        """One (or ``n_steps`` uniform) superstep dispatches of
        ``class_key`` took ``wall_s`` seconds of wall time (EWMA feed
        only; busy time is accounted separately)."""
        with self._lock:
            if n_steps > 0:
                self._ewma(self._step_ms_ewma, class_key,
                           wall_s * 1e3 / n_steps)

    def record_query_depth(self, class_key: str, supersteps: int,
                           bucket: Optional[str] = None) -> None:
        """Observed supersteps for one retired query. ``bucket`` (e.g.
        ``"d7"`` for a root in the 7th degree decile) additionally feeds
        the per-bucket depth EWMA the admission predictor prefers."""
        with self._lock:
            self._ewma(self._depth_ewma, class_key, float(supersteps))
            if bucket:
                self._ewma(self._depth_ewma, f"{class_key}|{bucket}",
                           float(supersteps))

    def record_depth_error(self, class_key: str, abs_err: float) -> None:
        """|observed - predicted| supersteps for one retired lane."""
        with self._lock:
            self._ewma(self._depth_err_ewma, class_key, float(abs_err))

    def depth_residual(self, class_key: str) -> Optional[float]:
        """EWMA depth-prediction absolute error for one class (None
        until a prediction has been scored)."""
        with self._lock:
            return self._depth_err_ewma.get(class_key)

    def class_cost_model(self, class_key: str,
                         bucket: Optional[str] = None):
        """(EWMA superstep wall ms, EWMA supersteps per query); either is
        None until observed — admission control then admits everything.
        When ``bucket`` is given the depth estimate prefers the
        root-degree-decile sub-key, falling back to the class-wide EWMA
        until that bucket has retired a query."""
        with self._lock:
            depth = (self._depth_ewma.get(f"{class_key}|{bucket}")
                     if bucket else None)
            if depth is None:
                depth = self._depth_ewma.get(class_key)
            return (self._step_ms_ewma.get(class_key), depth)

    # ---- preemption -----------------------------------------------------
    def record_preempt(self, wall_s: float) -> None:
        """One lane checkpointed (parked) to admit a tighter deadline."""
        with self._lock:
            self.preemptions += 1
            self.park_ms += wall_s * 1e3

    def record_restore(self, wall_s: float) -> None:
        """One parked lane spliced back into a free slot."""
        with self._lock:
            self.lane_restores += 1
            self.restore_ms += wall_s * 1e3

    def record_pump_step(self) -> None:
        """One device superstep executed by the continuous scheduler —
        the same unit record_batch's ``supersteps`` accumulates for
        bucketed dispatch (batch max = device supersteps run), so
        ``supersteps_total`` is comparable across schedulers."""
        with self._lock:
            self.supersteps_total += 1

    def record_retire(self, messages: int, latency_ms: float,
                      class_key: Optional[str] = None,
                      wire_words: float = 0.0) -> None:
        """One query retired mid-flight by the continuous scheduler.
        (Device supersteps are counted per pump via record_pump_step,
        not per query — W lanes share each superstep.)"""
        with self._lock:
            self.queries_completed += 1
            self.messages_total += messages
            self.wire_words_total += wire_words
            self._latencies_ms.append(latency_ms)
            if class_key is not None:
                acc = self._class_acc_of(class_key)
                acc["messages"] += messages
                acc["completed"] += 1
                acc["wire_words"] += wire_words

    def record_carry_fetch(self, nbytes: int) -> None:
        """One whole slot-array carry fetched to the host (the
        continuous scheduler's retirement), ``nbytes`` on the host."""
        with self._lock:
            self.carry_fetch_bytes_total += int(nbytes)

    def record_exchange_overlap(self, class_key: str, exposed_s: float,
                                total_s: float) -> None:
        """One profiled superstep's exchange walls: ``exposed_s`` is
        what the serving schedule actually paid on the critical path,
        ``total_s`` the serial-reference exchange wall for the same
        superstep. Synchronous schedules record exposed == total; the
        ratio surfaces as per-class ``overlap_efficiency``."""
        with self._lock:
            acc = self._class_acc_of(class_key)
            acc["exposed_exchange_s"] += float(exposed_s)
            acc["total_exchange_s"] += float(total_s)

    def record_deadline_miss(self, n: int = 1) -> None:
        """A query completed AFTER its deadline (counted where the
        engine resolves it — bucketed dispatch and continuous retire;
        sheds are not misses, they are ``queries_shed``)."""
        with self._lock:
            self.deadline_misses += n

    # ---- roofline (measured vs modeled) -------------------------------
    def set_roofline_projector(
            self, fn: Optional[Callable[[str], Optional[float]]]) -> None:
        """Install the class-key -> projected-TEPS function (the
        service wires :func:`repro_torch.core.perfmodel.limits` through it).
        The projector is called OUTSIDE the stats lock — it may take
        store locks of its own."""
        self._roofline_fn = fn

    def roofline_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-class measured TEPS vs the performance-model projection:
        ``efficiency`` is the paper's §6 measured-over-modeled ratio
        (GraVF-M reports 0.94 of its projected system limit), computed
        from cumulative per-class messages / execution-busy seconds.
        Classes with no observed busy time report 0.0; classes with no
        projection report ``projected_teps`` 0.0 and efficiency 0.0."""
        with self._lock:
            acc = {ck: dict(a) for ck, a in self._class_acc.items()}
        fn = self._roofline_fn
        out: Dict[str, Dict[str, float]] = {}
        for ck, a in acc.items():
            teps = a["messages"] / a["busy_s"] if a["busy_s"] > 0 else 0.0
            proj = fn(ck) if fn is not None else None
            ww = a.get("wire_words", 0.0)
            out[ck] = {
                "teps": teps,
                "projected_teps": float(proj) if proj else 0.0,
                "efficiency": teps / proj if proj else 0.0,
                "messages": a["messages"],
                "busy_s": a["busy_s"],
                "completed": a["completed"],
                "wire_words": ww,
                # wire cost per traversed edge: the degree-factor
                # compression shows up here as words/message << 1
                "words_per_message": (ww / a["messages"]
                                      if a["messages"] > 0 else 0.0),
            }
            te = a.get("total_exchange_s", 0.0)
            # exposed/total exchange wall: 1.0 = fully synchronous (the
            # exchange is entirely on the critical path), -> 0 = fully
            # hidden behind local compute. None until a profiled
            # superstep has fed the accumulators.
            out[ck]["overlap_efficiency"] = (
                a.get("exposed_exchange_s", 0.0) / te if te > 0 else None)
        return out

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """The stats endpoint payload."""
        with self._lock:
            lat = list(self._latencies_ms)
            qwait = list(self._queue_waits_ms)
            elapsed = max(time.perf_counter() - self._started_at, 1e-9)
            # before any dispatch has run, busy_time_s is exactly 0 and
            # qps_busy/teps must report 0.0 — the old 1e-9 clamp leaked
            # into the numerator-less case and reported astronomically
            # large throughput from an idle service
            busy = self.busy_time_s
            snap = {
                "queries_submitted": self.queries_submitted,
                "queries_completed": self.queries_completed,
                "queries_shed": self.queries_shed,
                "batches_dispatched": self.batches_dispatched,
                "batch_pad_queries": self.batch_pad_queries,
                "avg_batch_size": (
                    self.queries_completed / self.batches_dispatched
                    if self.batches_dispatched else 0.0),
                "plan_cache_hits": self.plan_cache_hits,
                "plan_cache_misses": self.plan_cache_misses,
                "plan_traces": self.plan_traces,
                "result_cache_hits": self.result_cache_hits,
                "preemptions": self.preemptions,
                "lane_restores": self.lane_restores,
                "park_ms": self.park_ms,
                "restore_ms": self.restore_ms,
                # kept as the sum for dashboards that predate the split
                "park_restore_ms": self.park_ms + self.restore_ms,
                "deadline_misses": self.deadline_misses,
                "depth_pred_abs_err": (
                    sum(self._depth_err_ewma.values())
                    / len(self._depth_err_ewma)
                    if self._depth_err_ewma else 0.0),
                "supersteps_total": self.supersteps_total,
                "messages_total": self.messages_total,
                "wire_words_total": self.wire_words_total,
                "carry_fetch_bytes_total": self.carry_fetch_bytes_total,
                "busy_time_s": self.busy_time_s,
                "compile_time_s": self.compile_time_s,
                "qps": self.queries_completed / elapsed,
                "qps_busy": (self.queries_completed / busy
                             if busy > 0 else 0.0),
                "teps": self.messages_total / busy if busy > 0 else 0.0,
                "latency_p50_ms": percentile(lat, 50),
                "latency_p95_ms": percentile(lat, 95),
                "latency_p99_ms": percentile(lat, 99),
                "latency_max_ms": percentile(lat, 100),
                "queue_wait_p50_ms": percentile(qwait, 50),
                "queue_wait_p95_ms": percentile(qwait, 95),
                "uptime_s": elapsed,
            }
        # outside the stats lock: the roofline projector may take the
        # graph store's lock, and store->stats is the established lock
        # order (evict listeners sync trace counters) — nesting the
        # store lock under the stats lock here would be an ABBA inversion
        roofline = self.roofline_snapshot()
        snap["roofline"] = roofline
        snap["roofline_efficiency"] = {
            ck: r["efficiency"] for ck, r in roofline.items()}
        return snap
