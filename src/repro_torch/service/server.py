"""The graph query service: accept single queries, batch compatible
ones under their latency deadlines, dispatch to cached compiled plans,
return per-query :class:`EngineResult`\\ s.

The port's copy of ``repro.service.server``: ``GraphQueryService(device=
None, ...)`` serves on the card unless ``device="cpu"`` is given, over
the port's engines, with ``backend="kernel"`` (the CUDA kernel) by
default and ``"ref"`` (the oracle) when asked for. The roofline
telemetry projects against ``roofline_platform``: by default the paper's
FPGA platform (``perfmodel.PAPER_PLATFORM``), as the JAX service does;
``roofline_platform=perfmodel.H100`` projects against the card, with the
cycles per edge measured there (``perfmodel.H100_ALGOS``).

Two scheduling policies share the admission/plan/stats machinery
(``scheduling=`` constructor arg):

  bucketed   — form a batch, run its whole superstep loop to
      completion, return to the queue (batching.py). Simple, maximal
      sharing, but every member pays the slowest member's depth.

  continuous — a fixed-width slot array per class steps one superstep
      at a time; finished queries retire mid-flight and new arrivals
      splice into freed slots between supersteps (continuous.py, built
      on the engines' step-granular SuperstepProgram). Short queries
      stop paying long-query latency.

Two operating modes as well:

  synchronous — ``submit()`` queues and returns a Future; dispatch
      happens when a batch fills, when ``poll()`` observes a due
      deadline (or pumps a superstep), or on ``flush()``.
      Deterministic; what the tests and benchmarks drive.

  async — ``start()`` spawns a scheduler thread that sleeps until the
      earliest pending flush time (or a new arrival) and dispatches due
      batches / pumps in-flight supersteps; ``submit()`` then behaves
      like a fire-and-forget RPC whose Future resolves within the
      request's deadline budget.

On top of both sit a bounded-LRU **result cache** (identical
(graph, version, kernel, mode, query kwargs) hits resolve without
touching the scheduler) and optional **admission control** (requests
whose deadline is already infeasible given the backlog and the class's
observed per-superstep cost fail fast with :class:`AdmissionError`).

Multi-tenant serving adds the :class:`~repro_torch.store.GraphStore`
underneath: graphs are **versioned** (``publish`` swaps in version N+1
atomically — in-flight queries drain on N, new arrivals bind N+1) and
**memory-budgeted** (LRU eviction of unpinned graphs when
``memory_budget`` — or ``platform.m_board`` — is exceeded, transparent
refault on next query). Per-tenant **quotas** (token-bucket admission)
and **fair-share weights** (weighted slots in the continuous scheduler)
are configured with :meth:`set_tenant`.

Budget evictions **spill to host** by default: the evicted
layout's arrays are demoted to host copies and the version keeps its
compiled plans, so a refault is a device re-upload — no re-partition,
zero re-traces. ``spill_budget`` caps the host tier (0 restores the
discard-on-evict behavior), and faults **materialize outside the store
lock**, so one tenant's cold fault cannot head-of-line-block another
tenant's submits. ``store_spills`` / ``store_spilled_bytes`` /
``store_discards`` / ``store_refault_upload_ms`` join the stats
endpoint.

Continuous lanes are **preemptible**: admission is
deadline-priority (``QueryRequest.priority``, then aged deadlines, then
predicted depth — see continuous.py), and a tight-deadline arrival that
finds every slot busy parks the laxest active lane's carry on the host
(charged against the store's spill budget) and takes its slot; the
parked query is restored bit-identically when a slot frees, with
deadline aging guaranteeing it cannot starve. ``preemption=False``
restores the strictly run-to-retire behavior; ``aging_rate`` tunes the
starvation-protection clock. ``preemptions`` / ``parked_lanes`` /
``lane_restores`` / ``park_restore_ms`` / ``depth_pred_abs_err`` join
the stats endpoint.

The paper's engine answers one traversal per elaborated design; this
server is the ROADMAP's "heavy traffic" counterpart — many BFS/SSSP
roots per superstep loop, one broadcast per superstep shared by the
whole batch, and steady-state serving that never re-partitions or
re-traces (see plans.py).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import perfmodel
from ..core.algorithms import ALGORITHMS
from ..core.engine import EngineResult, resolve_device
from ..core.graph import Graph
from ..store import GraphStore, StoreError, TenantRegistry
from .batching import (BATCH_BUCKETS, AdmissionError, Batcher, QueryClass,
                       QueryRequest, bucket_for)
from .continuous import ContinuousScheduler, class_key
from .metrics import (MetricsRegistry, Watchdog, WatchdogConfig,
                      feed_service_snapshot)
from .plans import PlanCache, PlanKey, check_backend, check_exchange
from .stats import ServiceStats
from .trace import TraceBus

__all__ = ["GraphQueryService"]


class GraphQueryService:
    """Batched multi-query front-end over the GraVF-M engine."""

    def __init__(self, *, device=None, num_shards: int = 4,
                 max_batch: int = 32,
                 backend: str = "kernel", partition_method: str = "greedy",
                 exchange: str = "",
                 overlap: bool = False,
                 root_depth_buckets: bool = True,
                 slack_ms: float = 5.0,
                 scheduling: str = "bucketed",
                 slots: Optional[int] = None,
                 max_supersteps: Optional[int] = None,
                 result_cache_size: int = 256,
                 admission_control: bool = False,
                 preemption: bool = True,
                 aging_rate: float = 4.0,
                 preempt_margin_s: float = 0.05,
                 depth_bucket_s: float = 0.1,
                 memory_budget: Optional[float] = None,
                 spill_budget: Optional[float] = None,
                 platform=None,
                 versioned: bool = True,
                 store: Optional[GraphStore] = None,
                 tenants: Optional[TenantRegistry] = None,
                 plan_cache: Optional[PlanCache] = None,
                 stats: Optional[ServiceStats] = None,
                 tracing: bool = True,
                 trace_capacity: int = 65536,
                 roofline_platform=None,
                 metrics: bool = True,
                 watchdog: bool = False,
                 watchdog_config: Optional[WatchdogConfig] = None,
                 profile_phases: bool = False):
        assert scheduling in ("bucketed", "continuous")
        self.num_shards = num_shards
        self.max_batch = max_batch
        self.backend = check_backend(backend)
        self.partition_method = partition_method
        # default shard exchange schedule: "" serves via the single-host
        # Engine; "allgather"/"ring"/"frontier"/"unicast"/"combined"
        # serve via a ShardEngine whose num_shards shards all live on
        # the service's device (LocalMesh). A request's
        # ``exchange`` field overrides per query class.
        self.exchange = check_exchange(exchange)
        # default exchange pipelining: overlap the exchange collective
        # with local scatter/combine (bit-identical; shard classes
        # only). A request's ``overlap`` field opts in per query; both
        # schedules of a class share one engine, so mixing them serves
        # from the same device-resident graph with zero steady-state
        # re-traces.
        self.overlap = bool(overlap and exchange)
        # per-root depth prediction: bucket the depth EWMA by the
        # root's out-degree decile ("d0".."d9") so depth packing and
        # victim selection see root-conditioned estimates
        self.root_depth_buckets = root_depth_buckets
        self._degree_deciles: Dict[Any, Any] = {}  # (gid, ver) -> (deg, cuts)
        self.scheduling = scheduling
        self.max_supersteps = max_supersteps
        self.result_cache_size = result_cache_size
        self.admission_control = admission_control
        self.stats = stats or (plan_cache.stats if plan_cache
                               else ServiceStats())
        # Lifecycle event bus. Always constructed (so dump_trace/
        # trace_snapshot exist either way); tracing=False leaves it
        # disabled and every emit is one attribute read.
        self.trace = TraceBus(capacity=trace_capacity, enabled=tracing)
        # Aggregate metrics registry (same always-constructed contract):
        # a pull-time collector maps stats_snapshot() onto counters/
        # gauges at scrape, so serving pays nothing per query.
        self.metrics = MetricsRegistry(enabled=metrics)
        self.metrics.add_collector(self._collect_metrics)
        self.profile_phases = profile_phases
        self._watchdog: Optional[Watchdog] = None
        self._watchdog_on = watchdog
        self._watchdog_config = watchdog_config
        if plan_cache is not None:
            # the cache brings its own store; silently dropping these
            # would leave an operator believing residency is capped
            if (store is not None or memory_budget is not None
                    or spill_budget is not None
                    or platform is not None or not versioned):
                raise ValueError(
                    "plan_cache and store/memory_budget/spill_budget/"
                    "platform/versioned are mutually exclusive — "
                    "configure the GraphStore the PlanCache was built "
                    "with instead")
            if (device is not None
                    and resolve_device(device) != plan_cache.device):
                raise ValueError(
                    f"device {device!r} differs from the plan cache's "
                    f"{plan_cache.device}")
            self.plans = plan_cache
        else:
            store = store or GraphStore(
                budget_bytes=memory_budget, platform=platform,
                versioned=versioned, num_shards=num_shards,
                method=partition_method,
                spill_budget_bytes=spill_budget)
            self.plans = PlanCache(stats=self.stats, store=store,
                                   device=device)
        # One shared counter object, or the cache-level hits/misses/traces
        # split off from the endpoint and under-report.
        self.plans.stats = self.stats
        self.store: GraphStore = self.plans.store
        # the device every engine of this service runs on (the card
        # unless device="cpu" was asked for)
        self.device = self.plans.device
        self.tenants = tenants or TenantRegistry()
        self._batcher = Batcher(max_batch=max_batch, slack_ms=slack_ms)
        self._slots = slots or max_batch
        self._continuous: Optional[ContinuousScheduler] = None
        if scheduling == "continuous":
            self._continuous = ContinuousScheduler(
                slots=self._slots, max_supersteps=max_supersteps,
                stats=self.stats, get_stepper=self._stepper_for,
                on_result=self._store_result,
                tenant_weight=self.tenants.weight,
                acquire=self._acquire_class,
                preemption=preemption, aging_rate=aging_rate,
                preempt_margin_s=preempt_margin_s,
                depth_bucket_s=depth_bucket_s,
                park_charge=self.store.reserve_parked,
                park_release=self.store.release_parked,
                depth_bucket_of=self._depth_bucket_of,
                trace=self.trace, metrics=self.metrics,
                profile=profile_phases)
        # Result cache PARTITIONED BY TENANT: each tenant gets its own
        # bounded LRU of ``result_cache_size`` entries, so one tenant's
        # burst of novel queries cannot evict another tenant's hot
        # results. The partition COUNT is itself LRU-bounded — tenant
        # is a free-form request field, and without the cap a stream of
        # distinct tenant names would grow the cache without limit.
        self._result_cache: \
            "collections.OrderedDict[str, collections.OrderedDict]" = \
            collections.OrderedDict()
        self._rc_max_tenants = 64
        # Leaf lock: _store_result is called from the scheduler thread
        # while it holds the continuous scheduler's lock, so the cache
        # must never share the service lock (ABBA deadlock with submit).
        self._rc_lock = threading.Lock()  # lock: rcache
        # superseded versions' cached results can never match a lookup
        # again (new arrivals bind the new version) — purge them instead
        # of letting dead entries squeeze live ones out of the LRU
        self.store.add_evict_listener(self._purge_stale_results)
        # residency transitions land on the same bus as query lifecycle
        # events, so a trace shows "this query's restore stalled on that
        # graph's refault" on one timeline
        self.store.set_trace(self.trace)
        # roofline telemetry: class key -> the §5 performance model's
        # projected TEPS (T_sys). The projector runs outside the stats
        # lock and is cached per class (limits() is pure arithmetic but
        # host_graph takes the store lock).
        self._class_meta: Dict[str, QueryClass] = {}
        self._limits_cache: \
            Dict[str, Optional[Dict[str, float]]] = {}
        self._roofline_platform = (roofline_platform or platform
                                   or perfmodel.PAPER_PLATFORM)
        self.stats.set_roofline_projector(self._project_teps)
        self._lock = threading.RLock()  # lock: server
        self._wake = threading.Condition(self._lock)  # lock: server
        # Serializes plan lookup + execution: PlanCache is not internally
        # locked (its contract is "callers serialize dispatch"), and a
        # full-batch submit() can race the scheduler thread's poll().
        self._dispatch_lock = threading.Lock()  # lock: dispatch
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # ---------------- admission ---------------------------------------
    def add_graph(self, graph_id: str, graph: Graph,
                  **kwargs) -> "GraphQueryService":
        """Register + partition a graph for serving. Idempotent for
        identical content; different content under an existing id is a
        **version publish** (new arrivals bind the new version while
        in-flight queries drain on the old one) — or, when the store was
        built with ``versioned=False``, a
        :class:`~repro_torch.store.StoreError`."""
        self.publish(graph_id, graph, **kwargs)
        return self

    def publish(self, graph_id: str, graph: Graph, **kwargs) -> int:
        """Publish the next version of ``graph_id``; returns the version
        number now served to new arrivals."""
        kwargs.setdefault("num_shards", self.num_shards)
        kwargs.setdefault("method", self.partition_method)
        return self.store.publish(graph_id, graph, **kwargs)

    def set_tenant(self, name: str, *, weight: float = 1.0,
                   rate_qps: Optional[float] = None,
                   burst: Optional[float] = None) -> "GraphQueryService":
        """Configure one tenant's fair-share ``weight`` and optional
        token-bucket quota (``rate_qps`` sustained, ``burst`` headroom).
        Unconfigured tenants serve at weight 1.0, unlimited."""
        self.tenants.configure(name, weight=weight, rate_qps=rate_qps,
                               burst=burst)
        return self

    def warm(self, graph_id: str, kernel: str, *, mode: str = "gravfm",
             batch_sizes: Optional[List[int]] = None,
             exchange: Optional[str] = None,
             overlap: Optional[bool] = None) -> None:
        """Pre-trace plans for a query class so first requests don't pay
        compile latency (steady-state serving then re-traces nothing).
        Defaults to EVERY bucket up to max_batch — deadline flushes
        dispatch partial batches, so intermediate buckets are hot paths
        too. ``overlap`` warms that exchange schedule (default: the
        service's); warm both to serve per-request toggling re-trace
        free."""
        version = self.store.known_version(graph_id)
        exchange = self.exchange if exchange is None else exchange
        overlap = bool((self.overlap if overlap is None else overlap)
                       and exchange)
        kern = ALGORITHMS[kernel]() if kernel in ALGORITHMS else None
        if (self._continuous is not None and kern is not None
                and kern.query_params):
            # continuous serving compiles exactly one slot-width stepper
            # per class; pre-trace its init/admit/step/probe programs
            splan = self._stepper_for(QueryClass(
                graph_id, kernel, mode, self.num_shards, self.backend,
                version, exchange, overlap))
            qkw = {p: np.zeros((self._slots,), np.int32)
                   for p in splan.query_params}
            # profiled serving dispatches the phase programs instead of
            # the fused step — warm whichever path will actually run
            splan.stepper.profile = self.profile_phases
            carry, _, _ = splan.stepper.init(qkw)
            carry, _, _ = splan.stepper.admit(
                carry, qkw, np.zeros(self._slots, bool))
            carry, _, _ = splan.stepper.step(
                carry, np.zeros(self._slots, bool))
            # pre-trace the preemption verbs too: parking and restoring
            # lanes is then also a zero-re-trace steady-state operation
            ckpt = splan.stepper.fetch_lane(carry, 0)
            splan.stepper.restore(carry, ckpt,
                                  np.zeros(self._slots, bool))
            self.plans.sync_trace_counters()
            return
        if batch_sizes is None:
            sizes = sorted({bucket_for(n, self.max_batch)
                            for n in BATCH_BUCKETS if n <= self.max_batch}
                           | {1, self.max_batch})
        else:
            sizes = batch_sizes
        for b in sizes:
            self.plans.get_plan(
                self._plan_key(graph_id, kernel, mode, b, version,
                               exchange=exchange, overlap=overlap),
                method=self.partition_method, warm=True)
        self.plans.sync_trace_counters()

    def submit(self, req: QueryRequest) -> "Future[EngineResult]":
        """Queue one query; the Future resolves to its EngineResult."""
        return self._submit(req)[0]

    def _submit(self, req: QueryRequest):
        """submit() plus the QueryClass the request actually bound —
        callers that later flush/drain this specific request must use
        the returned class, not re-resolve the version (a concurrent
        publish would point them at a class the request isn't in)."""
        kernel = ALGORITHMS.get(req.kernel)
        if kernel is None:
            raise KeyError(f"unknown kernel {req.kernel!r}")
        kernel = kernel()
        # Exact-match validation: a missing param would make the outcome
        # traffic-dependent (kernel default when dispatched solo, KeyError
        # when co-batched), so require the full declared set up front.
        got, want = set(req.query_kwargs), set(kernel.query_params)
        if got != want:
            raise ValueError(
                f"{req.kernel} takes query params "
                f"{tuple(kernel.query_params)}; got "
                f"{sorted(got) or 'none'}"
                + (f" (missing {sorted(want - got)})" if want - got else ""))
        fut: "Future[EngineResult]" = Future()
        # New arrivals bind the latest published version; anything
        # already queued/in flight keeps draining on its bound version.
        version = self.store.known_version(req.graph_id)
        qclass = QueryClass.of(req, self.num_shards, self.backend, version,
                               exchange=self.exchange, overlap=self.overlap)
        batchable = (bool(kernel.query_params) and self.max_batch > 1)
        self.stats.record_submit()
        self.stats.record_tenant(req.tenant, submitted=1)
        self.trace.emit("submit", qid=req.qid, tenant=req.tenant,
                        klass=class_key(qclass),
                        deadline_ms=req.deadline_ms, kernel=req.kernel,
                        ts=req.arrival_s)
        # Result cache: an identical completed query resolves right here,
        # without touching either scheduler (and without charging the
        # tenant's token bucket — a hit consumes no engine resources).
        cached = self._lookup_result(req, version)
        if cached is not None:
            if fut.set_running_or_notify_cancel():
                fut.set_result(cached)
            latency_ms = (time.perf_counter() - req.arrival_s) * 1e3
            self.stats.record_result_hit(latency_ms)
            self.stats.record_tenant(req.tenant, completed=1,
                                     result_hits=1,
                                     latency_ms=latency_ms)
            self.trace.emit("retire", qid=req.qid, tenant=req.tenant,
                            klass=class_key(qclass), reason="cache")
            return fut, qclass
        # Per-tenant quota: shed when the tenant's token bucket is dry.
        if not self.tenants.admit(req.tenant):
            self.stats.record_shed()
            self.stats.record_tenant(req.tenant, shed=1)
            self.trace.emit("shed", qid=req.qid, tenant=req.tenant,
                            klass=class_key(qclass), reason="quota")
            fut.set_exception(AdmissionError(
                f"tenant {req.tenant!r} exceeded its rate quota "
                f"({self.tenants.policy(req.tenant).rate_qps} qps)"))
            return fut, qclass
        # Admission control: shed what cannot meet its deadline anyway.
        if self._should_shed(req, qclass):
            self.stats.record_shed()
            self.stats.record_tenant(req.tenant, shed=1)
            self.trace.emit("shed", qid=req.qid, tenant=req.tenant,
                            klass=class_key(qclass), reason="deadline")
            fut.set_exception(AdmissionError(
                f"deadline {req.deadline_ms:.1f}ms infeasible for "
                f"{class_key(qclass)} given current backlog"))
            return fut, qclass
        # The request now holds its OWN pin from enqueue to resolution
        # (the done-callback): without it a queued-but-undispatched
        # bucketed request leaves its version unpinned, and a publish()
        # in that window would retire the version out from under the
        # batch it is waiting in. Acquired only HERE — after the
        # cache-hit/quota/deadline-shed early exits — so requests that
        # never reach the engine cannot fault evicted graphs back in or
        # budget-sweep other tenants' residents.
        lease = None
        if version:
            lease = self.store.acquire(req.graph_id)
            if lease.version != version:    # publish raced the checks
                version = lease.version
                qclass = QueryClass.of(req, self.num_shards, self.backend,
                                       version, exchange=self.exchange,
                                       overlap=self.overlap)
            fut.add_done_callback(lambda _f: lease.release())
        # the class's graph/kernel/mode are now final (the lease rebind
        # above may have bumped the version) — remember them so the
        # roofline projector can resolve this class key to a workload
        self._class_meta.setdefault(class_key(qclass), qclass)
        try:
            if self._continuous is not None and batchable:
                # enqueue OUTSIDE the service lock: the scheduler thread
                # takes the scheduler lock first (pump), so nesting it
                # under self._wake here would invert the lock order
                self._continuous.submit(qclass, req, fut)
                with self._wake:
                    self._wake.notify()
                return fut, qclass
            with self._wake:
                ready = self._batcher.add(qclass, (req, fut), batchable)
                self._wake.notify()
            self.trace.emit("queue", qid=req.qid, tenant=req.tenant,
                            klass=class_key(qclass))
            if ready is not None:
                self._dispatch(*ready)
            return fut, qclass
        except BaseException:
            # the Future will never resolve, so its done-callback will
            # never fire — release the pin here or it leaks forever
            if lease is not None:
                lease.release()
            raise

    # ---------------- result cache / admission control ----------------
    def _purge_stale_results(self, graph_id: str, version: int) -> None:
        """Store-discard listener (fires under the store lock; spills
        never reach here). A spill-overflow discard keeps the version
        valid — a later cold fault is bit-identical, so its cached
        results stay. Only a SUPERSEDED version's entries are dead
        weight."""
        known = self.store.known_version(graph_id)
        if known and version >= known:
            return      # budget eviction of the live version: still valid
        with self._rc_lock:
            for part in self._result_cache.values():
                for k in [k for k in part
                          if k[0] == graph_id and k[1] == version]:
                    del part[k]

    def _result_key(self, req: QueryRequest, version: int):
        try:
            kw = tuple(sorted((k, np.asarray(v).item())
                              for k, v in req.query_kwargs.items()))
        except (TypeError, ValueError):
            return None    # non-scalar / unhashable kwargs: don't cache
        # version in the key: results computed on graph version N must
        # never answer queries bound to N+1
        return (req.graph_id, version, req.kernel, req.mode, kw)

    @staticmethod
    def _copy_result(res: EngineResult) -> EngineResult:
        """Defensive copy: cached entries and cache hits must not alias
        a caller's (mutable numpy) state arrays — a client editing its
        result in place would otherwise poison every later hit."""
        return EngineResult(
            state={k: np.array(v) for k, v in res.state.items()},
            supersteps=res.supersteps,
            messages=res.messages,
            comm=dict(res.comm),
            raw_state=(None if res.raw_state is None else
                       {k: np.array(v) for k, v in res.raw_state.items()}),
        )

    def _lookup_result(self, req: QueryRequest,
                       version: int) -> Optional[EngineResult]:
        """Per-tenant partition lookup: a hit only ever comes from the
        requesting tenant's own LRU, so partitions are also an isolation
        boundary (tenant A can never observe whether tenant B ran a
        query)."""
        if self.result_cache_size <= 0:
            return None
        key = self._result_key(req, version)
        if key is None:
            return None
        with self._rc_lock:
            part = self._result_cache.get(req.tenant)
            res = part.get(key) if part is not None else None
            if res is not None:
                part.move_to_end(key)
                self._result_cache.move_to_end(req.tenant)
        return self._copy_result(res) if res is not None else None

    def _store_result(self, req: QueryRequest, res: EngineResult,
                      version: int = 0) -> None:
        if self.result_cache_size <= 0:
            return
        key = self._result_key(req, version)
        if key is None:
            return
        res = self._copy_result(res)
        with self._rc_lock:
            part = self._result_cache.get(req.tenant)
            if part is None:
                part = self._result_cache[req.tenant] = \
                    collections.OrderedDict()
                while len(self._result_cache) > self._rc_max_tenants:
                    self._result_cache.popitem(last=False)
            part[key] = res
            part.move_to_end(key)
            self._result_cache.move_to_end(req.tenant)
            # each tenant's partition is bounded independently — one
            # tenant filling its own LRU evicts only its own entries
            while len(part) > self.result_cache_size:
                part.popitem(last=False)

    def _should_shed(self, req: QueryRequest, qclass: QueryClass) -> bool:
        """Deadline-infeasibility test from the class's observed cost
        model (EWMA superstep wall time × EWMA depth × backlog waves).
        Conservative by construction: sheds nothing until both EWMAs
        have been observed."""
        if not self.admission_control:
            return False
        step_ms, depth = self.stats.class_cost_model(class_key(qclass))
        if step_ms is None or depth is None:
            return False
        if self._continuous is not None:
            backlog = self._continuous.backlog(qclass)
            width = self._slots
        else:
            with self._wake:
                backlog = self._batcher.pending_in_class(qclass)
            width = self.max_batch
        waves = 1 + backlog // max(width, 1)
        est_ms = step_ms * depth * waves
        return time.perf_counter() + est_ms / 1e3 > req.deadline_s

    def _depth_bucket_of(self, qclass: QueryClass,
                         req: QueryRequest) -> Optional[str]:
        """Root-degree-decile label ("d0".."d9") for per-root depth
        prediction: the query root's out-degree decile within its graph
        version. High-degree roots reach the frontier's bulk in fewer
        supersteps than leaf roots, so conditioning the depth EWMA on
        the decile sharpens both depth packing and victim selection.
        None (class-wide EWMA) for kernels without a root, unknown
        graphs, or when disabled. Called under the scheduler lock;
        host_graph takes the store lock below it (the declared
        scheduler -> store order)."""
        if not self.root_depth_buckets:
            return None
        root = req.query_kwargs.get("root")
        if root is None:
            return None
        key = (qclass.graph_id, qclass.version)
        entry = self._degree_deciles.get(key)
        if entry is None:
            try:
                g = self.store.host_graph(qclass.graph_id,
                                          qclass.version or None)
            except (StoreError, KeyError, ValueError):
                return None
            deg = g.out_degrees()
            # decile cut points over the degree distribution; a vertex's
            # bucket is how many cuts its degree exceeds
            cuts = np.quantile(deg, np.arange(1, 10) / 10.0)
            # bounded: superseded versions' tables are dead weight
            while len(self._degree_deciles) >= 64:
                self._degree_deciles.pop(next(iter(self._degree_deciles)))
            entry = self._degree_deciles[key] = (deg, cuts)
        deg, cuts = entry
        try:
            r = int(np.asarray(root).item())
        except (TypeError, ValueError):
            return None
        if not 0 <= r < deg.shape[0]:
            return None
        return f"d{int(np.searchsorted(cuts, deg[r], side='right'))}"

    def _acquire_class(self, qclass: QueryClass):
        """Pin ``qclass``'s graph version for the continuous scheduler —
        held from the class's first submit until its last lane retires.
        Unregistered graphs (version 0) carry no pin; the plan lookup
        raises for them instead."""
        if not qclass.version:
            return None
        return self.store.acquire(qclass.graph_id, qclass.version)

    def _stepper_for(self, qclass: QueryClass):
        with self._dispatch_lock:
            return self.plans.get_stepper(
                self._plan_key(qclass.graph_id, qclass.kernel, qclass.mode,
                               self._slots, qclass.version,
                               exchange=qclass.exchange,
                               overlap=getattr(qclass, "overlap", False)),
                method=self.partition_method)

    # ---------------- roofline projection ------------------------------
    def _project_limits(self, ck: str) -> Optional[Dict[str, float]]:
        """The §5 performance model's full ``limits()`` dict for one
        class key (L_PE/L_mem/L_if/L_net/T_sys on the class's graph
        workload at this service's shard count), cached per class. None
        when the graph is gone (superseded and drained) or the kernel
        has no algo profile to extrapolate from."""
        if ck in self._limits_cache:
            return self._limits_cache[ck]
        qclass = self._class_meta.get(ck)
        lim: Optional[Dict[str, float]] = None
        if qclass is not None:
            try:
                g = self.store.host_graph(qclass.graph_id,
                                          qclass.version or None)
                wl = perfmodel.Workload(num_vertices=g.num_vertices,
                                        num_edges=g.num_edges)
                platform = self._roofline_platform
                algos = perfmodel.ALGO_PROFILES.get(platform,
                                                    perfmodel.PAPER_ALGOS)
                algo = algos.get(qclass.kernel)
                if algo is None:
                    # unprofiled kernel: bfs's per-edge/-vertex op counts
                    # are the closest stand-in for a traversal kernel
                    algo = dataclasses.replace(algos["bfs"],
                                               name=qclass.kernel)
                # a shard class's shards share the platform's nodes: on
                # one card (H100, n_nodes_max 1) they share its L_PE and
                # L_mem and cross no wire
                lim = perfmodel.limits(
                    platform, algo, wl,
                    n_nodes=min(self.num_shards, platform.n_nodes_max),
                    mode=qclass.mode,
                    exchange=qclass.exchange or None)
                # overlapped-pipeline terms ride along: T_overlap is
                # the ceiling the pipelined schedule serves against,
                # T_serial the synchronous schedule's realistic limit
                lim = {**lim, **perfmodel.overlapped_limits(lim)}
            except (StoreError, KeyError, ValueError):
                lim = None
        self._limits_cache[ck] = lim
        return lim

    def projected_limits(self, ck: str) -> Optional[Dict[str, float]]:
        """Public per-term model projection for one class key; combine
        with :func:`~repro_torch.core.perfmodel.phase_projection` to set a
        profiled phase split against the model term by term."""
        return self._project_limits(ck)

    def _project_teps(self, ck: str) -> Optional[float]:
        """Projected TEPS (``T_sys``) for one class key — what the
        stats roofline efficiency divides by. None when no projection
        exists; the efficiency metric then reports 0.0 rather than a
        made-up ratio."""
        lim = self._project_limits(ck)
        return float(lim["T_sys"]) if lim is not None else None

    # ---------------- trace export -------------------------------------
    def trace_snapshot(self):
        """Retained lifecycle events (``TraceEvent`` list, emission
        order); ``self.trace.spans()`` assembles them per query."""
        return self.trace.snapshot()

    def dump_trace(self, path: str) -> str:
        """Export the retained events as Chrome trace-event JSON —
        load the file in ``chrome://tracing`` or
        https://ui.perfetto.dev. Returns ``path``."""
        return self.trace.dump(path)

    def query(self, graph_id: str, kernel: str, *, mode: str = "gravfm",
              deadline_ms: float = 50.0, tenant: str = "default",
              **query_kwargs) -> EngineResult:
        """Synchronous convenience: submit one query and wait (flushing
        immediately, so latency = execution time)."""
        req = QueryRequest(
            graph_id=graph_id, kernel=kernel, query_kwargs=query_kwargs,
            mode=mode, deadline_ms=deadline_ms, tenant=tenant)
        # flush only this query's class — other clients' half-filled
        # batches keep accumulating toward their own deadlines. The
        # class comes from _submit, not a fresh version lookup: a
        # publish racing this call must not point the flush at a class
        # the request isn't queued in.
        fut, qclass = self._submit(req)
        self.flush(qclass)
        return fut.result()

    # ---------------- dispatch ----------------------------------------
    def _plan_key(self, graph_id: str, kernel: str, mode: str,
                  batch_size: int, version: int = 0,
                  exchange: Optional[str] = None,
                  overlap: Optional[bool] = None) -> PlanKey:
        ex = self.exchange if exchange is None else exchange
        ov = self.overlap if overlap is None else overlap
        return PlanKey(graph_id=graph_id, kernel=kernel, mode=mode,
                       num_shards=self.num_shards, batch_size=batch_size,
                       backend=self.backend, version=version,
                       exchange=ex, overlap=bool(ov and ex))

    def _dispatch(self, qclass: QueryClass, items: List[Any]) -> None:
        """Execute one formed batch: pad to the plan bucket, run, resolve
        futures, account stats."""
        # Transition every future to RUNNING; ones the client cancelled
        # while queued drop out here (and can no longer be cancelled, so
        # set_result below cannot raise InvalidStateError).
        live = [(r, f) for r, f in items if f.set_running_or_notify_cancel()]
        if not live:
            return
        reqs = [it[0] for it in live]
        futs = [it[1] for it in live]
        n = len(reqs)
        t0 = time.perf_counter()
        with self._dispatch_lock:
            self._dispatch_locked(qclass, reqs, futs, n, t0)

    def _dispatch_locked(self, qclass: QueryClass, reqs, futs, n: int,
                         t0: float) -> None:
        ck = class_key(qclass)
        for r in reqs:
            self.trace.emit("admit", qid=r.qid, tenant=r.tenant,
                            klass=ck, reason="batch", ts=t0,
                            batch_size=n)
            # submit->dispatch wait (the SLO watchdog's queue_wait_p95
            # rule; the continuous path records at lane admission)
            self.stats.record_queue_wait((t0 - r.arrival_s) * 1e3)
        traces_before = self.plans.sync_trace_counters()
        lease = None
        try:
            if qclass.version:
                # pin the graph version for the whole batch: the store
                # may not evict it mid-execution (faults it back in
                # first if it was evicted since registration)
                lease = self.store.acquire(qclass.graph_id, qclass.version)
            # the class's own schedule: a request's ``overlap`` binds it
            # (the reference passes only the exchange here, so its
            # bucketed batches run the service's default schedule)
            plan = self.plans.get_plan(
                self._plan_key(qclass.graph_id, qclass.kernel, qclass.mode,
                               bucket_for(n, self.max_batch),
                               qclass.version, exchange=qclass.exchange,
                               overlap=qclass.overlap),
                method=self.partition_method)
            bucket = plan.key.batch_size
            cap = self.max_supersteps
            if bucket == 1:
                results = []
                for r in reqs:
                    results.extend(plan.execute(cap, **{
                        k: np.asarray(v) for k, v in r.query_kwargs.items()}))
            else:
                arrays = {}
                for p in plan.query_params:
                    col = [r.query_kwargs[p] for r in reqs]
                    col += [col[0]] * (bucket - n)   # pad lanes
                    arrays[p] = np.asarray(col)
                results = plan.execute(cap, **arrays)[:n]
        except Exception as exc:   # noqa: BLE001 — fail the whole batch
            for r, f in zip(reqs, futs):
                f.set_exception(exc)
                self.trace.emit("retire", qid=r.qid, tenant=r.tenant,
                                klass=ck, reason="error",
                                error=type(exc).__name__)
            return
        finally:
            if lease is not None:
                lease.release()
        now = time.perf_counter()
        wall = now - t0
        for f, res in zip(futs, results):
            f.set_result(res)
        traces_after = self.plans.sync_trace_counters()
        compiled = traces_after != traces_before
        self.stats.record_batch(
            n_queries=n, n_pad=max(0, bucket - n) if bucket > 1 else 0,
            # a traced dispatch's wall is compile-dominated: account it
            # to compile_time_s so busy_time_s (the qps_busy/TEPS
            # denominator) stays execution-only, matching the
            # continuous pump's accounting
            wall_s=0.0 if compiled else wall,
            messages=sum(r.messages for r in results),
            supersteps=max((r.supersteps for r in results), default=0),
            latencies_ms=[(now - r.arrival_s) * 1e3 for r in reqs],
            class_key=ck,
            wire_words=sum(float(r.comm.get("wire_words", 0.0))
                           for r in results))
        if compiled:
            self.stats.record_compile(wall)
        # feed the admission-control cost model + the result cache;
        # dispatches that traced (compiled) are excluded from the cost
        # model — a compile wall would poison the EWMA and, with
        # admission control on, shed the class forever
        batch_depth = max((r.supersteps for r in results), default=0)
        if batch_depth > 0 and not compiled:
            self.stats.record_superstep_time(ck, wall, n_steps=batch_depth)
        for r, res in zip(reqs, results):
            self.stats.record_query_depth(ck, res.supersteps)
            slack_s = r.deadline_s - now
            missed = slack_s < 0
            if missed:
                self.stats.record_deadline_miss()
            self.stats.record_tenant(
                r.tenant, completed=1, messages=res.messages,
                latency_ms=(now - r.arrival_s) * 1e3,
                deadline_misses=1 if missed else 0)
            self.trace.emit(
                "retire", qid=r.qid, tenant=r.tenant, klass=ck,
                reason="retired", supersteps=int(res.supersteps),
                messages=int(res.messages),
                deadline_slack_s=(slack_s if np.isfinite(slack_s)
                                  else None),
                ts=now)
            self._store_result(r, res, qclass.version)

    # ---------------- scheduling --------------------------------------
    def poll(self, now_s: Optional[float] = None) -> int:
        """Make one unit of scheduler progress: dispatch every batch
        whose deadline-driven flush time has arrived, and (continuous
        scheduling) pump one superstep across the in-flight slot arrays.
        Returns batches dispatched + queries retired."""
        with self._wake:
            due = self._batcher.due(now_s)
        for qc, items in due:
            self._dispatch(qc, items)
        n = len(due)
        if self._continuous is not None:
            n += self._continuous.pump()
        return n

    def flush(self, qclass: Optional[QueryClass] = None) -> int:
        """Run pending work to completion regardless of deadlines — all
        of it, or only ``qclass``'s: dispatch queued batches, and drain
        the continuous slot arrays (pump until queued + in-flight
        queries of the scope all retire)."""
        with self._wake:
            if qclass is None:
                batches = self._batcher.flush_all()
            else:
                items = self._batcher.pop_class(qclass)
                batches = [(qclass, items)] if items else []
        for qc, items in batches:
            self._dispatch(qc, items)
        n = len(batches)
        if self._continuous is not None:
            n += self._continuous.drain(qclass)
        return n

    def pending(self) -> int:
        with self._lock:
            n = len(self._batcher)
        if self._continuous is not None:
            n += self._continuous.pending()
        return n

    # ---------------- async scheduler thread --------------------------
    def start(self) -> "GraphQueryService":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="gravfm-query-scheduler",
                daemon=True)
            self._thread.start()
        if self._watchdog_on:
            self.start_watchdog()
        return self

    def stop(self, drain: bool = True) -> None:
        self.stop_watchdog()
        with self._wake:
            self._running = False
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if drain:
            self.flush()

    def _loop(self) -> None:
        while True:
            with self._wake:
                if not self._running:
                    return
                busy = (self._continuous is not None
                        and self._continuous.has_work())
                nxt = self._batcher.next_flush_s()
                timeout = (None if nxt is None
                           else max(0.0, nxt - time.perf_counter()))
                # with in-flight continuous lanes, don't sleep — pump
                if not busy and (timeout is None or timeout > 0):
                    self._wake.wait(timeout=timeout)
                if not self._running:
                    return
            self.poll()

    # ---------------- stats endpoint ----------------------------------
    def stats_snapshot(self) -> Dict[str, Any]:
        """The service's /stats payload: throughput (qps, TEPS), latency
        percentiles, batch occupancy, plan-cache counters, graph-store
        residency (resident_bytes / evictions / faults), and the
        per-tenant breakdown."""
        # fold live engines' trace counters first: with the spill tier,
        # evictions no longer drop engines, so nothing else syncs
        # plan_traces on the continuous path
        self.plans.sync_trace_counters()
        snap: Dict[str, Any] = dict(self.stats.snapshot())
        snap["pending"] = self.pending()
        snap["scheduling"] = self.scheduling
        snap["parked_lanes"] = (self._continuous.parked()
                                if self._continuous is not None else 0)
        for k, v in self.store.snapshot().items():
            snap[f"store_{k}"] = v
        snap["tenants"] = self.stats.tenant_snapshot()
        snap["trace_events"] = self.trace.emitted
        snap["trace_dropped"] = self.trace.dropped
        return snap

    # ---------------- metrics endpoint ---------------------------------
    def _collect_metrics(self, reg: MetricsRegistry) -> None:
        """Pull-time feeder registered on :attr:`metrics`: maps the
        current stats snapshot (plus the per-term model limits for every
        live class) onto the registry. Runs outside the registry lock —
        stats_snapshot takes the stats/scheduler/store locks."""
        snap = self.stats_snapshot()
        feed_service_snapshot(
            reg, snap,
            store_counter_keys=type(self.store).METRIC_COUNTER_KEYS)
        for ck in (snap.get("roofline") or {}):
            lim = self._project_limits(ck)
            if lim is None:
                continue
            for term in ("L_PE", "L_mem", "L_if", "L_net", "T_sys",
                         "T_serial", "T_overlap"):
                if term not in lim or not np.isfinite(lim[term]):
                    continue
                reg.set_gauge(
                    "gravfm_model_limit_teps", float(lim[term]),
                    help="Perfmodel §5 limit terms (TEPS) per class",
                    **{"class": ck, "term": term})

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-able registry dump (collectors run first, so values are
        scrape-fresh)."""
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the registry — the scrape
        endpoint payload."""
        return self.metrics.expose_text()

    # ---------------- SLO watchdog -------------------------------------
    def start_watchdog(self, **overrides) -> Watchdog:
        """Start (or return) the background SLO watchdog; ``overrides``
        replace :class:`WatchdogConfig` fields for a fresh start."""
        if self._watchdog is None:
            self._watchdog = Watchdog(self, self._watchdog_config,
                                      **overrides)
            self._watchdog.start()
        return self._watchdog

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    @property
    def watchdog(self) -> Optional[Watchdog]:
        return self._watchdog
