"""Compiled-plan cache for the graph query service.

The port's copy of ``repro.service.plans``: its engines are the port's
``Engine`` on the cache's device, and, for the shard classes
(``exchange != ""``), the port's ``ShardEngine`` with all ``num_shards``
shards on that one device (``LocalMesh``), where the JAX service asks
for ``num_shards`` devices.

A *plan* is everything needed to answer a class of queries with zero
per-query setup cost: the partitioned, device-resident graph arrays plus
the (batched) superstep program for one

    (graph id, version, kernel, mode, num_shards, batch size, backend)

query class. Building a plan is expensive (partitioning is O(E) host
work, laying the edges out for the kernel is more); executing one is a
superstep loop over resident arrays. The cache therefore has three levels, each shared by
the level below:

  graphs   held by the :class:`~repro_torch.store.GraphStore` — versioned,
           memory-budgeted, LRU-evicted device residency; partition once
  engines  keyed (graph_id, version, kernel, mode, shards, backend)
                                                    — device arrays once
  plans    keyed PlanKey (adds batch_size)          — first run traced once
  steppers keyed PlanKey (batch_size = slot width)  — the step-granular
           LaneStepper programs the continuous scheduler drives

Steady-state serving hits the plan/stepper level only; the
``plan_traces`` counter (fed by the engines' ``traces``, one count the
first time each program runs at each shape) proves repeated submissions
of the same class re-trace nothing.

``PlanKey.version`` identifies which published version of the graph the
plan was compiled against (0 = resolve the store's latest at lookup
time). Residency hooks follow the store's three-tier state machine:

  * **spill** (budget eviction, host tier enabled): the version's
    engines *offload* their device graph arrays to host copies but the
    compiled plans/steppers stay cached — a refault re-uploads and
    re-traces nothing.
  * **refault** (fires on the faulting thread, outside the store lock):
    the engines' arrays are promoted back to device buffers before the
    lease is handed out.
  * **discard** (spill overflow, version retirement, remove): exactly
    that version's engines/plans/steppers are dropped; every other
    tenant's (and version's) entries stay hot.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.algorithms import ALGORITHMS
from ..core.engine import Engine, EngineResult, resolve_device
from ..core.engine_shardmap import EXCHANGES, ShardEngine, ShardLaneStepper
from ..core.graph import Graph
from ..core.mesh import LocalMesh
from ..core.partition import PartitionedGraph
from ..core.stepper import LaneStepper
from ..store import GraphStore
from .stats import ServiceStats

__all__ = ["PlanKey", "CompiledPlan", "PlanCache", "StepperPlan",
           "check_backend", "check_exchange"]

def check_backend(backend: str) -> str:
    """The port's engines take ``"kernel"`` (the CUDA kernel on the
    card) or ``"ref"`` (the ``scatter_reduce_`` oracle); the JAX
    package's ``"pallas"`` has no meaning here."""
    if backend not in ("kernel", "ref"):
        raise ValueError(f"backend must be 'kernel' (the CUDA kernel) or "
                         f"'ref' (the oracle), got {backend!r}")
    return backend


def check_exchange(exchange: str) -> str:
    """``""`` (the one-device ``Engine``) or one of the shard engine's
    exchanges."""
    if exchange and exchange not in EXCHANGES:
        raise ValueError(f"exchange must be '' or one of {EXCHANGES}, "
                         f"got {exchange!r}")
    return exchange


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one compiled query class."""
    graph_id: str
    kernel: str          # name in core.algorithms.ALGORITHMS
    mode: str            # "gravfm" | "gravf"
    num_shards: int
    batch_size: int      # leading query axis (1 = unbatched program)
    backend: str = "kernel"   # "kernel" (the CUDA kernel) | "ref"
    version: int = 0     # published graph version (0 = latest at lookup)
    exchange: str = ""   # "" = single-host Engine; else ShardEngine mode
                         # ("allgather"|"ring"|"frontier"|"unicast"|
                         #  "combined") over a num_shards-device mesh
    overlap: bool = False  # pipelined exchange schedule (shard classes):
                           # a stepper/plan dimension only — overlapped
                           # and synchronous plans share one engine (the
                           # engine cache key omits it), so toggling
                           # costs one extra trace at warm, zero after

    def __post_init__(self):
        check_backend(self.backend)
        check_exchange(self.exchange)


class CompiledPlan:
    """A cached (engine, batch size) pair ready to execute."""

    def __init__(self, key: PlanKey, engine: "Engine | ShardEngine"):
        self.key = key
        self.engine = engine
        self.executions = 0

    @property
    def query_params(self) -> Tuple[str, ...]:
        return tuple(self.engine.kernel.query_params)

    def execute(self, max_supersteps: "Optional[int]" = None,
                **query_arrays) -> "list[EngineResult]":
        """Run the plan on arrays already padded to ``key.batch_size``
        (scalars allowed when batch_size == 1). Returns per-query
        results in input order. Varying ``max_supersteps`` costs no
        re-trace on the one-device engine (the shard engine counts one
        per superstep cap, as the JAX one does)."""
        self.executions += 1
        # overlap=True only ever reaches a ShardEngine: the key is
        # normalized (overlap implies exchange) before the cache lookup
        ov = {"overlap": True} if self.key.overlap else {}
        if self.key.batch_size == 1:
            entry = "run"
            query_arrays = {k: np.asarray(v).reshape(()) for k, v
                            in query_arrays.items()}
        else:
            entry = "run_batch"
            for k, v in query_arrays.items():
                n = np.asarray(v).shape[0]
                if n != self.key.batch_size:
                    raise ValueError(
                        f"plan expects batch {self.key.batch_size}, got "
                        f"{n} for {k!r}")
        if isinstance(self.engine, Engine):
            # the eager loop: the store's budget charges the engine its
            # data alone, and a superstep graph would hold a carry and a
            # superstep's intermediates on the card from one call to the
            # next, for each bucket
            return self.engine.run_eager(entry, max_supersteps,
                                         **query_arrays)
        out = getattr(self.engine, entry)(max_supersteps, **ov,
                                          **query_arrays)
        return out if entry == "run_batch" else [out]

    def warmup(self) -> "CompiledPlan":
        """Trace + compile now (first root of the graph) so the first real
        query pays dispatch cost only."""
        if self.query_params:
            dummy = {p: np.zeros((self.key.batch_size,), np.int32)
                     for p in self.query_params}
        elif self.key.batch_size == 1:
            dummy = {}
        else:
            raise ValueError(
                f"kernel {self.key.kernel!r} has no query_params; "
                "only batch_size=1 plans are meaningful")
        self.execute(**dummy)
        return self


@dataclasses.dataclass
class StepperPlan:
    """A cached (engine, slot width) LaneStepper ready for continuous
    driving. ``engine`` packages retired lanes (``lane_result``) and
    owns the trace counter the stepper's programs bump."""
    key: PlanKey
    engine: "Engine | ShardEngine"
    stepper: "LaneStepper | ShardLaneStepper"

    @property
    def query_params(self) -> Tuple[str, ...]:
        return tuple(self.engine.kernel.query_params)


class PlanCache:
    """Multi-level cache: partitioned graphs (via the GraphStore),
    device-resident engines, compiled plans, lane steppers.
    Thread-compatible (callers serialize dispatch; the server holds its
    scheduler lock across get_plan + execute). Store residency hooks
    fire synchronously — the affected version is pinned by any query
    still using it, so neither a spill (engine offload) nor a discard
    (full invalidation) ever races a live dispatch."""

    def __init__(self, stats: Optional[ServiceStats] = None,
                 store: Optional[GraphStore] = None, device=None):
        # every engine of the cache runs on this device (the card unless
        # the caller asks for the CPU)
        self.device = resolve_device(device)
        self.stats = stats or ServiceStats()
        self.store = store or GraphStore()
        self.store.add_evict_listener(self.invalidate_graph)
        self.store.add_spill_listener(self.offload_graph)
        self.store.add_refault_listener(self.promote_graph)
        # traces of engines already dropped by eviction (keeps the
        # monotonic plan_traces counter exact across invalidations)
        self._trace_floor = 0
        # serializes trace folding + invalidation: evictions can fire
        # from any thread that releases a lease (e.g. the scheduler
        # thread reaping an idle class) while another thread dispatches;
        # ordering is store lock -> this lock -> stats lock, never the
        # reverse, so it cannot deadlock with either
        self._sync_lock = threading.Lock()  # lock: plans_sync
        self._engines: Dict[Tuple[str, int, str, str, int, str, str],
                            Engine] = {}
        # bytes each engine reported to the store's budget (so a
        # discard can un-charge exactly what was charged)
        self._engine_nbytes: Dict[Tuple[str, int, str, str, int, str, str],
                                  int] = {}
        self._plans: Dict[PlanKey, CompiledPlan] = {}
        self._steppers: Dict[PlanKey, StepperPlan] = {}

    # ---------------- graphs ------------------------------------------
    def register_graph(self, graph_id: str, graph: Graph, *,
                       num_shards: int = 4, method: str = "greedy",
                       pad_multiple: int = 256) -> PartitionedGraph:
        """Publish ``graph`` to the store and pin its layout for reuse by
        every plan over it. Re-registering identical content is a no-op;
        different content is a version publish (or :class:`StoreError`
        when the store has versioning disabled)."""
        ver = self.store.publish(graph_id, graph, num_shards=num_shards,
                                 method=method, pad_multiple=pad_multiple)
        with self.store.acquire(graph_id, ver) as lease:
            return lease.pg

    def graph(self, graph_id: str, num_shards: int,
              method: str = "greedy",
              version: Optional[int] = None) -> PartitionedGraph:
        try:
            spec = self.store.partition_spec(graph_id, version)
        except KeyError:
            raise KeyError(
                f"graph {graph_id!r} not registered for {num_shards} "
                f"shards (method={method!r}); call register_graph first")
        if (spec["num_shards"], spec["method"]) != (num_shards, method):
            raise KeyError(
                f"graph {graph_id!r} not registered for {num_shards} "
                f"shards (method={method!r}); its published spec is "
                f"{spec['num_shards']} shards (method={spec['method']!r})")
        with self.store.acquire(graph_id, version) as lease:
            return lease.pg

    # ---------------- engines / plans ---------------------------------
    def resolve_key(self, key: PlanKey) -> PlanKey:
        """Pin ``version=0`` ("latest") to the store's current version so
        cache entries are always keyed by a concrete published version,
        and normalize ``overlap`` off for non-shard classes (the plain
        Engine has no exchange to pipeline)."""
        if key.overlap and not key.exchange:
            key = dataclasses.replace(key, overlap=False)
        if key.version:
            return key
        return dataclasses.replace(
            key, version=self.store.known_version(key.graph_id))

    def _engine_for(self, key: PlanKey,
                    method: str) -> "Engine | ShardEngine":
        # NOTE: ek deliberately omits key.overlap — both schedules of a
        # class share one engine (and its device-resident graph arrays)
        ek = (key.graph_id, key.version, key.kernel, key.mode,
              key.num_shards, key.backend, key.exchange)
        eng = self._engines.get(ek)
        if eng is None:
            if key.kernel not in ALGORITHMS:
                raise KeyError(f"unknown kernel {key.kernel!r}; have "
                               f"{sorted(ALGORITHMS)}")
            pg = self.graph(key.graph_id, key.num_shards, method,
                            version=key.version or None)
            if key.exchange:
                # all the class's shards on the cache's one device
                eng = ShardEngine(ALGORITHMS[key.kernel](), pg,
                                  mesh=LocalMesh(key.num_shards,
                                                 self.device),
                                  exchange=key.exchange,
                                  backend=key.backend)
            else:
                eng = Engine(ALGORITHMS[key.kernel](), pg, mode=key.mode,
                             backend=key.backend, device=self.device)
            self._engines[ek] = eng
            # charge the TRUE engine-tier device bytes against the
            # store's budget (replacing the partition-layout proxy): a
            # version serving two kernels holds two engines' arrays,
            # and the budget should see both
            nb = eng.device_nbytes
            self._engine_nbytes[ek] = nb
            self.store.note_engine_bytes(key.graph_id, key.version, nb)
        return eng

    def get_plan(self, key: PlanKey, *, method: str = "greedy",
                 warm: bool = False) -> CompiledPlan:
        """Fetch (hit) or build (miss) the plan for ``key``."""
        key = self.resolve_key(key)
        plan = self._plans.get(key)
        hit = plan is not None
        self.stats.record_cache(hit)
        if not hit:
            engine = self._engine_for(key, method)
            if key.batch_size > 1 and not engine.kernel.query_params:
                raise ValueError(
                    f"kernel {key.kernel!r} declares no query_params; "
                    "it cannot be query-batched (batch_size must be 1)")
            plan = CompiledPlan(key, engine)
            if warm:
                plan.warmup()
            self._plans[key] = plan
        return plan

    def get_stepper(self, key: PlanKey, *,
                    method: str = "greedy") -> StepperPlan:
        """Fetch or build the step-granular plan for ``key`` —
        ``key.batch_size`` is the continuous scheduler's slot width.
        Shares the graph/engine tiers with :meth:`get_plan`, so a class
        served both bucketed and continuously partitions and uploads
        once."""
        key = self.resolve_key(key)
        splan = self._steppers.get(key)
        hit = splan is not None
        self.stats.record_cache(hit)
        if not hit:
            engine = self._engine_for(key, method)
            if not engine.kernel.query_params:
                raise ValueError(
                    f"kernel {key.kernel!r} declares no query_params; "
                    "it cannot be continuously batched")
            if key.exchange:
                stepper = engine.make_stepper(key.batch_size,
                                              overlap=key.overlap)
            else:
                stepper = engine.make_stepper(key.batch_size)
            splan = StepperPlan(key, engine, stepper)
            self._steppers[key] = splan
        return splan

    def _engines_of(self, graph_id: str, version: int) -> "list[Engine]":
        with self._sync_lock:
            return [e for k, e in list(self._engines.items())
                    if k[0] == graph_id and k[1] == version]

    def offload_graph(self, graph_id: str, version: int) -> int:
        """Store spill hook: demote the version's engine device arrays
        to host copies. Plans/steppers stay cached — the spill contract
        is that a refault re-uploads and re-traces nothing. Returns the
        engine-tier bytes demoted."""
        return sum(e.offload() for e in self._engines_of(graph_id, version))

    def promote_graph(self, graph_id: str, version: int) -> float:
        """Store refault hook (fires on the faulting thread with the
        store lock released): re-upload the version's engine arrays so
        the first post-fault dispatch pays dispatch cost only. Returns
        the upload wall seconds (the store folds the whole promotion
        into ``refault_upload_ms``)."""
        return sum(e.upload() for e in self._engines_of(graph_id, version))

    def invalidate_graph(self, graph_id: str, version: int) -> None:
        """Drop every engine/plan/stepper compiled against one
        DISCARDED (graph_id, version) — other versions and tenants stay
        cached, and spilled-but-not-discarded versions keep their plans.
        Trace counts of dropped engines are folded into the stats first
        so ``plan_traces`` stays monotonic."""
        freed = 0
        with self._sync_lock:
            self._sync_traces_locked()
            for ek in [k for k in list(self._engines)
                       if k[0] == graph_id and k[1] == version]:
                eng = self._engines.pop(ek, None)
                if eng is not None:
                    self._trace_floor += eng.traces
                freed += self._engine_nbytes.pop(ek, 0)
        if freed:
            self.store.note_engine_bytes(graph_id, version, -freed)
        for pk in [k for k in list(self._plans)
                   if k.graph_id == graph_id and k.version == version]:
            self._plans.pop(pk, None)
        for sk in [k for k in list(self._steppers)
                   if k.graph_id == graph_id and k.version == version]:
            self._steppers.pop(sk, None)

    def sync_trace_counters(self) -> int:
        """Fold every engine's trace count into the shared stats; returns
        the current total. Call after dispatches to keep the stats
        endpoint's ``plan_traces`` exact. (``_trace_floor`` carries the
        traces of engines already dropped by eviction.)"""
        with self._sync_lock:
            return self._sync_traces_locked()

    def _sync_traces_locked(self) -> int:
        # list() snapshots the dict atomically, so a concurrent get_plan
        # inserting an engine cannot break the iteration
        total = self._trace_floor + sum(
            e.traces for e in list(self._engines.values()))
        delta = total - self.stats.plan_traces
        if delta:
            self.stats.record_traces(delta)
        return total

    # ---------------- introspection -----------------------------------
    def describe(self) -> Dict[str, Any]:
        return {
            "graphs": sorted(
                f"{e['graph_id']}@v{e['version']}"
                + ("" if e["resident"] else " (evicted)")
                for e in self.store.describe()),
            "engines": len(self._engines),
            "plans": [dataclasses.asdict(k) for k in self._plans],
            "steppers": [dataclasses.asdict(k) for k in self._steppers],
            "plan_traces": self.sync_trace_counters(),
            "store": self.store.snapshot(),
        }
