"""Multi-tenant GraphStore: a named, versioned, ref-counted registry of

The port's own copy of ``repro.store.registry`` (numpy only), over the
port's ``core/graph.py`` and ``core/partition.py``: the port imports
nothing of the JAX package.
device-resident partitioned graphs under an explicit memory budget, with
a host-spill residency tier underneath it.

The paper's §5 model treats per-board memory (``Platform.m_board``) as a
first-class constraint on which graphs a node can host; the serving
stack previously ignored it — every registered graph stayed
device-resident forever. This module manages graph residency the way
GraphScale manages on-accelerator graph storage and Swift decouples
residency from query execution:

  * ``publish(graph_id, graph)`` registers version N+1 of a tenant's
    graph. The host-side :class:`~repro_torch.core.graph.Graph` and the
    partition spec (including the computed ``part_of`` assignment) are
    kept forever — they are cheap; the compiled
    :class:`~repro_torch.core.partition.PartitionedGraph` layout is the
    expensive, budgeted resource.
  * ``acquire(graph_id)`` pins the latest (or an explicit) version and
    returns a :class:`GraphLease`. Acquiring a non-resident version
    transparently re-materializes it (a *fault*) — bit-identical to the
    original layout.
  * When ``resident_bytes`` exceeds ``budget_bytes`` the store evicts
    least-recently-used **unpinned** layouts; pinned layouts (queries in
    flight) are never evicted, so a burst larger than the budget
    overcommits rather than corrupts.

Residency is a three-tier state machine (README "Graph residency"):

  DEVICE ──evict──▶ SPILLED ──overflow/retire──▶ DISCARDED
     ▲                 │                            │
     └──── refault ────┘◀──────── cold fault ───────┘

  * **DEVICE**: the layout is resident and charged against
    ``budget_bytes`` (``m_board``).
  * **SPILLED**: eviction *demotes* the layout's arrays to pinned host
    copies instead of dropping them (the Swift/GraphScale move:
    on-accelerator storage is a cache over a larger host tier). A fault
    from this tier is a **device re-upload** — no partitioner re-run,
    and, because shapes/dtypes are unchanged, no engine re-trace: the
    plan cache keeps the version's compiled plans across spill/refault
    and only drops them on true discard. Spilled bytes are charged
    against a second-level ``spill_budget_bytes`` (None = unbounded
    host tier; 0 disables spilling — the pre-spill discard behavior);
    overflow discards the LRU spilled layout.
  * **DISCARDED**: only the host ``Graph`` + ``part_of`` survive; the
    next fault re-runs the partition compile and the plan cache
    re-builds engines/plans (the evict listeners fire here, not on
    spill).

Faults **materialize outside the store lock**: the faulting thread marks
the entry in-progress and builds with the registry unlocked, so one
tenant's multi-second cold fault no longer head-of-line-blocks every
other tenant's ``submit``/``acquire``. Double-faulting threads wait on
the *entry's* condition variable (not the registry) and share the single
materialization.

Superseded versions are retired (a true discard of both tiers plus the
host payloads) the moment their last pin drops — in-flight queries drain
on version N while new arrivals bind N+1.

Two further byte flows share the budgets:

  * **engine-tier accounting**: the plan cache reports every engine's
    TRUE device bytes (:meth:`note_engine_bytes`); while on record they
    replace the partition-layout proxy in the version's budget charge,
    so a graph serving three kernels is charged all three engines.
  * **parked lanes**: a preempted query's host-parked carry checkpoint
    is charged against ``spill_budget_bytes``
    (:meth:`reserve_parked`/:meth:`release_parked`) — the ParkedQueue
    is bounded by the same host tier the spilled layouts live in.

``evictions`` / ``spills`` / ``discards`` / ``faults`` /
``resident_bytes`` / ``spilled_bytes`` / ``refault_upload_ms`` /
``parked_bytes`` are surfaced in :meth:`GraphStore.snapshot` and folded
into the service's stats endpoint.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import Graph
from ..core.partition import PARTITIONERS, PartitionedGraph, partition_graph

__all__ = ["GraphStore", "GraphLease", "StoreError"]


class StoreError(RuntimeError):
    """Raised on invalid store operations (re-publishing with versioning
    disabled, acquiring a superseded version whose retirement is
    pending, non-positive partition specs, ...). Unknown graph ids and
    versions raise plain :class:`KeyError`."""


def _graphs_equal(a: Graph, b: Graph) -> bool:
    if a is b:
        return True
    if (a.num_vertices != b.num_vertices
            or a.num_edges != b.num_edges):
        return False
    if not (np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)):
        return False
    if (a.weights is None) != (b.weights is None):
        return False
    return a.weights is None or np.array_equal(a.weights, b.weights)


@dataclasses.dataclass
class _Version:
    """One published (graph_id, version): host graph + partition spec
    always; the compiled layout in the device tier (``pg``), the host
    tier (``spilled``), or neither (discarded)."""
    graph_id: str
    version: int
    graph: Graph
    num_shards: int
    method: str
    pad_multiple: int
    pg: Optional[PartitionedGraph] = None       # None = not device-resident
    spilled: Optional[PartitionedGraph] = None  # host-spill copy
    part_of: Optional[np.ndarray] = None    # pinned partition assignment
    nbytes: int = 0                         # charged cost (either tier)
    layout_nbytes: int = 0                  # partition-layout proxy bytes
    engine_bytes: int = 0                   # TRUE engine-tier device bytes
    pins: int = 0
    last_used: int = 0                      # LRU clock value
    superseded: bool = False
    ever_resident: bool = False
    building: bool = False                  # a fault is materializing
    cond: Optional[threading.Condition] = None  # entry-scoped waiters

    @property
    def resident(self) -> bool:
        return self.pg is not None

    @property
    def in_spill(self) -> bool:
        return self.spilled is not None

    def spec(self) -> Tuple[int, str, int]:
        return (self.num_shards, self.method, self.pad_multiple)


class GraphLease:
    """A pin on one resident (graph_id, version). Release it (or use it
    as a context manager) when the query that needed the graph retires;
    unpinned layouts become evictable."""

    def __init__(self, store: "GraphStore", graph_id: str, version: int,
                 pg: PartitionedGraph):
        self._store = store
        self.graph_id = graph_id
        self.version = version
        self.pg = pg
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store.release(self.graph_id, self.version)

    def __enter__(self) -> "GraphLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class GraphStore:
    """Versioned, memory-budgeted registry of partitioned graphs.

    ``budget_bytes=None`` means unbounded (the pre-store behavior);
    passing a :class:`~repro_torch.core.perfmodel.Platform` derives the budget
    from its ``m_board``. ``spill_budget_bytes`` caps the host-spill
    tier (None = unbounded host tier, 0 = spilling disabled — evictions
    discard as before). Thread-safe: metadata operations serialize on
    one lock, but fault **materialization runs with the lock released**
    (per-entry in-progress flag + condition variable), so a slow fault
    never blocks other entries' operations.
    """

    def __init__(self, *, budget_bytes: Optional[float] = None,
                 platform=None, versioned: bool = True,
                 num_shards: int = 4, method: str = "greedy",
                 pad_multiple: int = 256,
                 spill_budget_bytes: Optional[float] = None):
        if budget_bytes is None and platform is not None:
            budget_bytes = float(platform.m_board)
        self.budget_bytes: Optional[float] = (
            float(budget_bytes) if budget_bytes is not None else None)
        self.spill_budget_bytes: Optional[float] = (
            float(spill_budget_bytes) if spill_budget_bytes is not None
            else None)
        self.versioned = versioned
        self.defaults = dict(num_shards=num_shards, method=method,
                             pad_multiple=pad_multiple)
        self._lock = threading.RLock()  # lock: store
        self._versions: Dict[Tuple[str, int], _Version] = {}
        self._latest: Dict[str, int] = {}
        self._clock = 0
        self._evict_listeners: List[Callable[[str, int], None]] = []
        self._spill_listeners: List[Callable[[str, int], None]] = []
        self._refault_listeners: List[Callable[[str, int], None]] = []
        # spills recorded under the lock, fired after it is released
        self._pending_spills: List[Tuple[str, int]] = []
        # counters
        self.publishes = 0
        self.evictions = 0
        self.spills = 0
        self.discards = 0
        self.faults = 0
        self.budget_overcommits = 0
        self.refault_upload_ms = 0.0    # wall spent promoting spilled
        # host bytes of preempted lanes' parked carries (the continuous
        # scheduler's ParkedQueue charges them here against the spill
        # budget — a parked checkpoint is host-resident state exactly
        # like a spilled layout)
        self.parked_bytes = 0
        self.lane_parks = 0             # reservations granted
        # optional duck-typed lifecycle event bus (service.trace.TraceBus)
        self._trace = None

    def set_trace(self, bus) -> None:
        """Attach a lifecycle event bus (anything with ``emit(kind,
        **fields)``); residency transitions (publish / spill / refault /
        evict) then land on the same timeline as the service's query
        events. The bus append is a leaf lock, so emitting under the
        store lock is ordering-safe."""
        self._trace = bus

    def _emit(self, kind: str, **fields) -> None:
        if self._trace is not None:
            self._trace.emit(kind, **fields)

    @property
    def _spill_enabled(self) -> bool:
        return self.spill_budget_bytes is None or self.spill_budget_bytes > 0

    # ---------------- registration ------------------------------------
    def publish(self, graph_id: str, graph: Graph, *,
                num_shards: Optional[int] = None,
                method: Optional[str] = None,
                pad_multiple: Optional[int] = None,
                materialize: bool = True) -> int:
        """Register ``graph`` as the next version of ``graph_id``.

        First publish creates version 1. Re-publishing identical content
        under the same partition spec is an idempotent no-op (returns
        the current version). Different content bumps the version when
        the store is ``versioned``; with versioning disabled it raises
        :class:`StoreError` instead of silently overwriting a graph that
        in-flight queries may still be traversing.
        """
        # explicit zeros must not silently fall back to the defaults —
        # a 0-shard "request" is a caller bug, not a request for 4
        if num_shards is None:
            num_shards = self.defaults["num_shards"]
        if method is None:
            method = self.defaults["method"]
        if pad_multiple is None:
            pad_multiple = self.defaults["pad_multiple"]
        if num_shards <= 0:
            raise StoreError(
                f"num_shards must be positive, got {num_shards!r} "
                f"(omit it or pass None for the store default "
                f"{self.defaults['num_shards']})")
        if pad_multiple <= 0:
            raise StoreError(
                f"pad_multiple must be positive, got {pad_multiple!r} "
                f"(omit it or pass None for the store default "
                f"{self.defaults['pad_multiple']})")
        if method not in PARTITIONERS:
            raise StoreError(
                f"unknown partition method {method!r}; have "
                f"{sorted(PARTITIONERS)}")
        with self._lock:
            cur = self._latest.get(graph_id)
            head = None
            if cur is not None:
                head = self._versions[(graph_id, cur)]
                same_spec = head.spec() == (num_shards, method, pad_multiple)
                if same_spec and _graphs_equal(head.graph, graph):
                    return cur          # idempotent re-register
                if not self.versioned:
                    raise StoreError(
                        f"graph {graph_id!r} already published and "
                        "versioning is disabled; re-publishing different "
                        "content would silently invalidate in-flight "
                        "queries (construct the store with versioned=True "
                        "to swap versions atomically)")
                head.superseded = True
            ver = (cur or 0) + 1
            entry = _Version(graph_id=graph_id, version=ver, graph=graph,
                             num_shards=num_shards, method=method,
                             pad_multiple=pad_multiple,
                             cond=threading.Condition(self._lock))  # lock: store
            self._versions[(graph_id, ver)] = entry
            self._latest[graph_id] = ver
            self.publishes += 1
            # retire a drained (unpinned) predecessor AFTER the new head
            # is registered, so evict listeners observe the new latest
            # (stale plans and cached results are scoped to `cur`)
            if head is not None and head.pins == 0:
                self._retire_superseded_locked(head)
        self._emit("publish", graph_id=graph_id, version=ver,
                   num_vertices=int(graph.num_vertices),
                   num_edges=int(graph.num_edges))
        if materialize:
            # outside the lock: a large publish compiles its layout
            # without stalling other tenants (same protocol as a fault)
            self._ensure_resident(graph_id, ver, fault=False, pin=False)
        return ver

    def remove(self, graph_id: str) -> None:
        """Drop every version of ``graph_id`` (refuses while pinned)."""
        with self._lock:
            keys = [k for k in self._versions if k[0] == graph_id]
            if not keys:
                raise KeyError(f"graph {graph_id!r} not in store")
            for k in keys:
                if self._versions[k].pins > 0:
                    raise StoreError(
                        f"graph {graph_id!r} v{k[1]} is pinned by "
                        f"{self._versions[k].pins} in-flight queries")
            for k in keys:
                entry = self._versions.pop(k)
                if entry.resident:
                    self._evict_locked(entry, count=False, spill=False)
                elif entry.in_spill:
                    self._discard_locked(entry, count=False)
                if entry.building:
                    # an in-flight fault installs into an orphaned entry;
                    # wake its waiters so they re-resolve (and KeyError)
                    entry.cond.notify_all()
            del self._latest[graph_id]

    # ---------------- lookup / pinning --------------------------------
    def latest_version(self, graph_id: str) -> int:
        with self._lock:
            ver = self._latest.get(graph_id)
            if ver is None:
                raise KeyError(f"graph {graph_id!r} not in store")
            return ver

    def known_version(self, graph_id: str) -> int:
        """Like :meth:`latest_version` but 0 for unknown ids (lets
        callers defer the missing-graph error to dispatch time)."""
        with self._lock:
            return self._latest.get(graph_id, 0)

    def graph_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._latest)

    def _entry(self, graph_id: str, version: Optional[int]) -> _Version:
        ver = version or self._latest.get(graph_id)
        if ver is None:
            raise KeyError(f"graph {graph_id!r} not in store")
        entry = self._versions.get((graph_id, ver))
        if entry is None:
            raise KeyError(f"graph {graph_id!r} has no version {ver}")
        return entry

    def acquire(self, graph_id: str, version: Optional[int] = None
                ) -> GraphLease:
        """Pin (graph_id, version) — latest when ``version`` is None —
        re-materializing it first if it is not device-resident (a
        *fault*: re-upload from the host-spill tier, or re-partition
        from the retained assignment). The pin blocks eviction until
        released. Materialization happens with the store lock released;
        a concurrent fault of the same entry waits on the entry, not the
        registry. Acquiring a superseded version whose retirement is
        pending (no longer resident) raises :class:`StoreError` — only
        the latest version can be (re-)materialized."""
        lease = self._ensure_resident(graph_id, version, fault=True,
                                      pin=True)
        assert lease is not None
        return lease

    def release(self, graph_id: str, version: int) -> None:
        try:
            with self._lock:
                entry = self._versions.get((graph_id, version))
                if entry is None:
                    return  # removed while leased — nothing left to unpin
                entry.pins = max(0, entry.pins - 1)
                # superseded versions exist only for their in-flight
                # drain: last pin out turns off the lights (device
                # arrays + plans + host payloads — no new arrival can
                # ever bind them again)
                if entry.pins == 0 and entry.superseded:
                    self._retire_superseded_locked(entry)
                else:
                    self._evict_to_budget_locked()
        finally:
            self._fire_pending_spills()

    def peek(self, graph_id: str, version: Optional[int] = None
             ) -> PartitionedGraph:
        """The device-resident layout, without pinning. Raises
        :class:`StoreError` if the version is spilled or discarded —
        callers on the query path must hold a lease instead."""
        with self._lock:
            entry = self._entry(graph_id, version)
            if not entry.resident:
                raise StoreError(
                    f"graph {graph_id!r} v{entry.version} is "
                    f"{'spilled' if entry.in_spill else 'evicted'}; "
                    "acquire() a lease to fault it back in")
            self._touch_locked(entry)
            return entry.pg

    def host_graph(self, graph_id: str,
                   version: Optional[int] = None) -> Graph:
        with self._lock:
            entry = self._entry(graph_id, version)
            if entry.graph is None:
                raise StoreError(
                    f"graph {graph_id!r} v{entry.version} was superseded "
                    "and has drained; its host graph is released")
            return entry.graph

    def partition_spec(self, graph_id: str,
                       version: Optional[int] = None) -> Dict[str, object]:
        with self._lock:
            e = self._entry(graph_id, version)
            return dict(num_shards=e.num_shards, method=e.method,
                        pad_multiple=e.pad_multiple)

    # ---------------- eviction ----------------------------------------
    def add_evict_listener(self, fn: Callable[[str, int], None]) -> None:
        """``fn(graph_id, version)`` fires (under the store lock) when a
        layout is **discarded** — dropped from both residency tiers
        (spill overflow, version retirement, remove). The plan cache
        uses this to drop the engines/plans compiled against the
        version. Budget evictions that *spill* do NOT fire it — spilled
        versions keep their compiled plans (see
        :meth:`add_spill_listener`)."""
        self._evict_listeners.append(fn)

    def add_spill_listener(self, fn: Callable[[str, int], None]) -> None:
        """``fn(graph_id, version)`` fires — with the store lock
        RELEASED, on the thread whose operation triggered the eviction —
        when a layout is demoted device → host. The plan cache uses
        this to offload the version's engine device arrays while
        keeping the compiled plans. The transfer runs unlocked (a big
        layout's device→host copy must not stall the registry, budget
        sweeps run on the fault path too); the store re-checks under
        the lock that the entry is still spilled and not mid-refault
        before firing, so an offload cannot clobber a concurrent
        fault's re-upload."""
        self._spill_listeners.append(fn)

    def add_refault_listener(self, fn: Callable[[str, int], None]) -> None:
        """``fn(graph_id, version)`` fires — with the store lock
        RELEASED, on the faulting thread — when a fault promotes a
        layout back to device residency. The plan cache re-uploads the
        version's engine arrays here; the wall time of the whole
        promotion (listeners included) accumulates in
        ``refault_upload_ms``."""
        self._refault_listeners.append(fn)

    def evict(self, graph_id: str, version: Optional[int] = None, *,
              spill: Optional[bool] = None) -> bool:
        """Explicitly evict one version's layout (``spill=None`` follows
        the store's spill policy; ``spill=False`` forces a discard).
        Returns False (and leaves it resident) if the version is
        pinned."""
        try:
            with self._lock:
                entry = self._entry(graph_id, version)
                if entry.building:
                    # a fault is materializing from this entry's layout
                    # right now — discarding under it would drop the
                    # version's plans mid-refault (same guard as the
                    # spill-budget sweep)
                    return False
                if not entry.resident:
                    if spill is False and entry.in_spill:
                        self._discard_locked(entry)
                    return True
                if entry.pins > 0:
                    return False
                self._evict_locked(entry, spill=spill)
                return True
        finally:
            self._fire_pending_spills()

    # ---------------- engine-tier byte accounting ----------------------
    def note_engine_bytes(self, graph_id: str, version: int,
                          delta: int) -> None:
        """Fold true engine-tier device bytes into the version's budget
        charge. The plan cache reports ``+engine.device_nbytes`` when it
        builds an engine against this version and the negative sum when
        a discard drops them; while any engine bytes are on record they
        replace the partition-layout proxy estimate (a version serving
        several kernels/modes charges every engine's arrays). Unknown
        (graph_id, version) pairs are ignored — the engine outlived the
        version's removal."""
        fire = False
        try:
            with self._lock:
                entry = self._versions.get((graph_id, version))
                if entry is None:
                    return
                entry.engine_bytes = max(0, entry.engine_bytes
                                         + int(delta))
                entry.nbytes = entry.engine_bytes or entry.layout_nbytes
                if delta > 0:
                    # a bigger charge may push the registry over budget
                    fire = True
                    self._evict_to_budget_locked()
        finally:
            if fire:
                self._fire_pending_spills()

    # ---------------- parked-lane (preemption) accounting --------------
    def reserve_parked(self, nbytes: int) -> bool:
        """Charge ``nbytes`` of a preempted lane's host-parked carry
        checkpoint against the **spill budget** (parked carries are
        host-resident state exactly like spilled layouts). Makes room by
        discarding LRU spilled layouts first; returns ``False`` — the
        scheduler then skips the preemption — when the budget cannot fit
        the checkpoint. ``spill_budget_bytes=0`` (host tier disabled)
        refuses every park; ``None`` (unbounded) accepts every park."""
        nbytes = int(nbytes)
        with self._lock:
            if self.spill_budget_bytes is not None:
                if self.spill_budget_bytes <= 0:
                    return False
                if self.parked_bytes + nbytes > self.spill_budget_bytes:
                    # can never fit even with every spilled layout
                    # discarded — refuse BEFORE the sweep, or an
                    # infeasible park would destroy the host tier
                    # (cold faults + re-traces) for nothing
                    return False
                # tentatively charge and let the ONE shared host-tier
                # sweep make room (it discards LRU spilled layouts and
                # honors the in-flight-refault guard); refuse if the
                # checkpoint still does not fit once victims run out
                self.parked_bytes += nbytes
                self._spill_to_budget_locked()
                total = self.parked_bytes + sum(
                    e.nbytes for e in self._versions.values()
                    if e.in_spill and not e.building)
                if total > self.spill_budget_bytes:
                    self.parked_bytes -= nbytes
                    return False
            else:
                self.parked_bytes += nbytes
            self.lane_parks += 1
            return True

    def release_parked(self, nbytes: int) -> None:
        """Un-charge a parked carry (its lane was restored, retired, or
        failed)."""
        with self._lock:
            self.parked_bytes = max(0, self.parked_bytes - int(nbytes))

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._versions.values()
                       if e.resident)

    @property
    def spilled_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._versions.values()
                       if e.in_spill)

    # snapshot() keys that are MONOTONE event counts (Prometheus
    # counters); everything else in the snapshot is a point-in-time
    # level (gauge). The metrics registry classifies the feed with this.
    METRIC_COUNTER_KEYS = frozenset({
        "publishes", "evictions", "spills", "discards", "faults",
        "budget_overcommits", "lane_parks",
    })

    def metrics_feed(self) -> "tuple[Dict[str, float], Dict[str, float]]":
        """``(counters, gauges)`` split of :meth:`snapshot` for the
        metrics registry (``refault_upload_ms`` is cumulative wall and
        counts as a counter too)."""
        snap = self.snapshot()
        counter_keys = self.METRIC_COUNTER_KEYS | {"refault_upload_ms"}
        counters = {k: float(snap[k]) for k in counter_keys}
        gauges = {k: float(v) for k, v in snap.items()
                  if k not in counter_keys}
        return counters, gauges

    def snapshot(self) -> Dict[str, float]:
        """Store counters for the service stats endpoint."""
        with self._lock:
            resident = [e for e in self._versions.values() if e.resident]
            spilled = [e for e in self._versions.values() if e.in_spill]
            return {
                "graphs": len(self._latest),
                "versions": len(self._versions),
                "resident_graphs": len(resident),
                "resident_bytes": float(sum(e.nbytes for e in resident)),
                "spilled_graphs": len(spilled),
                "spilled_bytes": float(sum(e.nbytes for e in spilled)),
                "pinned_graphs": sum(1 for e in resident if e.pins > 0),
                "budget_bytes": (float(self.budget_bytes)
                                 if self.budget_bytes is not None else -1.0),
                "spill_budget_bytes": (
                    float(self.spill_budget_bytes)
                    if self.spill_budget_bytes is not None else -1.0),
                "publishes": self.publishes,
                "evictions": self.evictions,
                "spills": self.spills,
                "discards": self.discards,
                "faults": self.faults,
                "budget_overcommits": self.budget_overcommits,
                "refault_upload_ms": float(self.refault_upload_ms),
                "parked_bytes": float(self.parked_bytes),
                "lane_parks": self.lane_parks,
            }

    def describe(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{
                "graph_id": e.graph_id, "version": e.version,
                "resident": e.resident, "spilled": e.in_spill,
                "pins": e.pins,
                "superseded": e.superseded, "nbytes": e.nbytes,
                "num_shards": e.num_shards, "method": e.method,
            } for e in self._versions.values()]

    # ---------------- materialization (out of lock) --------------------
    def _fire_pending_spills(self) -> None:
        """Fire spill listeners recorded by a budget sweep, with the
        registry lock released — the plan cache's offload is a
        device→host transfer that must not stall other tenants. Each
        entry is re-checked under the lock first: one that was refaulted
        (or started refaulting) since its sweep is skipped, so a late
        offload can never clobber an in-flight promotion."""
        while True:
            with self._lock:
                if not self._pending_spills:
                    return
                graph_id, version = self._pending_spills.pop(0)
                entry = self._versions.get((graph_id, version))
                if entry is None or not entry.in_spill or entry.building:
                    continue
            for fn in self._spill_listeners:
                fn(graph_id, version)

    def _ensure_resident(self, graph_id: str, version: Optional[int], *,
                         fault: bool, pin: bool) -> Optional[GraphLease]:
        try:
            return self._ensure_resident_inner(graph_id, version,
                                               fault=fault, pin=pin)
        finally:
            # budget sweeps inside (fast path and install block) may
            # have queued spills; offload them with the lock released
            self._fire_pending_spills()

    def _ensure_resident_inner(self, graph_id: str, version: Optional[int],
                               *, fault: bool, pin: bool
                               ) -> Optional[GraphLease]:
        """Make (graph_id, version) device-resident, materializing with
        the store lock **released**; returns a lease when ``pin``.

        The in-progress protocol: the first thread to find the entry
        non-resident claims ``entry.building`` and builds unlocked;
        concurrent faulters of the SAME entry wait on the entry's
        condition variable (which releases the registry lock, so every
        other entry's store operations proceed meanwhile) and share the
        one materialization. ``pin=False`` callers (publish) skip
        quietly when the entry was superseded or removed underneath
        them."""
        with self._lock:
            while True:
                try:
                    entry = self._entry(graph_id, version)
                except KeyError:
                    if pin:
                        raise
                    return None
                if entry.graph is None:     # retired tombstone
                    if pin:
                        raise StoreError(
                            f"graph {graph_id!r} v{entry.version} was "
                            "superseded and has drained; only the latest "
                            "version can be acquired")
                    return None
                if entry.resident:
                    if not pin:
                        return None
                    entry.pins += 1
                    self._touch_locked(entry)
                    self._evict_to_budget_locked()
                    return GraphLease(self, entry.graph_id, entry.version,
                                      entry.pg)
                if entry.superseded:
                    # not resident + retirement pending: re-materializing
                    # it would hand new work a version that can never be
                    # latest again (the "only the latest version can be
                    # acquired" contract, enforced before the drain
                    # completes, not just after)
                    if pin:
                        raise StoreError(
                            f"graph {graph_id!r} v{entry.version} is "
                            "superseded and no longer resident; its "
                            "retirement is pending the in-flight drain — "
                            "acquire the latest version instead")
                    return None
                if not entry.building:
                    entry.building = True
                    break
                entry.cond.wait()   # entry-scoped; registry lock released
            # snapshot everything the unlocked build needs
            graph = entry.graph
            num_shards, method, pad_multiple = entry.spec()
            part_of = entry.part_of
            spilled = entry.spilled
            was_resident = entry.ever_resident

        # ---- build with the registry unlocked -------------------------
        t0 = time.perf_counter()
        pg = None
        err: Optional[BaseException] = None
        try:
            if spilled is not None:
                # host-tier hit: the layout arrays survive verbatim; the
                # expensive part is the engines' device re-upload, which
                # the refault listeners perform below
                pg = spilled
            else:
                # cold fault / first materialization: reuse the pinned
                # part_of assignment, so a faulted-back layout is
                # array-for-array identical to the original
                # (partitioners are deterministic anyway; this also
                # skips their O(V)/O(E) host work on the fault path)
                pg = partition_graph(graph, num_shards, method=method,
                                     pad_multiple=pad_multiple,
                                     part_of=part_of)
            if fault and was_resident:
                for fn in self._refault_listeners:
                    fn(graph_id, entry.version)
        except BaseException as exc:    # noqa: BLE001 — report to waiters
            err = exc
        wall_ms = (time.perf_counter() - t0) * 1e3

        with self._lock:
            entry.building = False
            entry.cond.notify_all()     # waiters re-check residency
            if err is not None:
                raise err
            if (self._versions.get((graph_id, entry.version)) is not entry
                    or entry.graph is None):
                # removed — or superseded AND retired (a publish landed
                # while we built and the entry had no pins) — during the
                # unlocked build. Installing pg would resurrect the
                # tombstone and hand out a lease on a version that can
                # never be latest again; drop the build instead.
                if pin:
                    raise StoreError(
                        f"graph {graph_id!r} v{entry.version} was removed "
                        "or superseded while its fault was materializing; "
                        "acquire the latest version instead")
                return None
            entry.pg = pg
            entry.spilled = None
            if entry.part_of is None:
                entry.part_of = pg.part_of
            # charge: true engine-tier bytes once any engine reported
            # them (note_engine_bytes), the layout proxy until then
            entry.layout_nbytes = pg.device_nbytes
            entry.nbytes = entry.engine_bytes or entry.layout_nbytes
            # a fresh layout is by definition the most recently used —
            # without this touch its last_used of 0 would make it the LRU
            # victim of the very budget sweep its own fault triggers
            self._touch_locked(entry)
            if fault and entry.ever_resident:
                self.faults += 1
                if spilled is not None:
                    self.refault_upload_ms += wall_ms
                self._emit("refault", graph_id=graph_id,
                           version=entry.version, dur_s=wall_ms / 1e3,
                           cold=spilled is None)
            entry.ever_resident = True
            lease = None
            if pin:
                entry.pins += 1
                lease = GraphLease(self, entry.graph_id, entry.version,
                                   entry.pg)
            self._evict_to_budget_locked()
            return lease

    # ---------------- internals (lock held) ----------------------------
    def _touch_locked(self, entry: _Version) -> None:
        self._clock += 1
        entry.last_used = self._clock

    def _evict_locked(self, entry: _Version, *, count: bool = True,
                      spill: Optional[bool] = None) -> None:
        """Drop device residency: demote to the host-spill tier when
        enabled (superseded versions skip it — they are retiring), else
        discard."""
        if spill is None:
            spill = self._spill_enabled and not entry.superseded
        pg = entry.pg
        entry.pg = None
        if count:
            self.evictions += 1
        if spill and pg is not None:
            entry.spilled = pg
            self.spills += 1
            self._emit("spill", graph_id=entry.graph_id,
                       version=entry.version, nbytes=entry.nbytes)
            # listeners fire AFTER the lock is released (the offload is
            # a device->host transfer; see _fire_pending_spills)
            self._pending_spills.append((entry.graph_id, entry.version))
            self._spill_to_budget_locked()
        else:
            self._discard_locked(entry, count=count)

    def _discard_locked(self, entry: _Version, *, count: bool = True) -> None:
        """Drop the host-spill copy too; the version's compiled plans go
        with it (evict listeners)."""
        entry.spilled = None
        if count:
            self.discards += 1
        self._emit("evict", graph_id=entry.graph_id,
                   version=entry.version)
        # evict listeners intentionally fire under the store lock: they
        # only invalidate plan/result caches keyed by (graph, version)
        # and must observe the same atomic snapshot as the discard
        # itself (registering docs require lock-aware, non-blocking fns)
        for fn in self._evict_listeners:
            fn(entry.graph_id, entry.version)  # analysis: allow(LCK004)

    def _retire_superseded_locked(self, entry: _Version) -> None:
        """A drained superseded version: discard its layout (both tiers)
        AND drop the host-side Graph / partition assignment. A
        long-running service that republishes a tenant's graph for
        months must not retain every predecessor's E-sized edge arrays;
        the metadata tombstone stays for describe()/snapshot()
        introspection."""
        if entry.resident:
            self._evict_locked(entry, spill=False)
        elif entry.in_spill:
            self._discard_locked(entry)
        entry.graph = None
        entry.part_of = None

    def _evict_to_budget_locked(self) -> None:
        if self.budget_bytes is None:
            return
        while True:
            resident = [e for e in self._versions.values() if e.resident]
            total = sum(e.nbytes for e in resident)
            if total <= self.budget_bytes:
                return
            victims = [e for e in resident if e.pins == 0]
            if not victims:
                # everything over budget is serving in-flight queries —
                # overcommit rather than corrupt; the next release
                # re-runs this sweep
                self.budget_overcommits += 1
                return
            self._evict_locked(min(victims, key=lambda e: e.last_used))

    def _spill_to_budget_locked(self) -> None:
        if self.spill_budget_bytes is None:
            return
        while True:
            spilled = [e for e in self._versions.values()
                       if e.in_spill and not e.building]
            # parked lane carries share the host tier's budget
            if (sum(e.nbytes for e in spilled) + self.parked_bytes
                    <= self.spill_budget_bytes or not spilled):
                return
            # host-tier overflow degrades to the pre-spill behavior:
            # discard the LRU spilled layout (its next fault is cold)
            self._discard_locked(min(spilled, key=lambda e: e.last_used))
