"""Query-lifecycle tracing: a bounded event bus + span assembly +

The port's own copy of ``repro.service.trace`` (numpy only): the port
imports nothing of the JAX package.
Chrome-trace export.

The stats endpoint (stats.py) answers "how fast is the service"; this
module answers "where did THIS query's latency go". Every layer that
owns a lifecycle phase emits a typed :class:`TraceEvent` into one
shared, thread-safe, bounded :class:`TraceBus`:

  ==========  =======================================================
  kind        emitted by / meaning
  ==========  =======================================================
  submit      server — request entered the service (deadline attached)
  queue       server/scheduler — request entered a scheduler queue
  admit       scheduler — request took a lane / joined a dispatched
              batch (``reason``: fresh | preempt | batch)
  superstep   LaneTable (core/stepper.py) — one fused device dispatch,
              with wall time and the lane→query attribution map
  park        scheduler — an active lane was checkpointed to host
              (``by``: the preempting request's qid)
  restore     scheduler — a parked lane was spliced back in
  retire      scheduler/server — the query resolved (``supersteps``,
              ``messages``, ``deadline_slack_s``; ``reason``:
              retired | cache | error)
  shed        server — admission refused it (``reason``:
              quota | deadline)
  publish     store — a graph version was registered
  spill       store — a layout was demoted device → host
  refault     store — a fault promoted a layout back to device
              (``cold``: the host copy was gone too)
  evict       store — a layout was discarded from both tiers
  alert       watchdog (metrics.py) — an SLO/model rule transitioned
              (``rule``, ``state``: firing | resolved, ``value``,
              ``threshold``; ``klass`` carries the subject)
  ==========  =======================================================

The bus is a ring buffer: a long-running service keeps the most recent
``capacity`` events and counts what it dropped — tracing never grows
without bound and never blocks a hot path (one leaf-lock append per
event; a disabled bus costs one attribute read).

On top of the raw events, :func:`assemble_spans` folds each query's
events into a :class:`QuerySpan` — its queued interval, active
interval(s), parked interval(s), and outcome — and
:func:`chrome_trace` renders spans + superstep dispatches + store
residency transitions as Chrome trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev load it directly;
``GraphQueryService.dump_trace(path)`` is the one-call export).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TraceEvent", "TraceBus", "QuerySpan", "EVENT_KINDS",
           "assemble_spans", "chrome_trace"]

EVENT_KINDS = frozenset({
    "submit", "queue", "admit", "superstep", "park", "restore", "retire",
    "shed", "publish", "spill", "refault", "evict", "alert",
})


@dataclasses.dataclass
class TraceEvent:
    """One lifecycle event. ``ts`` is ``time.perf_counter()`` seconds
    (the same clock every deadline and latency in the service uses);
    ``dur_s`` is nonzero only for events that cover an interval
    (superstep dispatches). ``qid``/``tenant``/``klass`` attribute the
    event to a query / tenant / query class; store events leave them
    None and carry ``graph_id``/``version`` in ``attrs``."""

    kind: str
    ts: float
    qid: Optional[int] = None
    tenant: Optional[str] = None
    klass: Optional[str] = None
    dur_s: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class TraceBus:
    """Thread-safe bounded ring buffer of :class:`TraceEvent`.

    ``emit`` is the only hot-path entry point and is deliberately
    minimal: one enabled-flag read when tracing is off, one leaf-lock
    deque append when it is on. The lock is never held while calling
    out, so the bus can be emitted into from under any scheduler/store
    lock without ordering constraints."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        assert capacity >= 1
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()  # lock: trace
        self._events: "collections.deque[TraceEvent]" = collections.deque(
            maxlen=capacity)
        self.emitted = 0        # total ever emitted (ring may have dropped)

    # ------------------------------------------------------------------
    def emit(self, kind: str, *, qid: Optional[int] = None,
             tenant: Optional[str] = None, klass: Optional[str] = None,
             dur_s: float = 0.0, ts: Optional[float] = None,
             **attrs) -> None:
        if not self.enabled:
            return
        assert kind in EVENT_KINDS, f"unknown trace event kind {kind!r}"
        ev = TraceEvent(kind=kind,
                        ts=time.perf_counter() if ts is None else ts,
                        qid=qid, tenant=tenant, klass=klass,
                        dur_s=dur_s, attrs=attrs)
        with self._lock:
            self._events.append(ev)
            self.emitted += 1

    @property
    def dropped(self) -> int:
        """Events the ring buffer has overwritten."""
        with self._lock:
            return self.emitted - len(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self) -> List[TraceEvent]:
        """Copy of the retained events in emission order."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.emitted = 0

    # ------------------------------------------------------------------
    def spans(self) -> Dict[int, "QuerySpan"]:
        return assemble_spans(self.snapshot())

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.snapshot())

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (load it in
        ``chrome://tracing`` or https://ui.perfetto.dev); returns the
        path."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path


# ---------------------------------------------------------------------------
# span assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuerySpan:
    """One query's lifecycle, reconstructed from its events.

    Interval ends are ``None`` while the phase is still open at
    snapshot time (a query mid-flight has an open ``active`` interval).
    ``outcome`` is None (in flight), ``"retired"``, ``"cache_hit"``,
    ``"shed"``, or ``"error"``."""

    qid: int
    tenant: Optional[str] = None
    klass: Optional[str] = None
    submitted_s: Optional[float] = None
    queued: Optional[Tuple[float, Optional[float]]] = None
    active: List[Tuple[float, Optional[float]]] = \
        dataclasses.field(default_factory=list)
    parked: List[Tuple[float, Optional[float]]] = \
        dataclasses.field(default_factory=list)
    retired_s: Optional[float] = None
    outcome: Optional[str] = None
    supersteps: Optional[int] = None
    messages: Optional[int] = None
    deadline_slack_s: Optional[float] = None
    parks: int = 0

    # -- conveniences for tests / dashboards ---------------------------
    def queued_s(self) -> float:
        if self.queued is None or self.queued[1] is None:
            return 0.0
        return self.queued[1] - self.queued[0]

    def active_s(self) -> float:
        return sum(b - a for a, b in self.active if b is not None)

    def parked_s(self) -> float:
        return sum(b - a for a, b in self.parked if b is not None)


def _close(intervals: List[Tuple[float, Optional[float]]],
           ts: float) -> None:
    if intervals and intervals[-1][1] is None:
        intervals[-1] = (intervals[-1][0], ts)


def assemble_spans(events: List[TraceEvent]) -> Dict[int, QuerySpan]:
    """Fold per-query events into :class:`QuerySpan`\\ s.

    Robust to ring-buffer truncation: an event for a qid whose
    ``submit`` was overwritten still opens a span (phases before the
    first retained event are simply absent). Events are processed in
    timestamp order."""
    spans: Dict[int, QuerySpan] = {}
    for ev in sorted((e for e in events if e.qid is not None),
                     key=lambda e: e.ts):
        sp = spans.get(ev.qid)
        if sp is None:
            sp = spans[ev.qid] = QuerySpan(qid=ev.qid)
        if ev.tenant is not None:
            sp.tenant = ev.tenant
        if ev.klass is not None:
            sp.klass = ev.klass
        if ev.kind == "submit":
            sp.submitted_s = ev.ts
            if sp.queued is None:
                sp.queued = (ev.ts, None)
        elif ev.kind == "queue":
            if sp.queued is None:
                sp.queued = (ev.ts, None)
        elif ev.kind == "admit":
            if sp.queued is not None and sp.queued[1] is None:
                sp.queued = (sp.queued[0], ev.ts)
            elif sp.queued is None:     # submit/queue fell off the ring
                sp.queued = (ev.ts, ev.ts)
            sp.active.append((ev.ts, None))
        elif ev.kind == "park":
            _close(sp.active, ev.ts)
            sp.parked.append((ev.ts, None))
            sp.parks += 1
        elif ev.kind == "restore":
            _close(sp.parked, ev.ts)
            sp.active.append((ev.ts, None))
        elif ev.kind == "shed":
            if sp.queued is not None and sp.queued[1] is None:
                sp.queued = (sp.queued[0], ev.ts)
            sp.retired_s = ev.ts
            sp.outcome = "shed"
        elif ev.kind == "retire":
            _close(sp.active, ev.ts)
            if sp.queued is not None and sp.queued[1] is None:
                # resolved straight out of the queue (cache hit / error)
                sp.queued = (sp.queued[0], ev.ts)
            sp.retired_s = ev.ts
            reason = ev.attrs.get("reason", "retired")
            sp.outcome = {"cache": "cache_hit"}.get(reason, reason)
            if "supersteps" in ev.attrs:
                sp.supersteps = int(ev.attrs["supersteps"])
            if "messages" in ev.attrs:
                sp.messages = int(ev.attrs["messages"])
            if ev.attrs.get("deadline_slack_s") is not None:
                sp.deadline_slack_s = float(ev.attrs["deadline_slack_s"])
    return spans


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

_QUERY_PID = 1
_SCHED_PID = 2
_STORE_PID = 3


def _json_safe(v):
    """Chrome-trace ``args`` must be JSON; numpy scalars and dict int
    keys are converted, anything else falls back to str."""
    try:
        json.dumps(v)
        return v
    except TypeError:
        if isinstance(v, dict):
            return {str(k): _json_safe(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_json_safe(x) for x in v]
        if hasattr(v, "item"):
            return v.item()
        return str(v)


def chrome_trace(events: List[TraceEvent]) -> Dict[str, Any]:
    """Render events as Chrome trace-event JSON (Perfetto-loadable).

    Layout: process 1 holds one thread per query (its queued / active /
    parked phases as complete "X" slices, shed/retire reasons in args);
    process 2 one thread per query class (the per-superstep device
    dispatches, each with its lane→query attribution); process 3 the
    graph store's residency transitions as instant events. Timestamps
    are µs relative to the earliest retained event."""
    out: List[Dict[str, Any]] = []
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    base = min(e.ts for e in events)
    end = max(e.ts + e.dur_s for e in events)

    def us(t: float) -> float:
        return (t - base) * 1e6

    out.append({"ph": "M", "pid": _QUERY_PID, "name": "process_name",
                "args": {"name": "queries"}})
    out.append({"ph": "M", "pid": _SCHED_PID, "name": "process_name",
                "args": {"name": "scheduler"}})
    out.append({"ph": "M", "pid": _STORE_PID, "name": "process_name",
                "args": {"name": "graph-store"}})

    # ---- per-query phase slices --------------------------------------
    spans = assemble_spans(events)
    for qid, sp in sorted(spans.items()):
        label = f"q{qid}" + (f" [{sp.tenant}]" if sp.tenant else "")
        if sp.klass:
            label += f" {sp.klass}"
        out.append({"ph": "M", "pid": _QUERY_PID, "tid": qid,
                    "name": "thread_name", "args": {"name": label}})
        phases = []
        if sp.queued is not None:
            phases.append(("queued", [sp.queued]))
        phases.append(("active", sp.active))
        phases.append(("parked", sp.parked))
        for name, intervals in phases:
            for a, b in intervals:
                b_eff = end if b is None else b
                out.append({
                    "ph": "X", "pid": _QUERY_PID, "tid": qid,
                    "name": name, "cat": "query",
                    "ts": us(a), "dur": max(0.0, us(b_eff) - us(a)),
                    "args": {"open": b is None},
                })
        if sp.retired_s is not None:
            args = {"outcome": sp.outcome}
            if sp.supersteps is not None:
                args["supersteps"] = sp.supersteps
            if sp.messages is not None:
                args["messages"] = sp.messages
            if sp.deadline_slack_s is not None:
                args["deadline_slack_ms"] = sp.deadline_slack_s * 1e3
            out.append({"ph": "i", "pid": _QUERY_PID, "tid": qid,
                        "name": sp.outcome or "retire", "cat": "query",
                        "ts": us(sp.retired_s), "s": "t",
                        "args": _json_safe(args)})

    # ---- scheduler dispatches + store transitions --------------------
    class_tids: Dict[str, int] = {}
    for ev in sorted(events, key=lambda e: e.ts):
        if ev.kind == "superstep":
            key = ev.klass or "?"
            tid = class_tids.get(key)
            if tid is None:
                tid = class_tids[key] = len(class_tids) + 1
                out.append({"ph": "M", "pid": _SCHED_PID, "tid": tid,
                            "name": "thread_name", "args": {"name": key}})
            out.append({"ph": "X", "pid": _SCHED_PID, "tid": tid,
                        "name": "superstep", "cat": "dispatch",
                        "ts": us(ev.ts), "dur": ev.dur_s * 1e6,
                        "args": _json_safe(ev.attrs)})
        elif ev.kind in ("publish", "spill", "refault", "evict"):
            out.append({"ph": "i", "pid": _STORE_PID, "tid": 1,
                        "name": ev.kind, "cat": "store",
                        "ts": us(ev.ts), "s": "t",
                        "args": _json_safe(ev.attrs)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
