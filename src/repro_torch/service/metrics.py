"""Aggregate metrics + SLO watchdog: the scrapeable/alertable layer.

The port's own copy of ``repro.service.metrics`` (numpy only; the
Prometheus names stay ``gravfm_*``): the port imports nothing of the
JAX package.

The stats endpoint (stats.py) is a one-shot dict and the TraceBus
(trace.py) is per-query flight recording; neither is something a
monitoring stack can scrape or page on. This module adds the two
standing pieces:

:class:`MetricsRegistry`
    Counters, gauges and log-bucketed histograms behind one leaf lock
    (same discipline as the TraceBus: the lock is never held while
    calling out, so any scheduler/store path may record under its own
    locks). Memory is bounded twice over — histograms have a fixed
    bucket vector, and each metric family caps its label-series count
    (overflow series are counted in ``series_dropped``, never grown).
    ``expose_text()`` renders the Prometheus text exposition format;
    ``snapshot()`` the JSON equivalent. Registered *collectors* pull
    the current ServiceStats / GraphStore / TraceBus / scheduler
    numbers in at read time, so scrapes see fresh values without any
    hot-path publishing.

:class:`Watchdog`
    A background thread evaluating rolling-window SLO rules against the
    service — deadline-miss rate, shed rate, queue-wait p95, a
    roofline-efficiency floor, stall detection (backlog with no retire
    progress), and **perfmodel drift** (a class's measured TEPS
    deviating from the §5 model projection beyond a tolerance: the
    paper's §6 "94% of roofline" methodology turned into a standing
    alert). Each rule drives a firing/resolved state machine per
    subject; transitions emit ``alert`` events on the TraceBus and
    increment alert counters in the registry. ``evaluate_once()`` is
    the deterministic core (tests drive it directly with an explicit
    clock); ``start()``/``stop()`` wrap it in a daemon thread.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "Histogram", "DEFAULT_BUCKETS",
           "Watchdog", "WatchdogConfig", "Alert",
           "feed_service_snapshot"]


# Half-decade log buckets spanning 1µs .. 100s — wide enough for both a
# sub-millisecond superstep phase and a multi-second stalled dispatch,
# at a fixed 17-bucket (+Inf excluded) memory cost per series.
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-12, 5))


class Histogram:
    """One log-bucketed histogram series: fixed bucket bounds, a
    non-cumulative count per bucket (cumulated at exposition time, as
    the Prometheus format requires), plus ``sum``/``count``."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:])), \
            "histogram bounds must be strictly increasing"
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[int]:
        out, running = [], 0
        for c in self.counts:
            running += c
            out.append(running)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class _Family:
    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = buckets or DEFAULT_BUCKETS
        # label tuple (sorted (k, v) pairs) -> float | Histogram
        self.series: Dict[Tuple[Tuple[str, str], ...], Any] = {}


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


class MetricsRegistry:
    """Bounded, thread-safe metric store with Prometheus exposition.

    Recording (``inc``/``set_gauge``/``observe``) takes one leaf lock
    and never calls out, so it is safe under any service/store lock.
    ``enabled=False`` makes every record a no-op (one attribute read,
    mirroring a disabled TraceBus) and exposition empty.
    """

    def __init__(self, *, enabled: bool = True, max_series: int = 256):
        self.enabled = enabled
        self.max_series = max_series        # per metric family
        self._lock = threading.Lock()  # lock: metrics
        self._families: "Dict[str, _Family]" = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        self.series_dropped = 0             # label sets refused by the cap

    # ---------------- recording ---------------------------------------
    def _series(self, name: str, kind: str, help_text: str,
                labels: Dict[str, Any],
                buckets: Optional[Tuple[float, ...]] = None):
        """Find-or-create one series under the lock; None when the
        family's series cap refused a new label set."""
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help_text,
                                                 buckets)
        assert fam.kind == kind, \
            f"metric {name!r} registered as {fam.kind}, recorded as {kind}"
        key = _label_key(labels)
        if key not in fam.series and len(fam.series) >= self.max_series:
            self.series_dropped += 1
            return None, key
        return fam, key

    def inc(self, name: str, value: float = 1.0, *, help: str = "",
            **labels) -> None:
        """Add ``value`` to a counter series (event-driven path)."""
        if not self.enabled:
            return
        with self._lock:
            fam, key = self._series(name, "counter", help, labels)
            if fam is not None:
                fam.series[key] = fam.series.get(key, 0.0) + float(value)

    def set_counter(self, name: str, value: float, *, help: str = "",
                    **labels) -> None:
        """Set a counter series from an already-cumulative source (the
        stats/store snapshots). Clamped monotone: exposition never shows
        a counter going backward even if a collector races a reset."""
        if not self.enabled:
            return
        with self._lock:
            fam, key = self._series(name, "counter", help, labels)
            if fam is not None:
                fam.series[key] = max(fam.series.get(key, 0.0),
                                      float(value))

    def set_gauge(self, name: str, value: float, *, help: str = "",
                  **labels) -> None:
        if not self.enabled:
            return
        with self._lock:
            fam, key = self._series(name, "gauge", help, labels)
            if fam is not None:
                fam.series[key] = float(value)

    def observe(self, name: str, value: float, *, help: str = "",
                buckets: Optional[Tuple[float, ...]] = None,
                **labels) -> None:
        if not self.enabled:
            return
        with self._lock:
            fam, key = self._series(name, "histogram", help, labels,
                                    buckets)
            if fam is None:
                return
            h = fam.series.get(key)
            if h is None:
                h = fam.series[key] = Histogram(fam.buckets)
            h.observe(float(value))

    # ---------------- collection --------------------------------------
    def add_collector(self,
                      fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register a pull-time feeder: called (outside the lock) by
        ``snapshot()``/``expose_text()`` so scrapes read fresh
        stats/store/trace values without hot-path publishing."""
        self._collectors.append(fn)

    def collect(self) -> None:
        if not self.enabled:
            return
        for fn in list(self._collectors):
            fn(self)
        self.set_counter("gravfm_metrics_series_dropped_total",
                         self.series_dropped,
                         help="Label series refused by the per-family "
                              "series cap")

    # ---------------- read side ---------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able copy: ``{name: {kind, help, series: [{labels,
        value|histogram}]}}``."""
        self.collect()
        with self._lock:
            out: Dict[str, Any] = {}
            for name, fam in sorted(self._families.items()):
                series = []
                for key, val in sorted(fam.series.items()):
                    entry: Dict[str, Any] = {"labels": dict(key)}
                    if isinstance(val, Histogram):
                        entry["histogram"] = val.to_dict()
                    else:
                        entry["value"] = val
                    series.append(entry)
                out[name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
            return out

    def expose_text(self) -> str:
        """The Prometheus text exposition format (one HELP/TYPE header
        per family, histogram buckets cumulative with ``le`` labels)."""
        self.collect()
        with self._lock:
            lines: List[str] = []
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, val in sorted(fam.series.items()):
                    if isinstance(val, Histogram):
                        lines.extend(self._hist_lines(name, key, val))
                    else:
                        lines.append(
                            f"{name}{self._labels(key)} {_fmt(val)}")
            return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _labels(key, extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @classmethod
    def _hist_lines(cls, name: str, key, h: Histogram) -> List[str]:
        lines = []
        cum = h.cumulative()
        for bound, c in zip(h.bounds, cum):
            le = f'le="{format(bound, ".6g")}"'
            lines.append(f"{name}_bucket{cls._labels(key, le)} {c}")
        inf = 'le="+Inf"'
        lines.append(f"{name}_bucket{cls._labels(key, inf)} {h.count}")
        lines.append(f"{name}_sum{cls._labels(key)} {_fmt(h.sum)}")
        lines.append(f"{name}_count{cls._labels(key)} {h.count}")
        return lines


# ---------------------------------------------------------------------------
# the service snapshot -> registry feed
# ---------------------------------------------------------------------------

# stats_snapshot() scalars that are monotone event counts -> counter name
_SNAP_COUNTERS = {
    "queries_submitted": "gravfm_queries_submitted_total",
    "queries_completed": "gravfm_queries_completed_total",
    "queries_shed": "gravfm_queries_shed_total",
    "batches_dispatched": "gravfm_batches_dispatched_total",
    "batch_pad_queries": "gravfm_batch_pad_queries_total",
    "plan_cache_hits": "gravfm_plan_cache_hits_total",
    "plan_cache_misses": "gravfm_plan_cache_misses_total",
    "plan_traces": "gravfm_plan_traces_total",
    "result_cache_hits": "gravfm_result_cache_hits_total",
    "preemptions": "gravfm_preemptions_total",
    "lane_restores": "gravfm_lane_restores_total",
    "deadline_misses": "gravfm_deadline_misses_total",
    "supersteps_total": "gravfm_supersteps_total",
    "messages_total": "gravfm_messages_total",
    "wire_words_total": "gravfm_wire_words_total",
    "busy_time_s": "gravfm_busy_seconds_total",
    "compile_time_s": "gravfm_compile_seconds_total",
    "park_ms": "gravfm_park_milliseconds_total",
    "restore_ms": "gravfm_restore_milliseconds_total",
    "trace_events": "gravfm_trace_events_total",
    "trace_dropped": "gravfm_trace_dropped_total",
}

# point-in-time scalars -> gauge name
_SNAP_GAUGES = {
    "qps": "gravfm_qps",
    "qps_busy": "gravfm_qps_busy",
    "teps": "gravfm_teps",
    "avg_batch_size": "gravfm_avg_batch_size",
    "latency_p50_ms": "gravfm_latency_p50_ms",
    "latency_p95_ms": "gravfm_latency_p95_ms",
    "latency_p99_ms": "gravfm_latency_p99_ms",
    "queue_wait_p50_ms": "gravfm_queue_wait_p50_ms",
    "queue_wait_p95_ms": "gravfm_queue_wait_p95_ms",
    "depth_pred_abs_err": "gravfm_depth_pred_abs_err",
    "pending": "gravfm_pending_queries",
    "parked_lanes": "gravfm_parked_lanes",
    "uptime_s": "gravfm_uptime_seconds",
}


def feed_service_snapshot(reg: MetricsRegistry, snap: Dict[str, Any],
                          store_counter_keys=frozenset()) -> None:
    """Map one ``GraphQueryService.stats_snapshot()`` payload onto the
    registry: scalar counters/gauges, ``store_*`` keys split by
    ``store_counter_keys``, the per-tenant breakdown, and the per-class
    roofline telemetry (measured vs §5-projected TEPS)."""
    for key, name in _SNAP_COUNTERS.items():
        if key in snap:
            reg.set_counter(name, float(snap[key]))
    for key, name in _SNAP_GAUGES.items():
        if key in snap:
            reg.set_gauge(name, float(snap[key]))
    for key, val in snap.items():
        if not key.startswith("store_") or not isinstance(
                val, (int, float)):
            continue
        base = key[len("store_"):]
        if base in store_counter_keys or base == "refault_upload_ms":
            reg.set_counter(f"gravfm_store_{base}_total", float(val))
        else:
            reg.set_gauge(f"gravfm_store_{base}", float(val))
    for tenant, t in (snap.get("tenants") or {}).items():
        for field in ("submitted", "completed", "shed", "messages",
                      "result_cache_hits", "deadline_misses"):
            if field in t:
                reg.set_counter(f"gravfm_tenant_{field}_total",
                                float(t[field]), tenant=tenant)
        for field in ("latency_p50_ms", "latency_p95_ms"):
            if field in t:
                reg.set_gauge(f"gravfm_tenant_{field}", float(t[field]),
                              tenant=tenant)
    for ck, r in (snap.get("roofline") or {}).items():
        reg.set_gauge("gravfm_roofline_teps", r["teps"],
                      help="Measured per-class TEPS", **{"class": ck})
        reg.set_gauge("gravfm_roofline_projected_teps",
                      r["projected_teps"],
                      help="Perfmodel T_sys projection", **{"class": ck})
        reg.set_gauge("gravfm_roofline_efficiency", r["efficiency"],
                      help="Measured / projected TEPS (paper §6)",
                      **{"class": ck})
        reg.set_counter("gravfm_class_messages_total", r["messages"],
                        **{"class": ck})
        reg.set_counter("gravfm_class_wire_words_total", r["wire_words"],
                        **{"class": ck})
        reg.set_gauge("gravfm_class_words_per_message",
                      r["words_per_message"], **{"class": ck})
        if r.get("overlap_efficiency") is not None:
            # exposed/total exchange wall (profiled shard classes):
            # 1.0 = synchronous, -> 0 = exchange fully hidden
            reg.set_gauge("gravfm_overlap_efficiency",
                          float(r["overlap_efficiency"]),
                          help="Exposed / total exchange time per class",
                          **{"class": ck})


# ---------------------------------------------------------------------------
# SLO watchdog
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WatchdogConfig:
    """Rule thresholds. A threshold of ``None`` disables that rule.

    Rate rules (miss/shed) are evaluated over a rolling ``window_s``
    of counter deltas and need at least ``min_window_events`` in the
    denominator before they can fire (an idle service never alerts on a
    0/0). Model rules (roofline floor / drift) read the cumulative
    per-class roofline accounting and need ``min_completed`` retired
    queries per class. The measured-vs-model defaults are *disabled*:
    on a CPU development box the measured TEPS is nowhere near an
    FPGA projection, so firing out of the box would be noise —
    deployments opt in with the tolerance that matches their platform.
    """

    interval_s: float = 0.25        # thread evaluation cadence
    window_s: float = 30.0          # rolling window for rate rules
    miss_rate_max: Optional[float] = 0.5
    shed_rate_max: Optional[float] = 0.9
    queue_wait_p95_ms_max: Optional[float] = None
    roofline_floor: Optional[float] = None      # min efficiency, e.g. 0.5
    drift_tol: Optional[float] = None           # e.g. 1.0 = within 2x
    stall_after_s: float = 5.0
    min_window_events: int = 8
    min_completed: int = 8


@dataclasses.dataclass
class Alert:
    """One firing/resolved episode of a rule on a subject."""

    rule: str
    subject: str            # "service" or a class key
    kind: str               # slo | liveness | model
    value: float
    threshold: float
    fired_at: float
    resolved_at: Optional[float] = None

    @property
    def state(self) -> str:
        return "resolved" if self.resolved_at is not None else "firing"


class Watchdog:
    """Evaluates :class:`WatchdogConfig` rules against a
    :class:`~repro_torch.service.GraphQueryService`.

    One :class:`Alert` state machine per (rule, subject): the first
    evaluation where a rule's condition holds *fires* (one ``alert``
    trace event, ``gravfm_alerts_fired_total`` increment); it stays
    firing — without re-firing — until an evaluation observes the
    condition false, which *resolves* it (second event, resolved
    counter). Conditions that cannot be evaluated (not enough window
    events, class gone idle before ``min_completed``) leave the state
    machine untouched rather than flapping it.
    """

    HISTORY = 256       # resolved-alert episodes retained

    def __init__(self, service, config: Optional[WatchdogConfig] = None,
                 **overrides):
        self.service = service
        cfg = config or WatchdogConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self._lock = threading.Lock()  # lock: watchdog
        self._active: Dict[Tuple[str, str], Alert] = {}
        self._history: List[Alert] = []
        self._samples: List[Tuple[float, Dict[str, float]]] = []
        self._last_progress: Optional[Tuple[float, float]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.evaluations = 0

    # ---------------- lifecycle ---------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="gravfm-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.evaluate_once()
            except Exception:   # noqa: BLE001 — a scrape/eval error
                # must not kill the thread (the service keeps serving;
                # the next tick retries)
                pass

    # ---------------- alert plumbing ----------------------------------
    def active_alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._active.values())

    def alerts(self) -> List[Alert]:
        """Active + recently resolved episodes."""
        with self._lock:
            return list(self._history) + list(self._active.values())

    def _metrics(self):
        return getattr(self.service, "metrics", None)

    def _emit(self, alert: Alert) -> None:
        trace = getattr(self.service, "trace", None)
        if trace is not None:
            trace.emit("alert", klass=alert.subject, rule=alert.rule,
                       state=alert.state, alert_kind=alert.kind,
                       value=alert.value, threshold=alert.threshold)
        reg = self._metrics()
        if reg is not None:
            which = ("gravfm_alerts_resolved_total"
                     if alert.resolved_at is not None
                     else "gravfm_alerts_fired_total")
            reg.inc(which, rule=alert.rule)

    def _transition(self, key: Tuple[str, str], firing: bool,
                    kind: str, value: float, threshold: float,
                    now: float) -> None:
        with self._lock:
            cur = self._active.get(key)
            if firing and cur is None:
                alert = self._active[key] = Alert(
                    rule=key[0], subject=key[1], kind=kind,
                    value=value, threshold=threshold, fired_at=now)
            elif not firing and cur is not None:
                cur.resolved_at = now
                cur.value = value
                del self._active[key]
                self._history.append(cur)
                del self._history[:-self.HISTORY]
                alert = cur
            else:
                if cur is not None:
                    cur.value = value   # keep the live reading fresh
                return
        self._emit(alert)

    # ---------------- evaluation --------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> List[Alert]:
        """One evaluation pass; returns the alerts active afterwards.
        ``now`` defaults to ``time.perf_counter()`` — tests pass an
        explicit clock to step the window/stall logic deterministically.
        """
        cfg = self.config
        now = time.perf_counter() if now is None else now
        self.evaluations += 1
        snap = self.service.stats.snapshot()
        pending = self.service.pending()

        # rolling-window deltas for the rate rules
        cur = {"completed": float(snap["queries_completed"]),
               "submitted": float(snap["queries_submitted"]),
               "shed": float(snap["queries_shed"]),
               "misses": float(snap["deadline_misses"])}
        self._samples.append((now, cur))
        while (len(self._samples) > 1
               and self._samples[1][0] <= now - cfg.window_s):
            self._samples.pop(0)
        base = self._samples[0][1]
        d_completed = cur["completed"] - base["completed"]
        d_submitted = cur["submitted"] - base["submitted"]
        d_shed = cur["shed"] - base["shed"]
        d_misses = cur["misses"] - base["misses"]

        if cfg.miss_rate_max is not None and \
                d_completed >= cfg.min_window_events:
            rate = d_misses / d_completed
            self._transition(("deadline_miss_rate", "service"),
                             rate > cfg.miss_rate_max, "slo",
                             rate, cfg.miss_rate_max, now)
        if cfg.shed_rate_max is not None and \
                d_submitted >= cfg.min_window_events:
            rate = d_shed / d_submitted
            self._transition(("shed_rate", "service"),
                             rate > cfg.shed_rate_max, "slo",
                             rate, cfg.shed_rate_max, now)
        if cfg.queue_wait_p95_ms_max is not None:
            p95 = float(snap.get("queue_wait_p95_ms", 0.0))
            self._transition(("queue_wait_p95", "service"),
                             p95 > cfg.queue_wait_p95_ms_max, "slo",
                             p95, cfg.queue_wait_p95_ms_max, now)

        # stall: backlog with no retirement progress for stall_after_s
        completed = cur["completed"]
        if (self._last_progress is None
                or completed != self._last_progress[1] or pending == 0):
            self._last_progress = (now, completed)
        stalled_for = now - self._last_progress[0]
        self._transition(("stall", "service"),
                         pending > 0 and stalled_for > cfg.stall_after_s,
                         "liveness", stalled_for, cfg.stall_after_s, now)

        # model rules: per-class measured-vs-projected TEPS
        roofline = snap.get("roofline") or {}
        for ck, r in roofline.items():
            if (r["completed"] < cfg.min_completed
                    or r["projected_teps"] <= 0.0 or r["busy_s"] <= 0.0):
                continue
            eff = r["efficiency"]
            if cfg.roofline_floor is not None:
                self._transition(("roofline_floor", ck),
                                 eff < cfg.roofline_floor, "model",
                                 eff, cfg.roofline_floor, now)
            if cfg.drift_tol is not None:
                lo, hi = 1.0 / (1.0 + cfg.drift_tol), 1.0 + cfg.drift_tol
                self._transition(("perfmodel_drift", ck),
                                 eff < lo or eff > hi, "model",
                                 eff, cfg.drift_tol, now)

        reg = self._metrics()
        if reg is not None:
            with self._lock:
                n_active = len(self._active)
            reg.set_gauge("gravfm_alerts_active", n_active,
                          help="Currently firing watchdog alerts")
            reg.set_counter("gravfm_watchdog_evaluations_total",
                            self.evaluations)
        return self.active_alerts()
