"""The device trace of a traced run, reduced to what the readers need.

:class:`Profiler` runs part of the measured window under
``torch.profiler`` (host operators and device activity) inside a
``bench.window`` range, writes the Chrome trace to a temporary file and
reads it back as a :class:`DeviceTrace`: the window's bounds, every
kernel, copy and set on the device, and the host's operators. All times
are the profiler's microseconds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DeviceTrace", "Profiler", "parse", "union_s", "busy_s",
           "breakdown", "WINDOW"]

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    window: Tuple[float, float]                  # (start, end) us
    device: List[Tuple[str, float, float]]       # (name, start, end) us
    host: List[Tuple[str, float, float]]         # host operators

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self) -> List[Tuple[str, float, float]]:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device
                if b > lo and a < hi]


def parse(events: List[dict]) -> Optional[DeviceTrace]:
    """A Chrome trace's ``traceEvents`` as a :class:`DeviceTrace`; None
    without a ``bench.window`` range."""
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation" and e.get("name") == WINDOW:
            window = (ts, ts + dur)
        elif cat in DEVICE_CATS:
            device.append((e.get("name", cat), ts, ts + dur))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver", "python_function"):
            host.append((e.get("name", cat), ts, ts + dur))
    if window is None:
        return None
    return DeviceTrace(window, device, host)


class Profiler:
    """Profile from :meth:`start` to :meth:`stop` (host operators and
    device activity) inside a ``bench.window`` range; :meth:`stop`
    returns the parsed trace."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._torch = torch
        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            acts.append(ProfilerActivity.CUDA)
        try:    # every thread's host operators: the service dispatches
            # from its own thread
            from torch.profiler import _ExperimentalConfig
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
        self._prof = profile(activities=acts, experimental_config=config)
        self._range = record_function(WINDOW)

    def start(self) -> None:
        if self._cuda:
            self._torch.cuda.synchronize()
        self._prof.start()
        self._range.__enter__()

    def stop(self) -> Optional[DeviceTrace]:
        if self._cuda:
            self._torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return parse(events)


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) microsecond spans."""
    if not intervals:
        return 0.0
    iv = sorted(intervals)
    total, cur_a, cur_b = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return (total + cur_b - cur_a) / 1e6


def busy_s(trace: DeviceTrace) -> float:
    """Seconds of the window in which any device operation ran."""
    return union_s([(a, b) for _, a, b in trace.in_window()])


def gaps(trace: DeviceTrace) -> List[Tuple[float, float]]:
    """The window's idle spans (us), where no device operation ran."""
    lo, hi = trace.window
    iv = sorted((a, b) for _, a, b in trace.in_window())
    out, t = [], lo
    for a, b in iv:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _host_at(host_sorted, starts, t: float, reach: int = 256) -> str:
    """The innermost host operator running at ``t``: the latest-starting
    one that still covers it."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(-1, i - reach), -1):
        name, a, b = host_sorted[j]
        if b >= t and name != WINDOW:
            return name
    return "(host between operators)"


def breakdown(trace: DeviceTrace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by
    the host operator running in the middle of each gap."""
    by_op: Dict[str, float] = {}
    for name, a, b in trace.in_window():
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    host_sorted = sorted(trace.host, key=lambda h: h[1])
    starts = np.array([h[1] for h in host_sorted])
    by_host: Dict[str, float] = {}
    for a, b in gaps(trace):
        name = _host_at(host_sorted, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6

    def top_of(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}
