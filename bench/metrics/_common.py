"""Shared arithmetic of the readers: the device's share of a window and
the peak the shares are taken against."""
from __future__ import annotations

from bench import devtrace


def hbm_bytes_per_s(run):
    """The card's published HBM rate, or None for a card the table lacks."""
    peak = run["peaks"].get(run["kind"] or "")
    return None if peak is None else float(peak["hbm_bytes_per_s"])


def idle_share(run):
    """1 - device busy / profiled wall; None without device activity."""
    trace = run["trace"]
    if trace is None or not trace.in_window() or trace.window_s <= 0:
        return None
    return 1.0 - devtrace.busy_s(trace) / trace.window_s


def per_superstep(run, value):
    steps = run["counters"].get("profiled_supersteps")
    if run["trace"] is None or not steps or not run["trace"].in_window():
        return None
    return value / steps
