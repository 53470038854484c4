"""The port's own spans in a traced run: the ``engine.*`` ranges the
engine records on the profiler's clock while it runs
(``repro_torch.core.obs``), which ``devtrace.parse`` keeps among the
host events. A program without them gives no ranges, and its readers
read nothing."""
from __future__ import annotations


def ranges(run, name):
    """(start, end) us of every ``name`` range wholly inside the profiled
    window; None without a trace."""
    trace = run["trace"]
    if trace is None:
        return None
    lo, hi = trace.window
    return [(a, b) for n, a, b in trace.host
            if n == name and a >= lo and b <= hi]


def total_ms(intervals) -> float:
    return sum(b - a for a, b in intervals) / 1e3
