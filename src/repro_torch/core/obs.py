"""Spans and counters of the port's engine, for a profiler's trace.

:func:`span` is a ``torch.profiler.record_function`` range while a
profiler records and a shared no-op otherwise, so the ranges land on the
profiler's clock beside the kernels they launch, and a span costs one
attribute read when nothing records. There is no switch: spans are on
exactly while a profiler is running.

:data:`counters` holds process-wide integer counts that the engine adds
to once per call or per step dispatch (never once per phase):

  engine.lanes_scanned  lanes a deliver passed over, padding included:
                        the query axis x the engine's lane count, per
                        step dispatch
  engine.messages       the ``EngineResult.messages`` of every result
                        the engine built
  engine.supersteps     step dispatches of the engines' superstep
                        loops, eager or replayed from a CUDA graph
                        (not a ``LaneStepper``'s steps)
  engine.graph_replays  those of them replayed from a CUDA graph
  engine.graph_captures CUDA graphs of a superstep captured

Span names (``engine.*``, ``service.*``) are fixed: PERF.md and the
benchmark's readers use them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "counters", "Counters"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records; the
    shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class Counters:
    """Lock-guarded integer counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


counters = Counters()
