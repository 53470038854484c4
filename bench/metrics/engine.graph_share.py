"""Share of the engine's superstep dispatches replayed from a CUDA graph:
the engine's ``engine.graph_replays`` over its ``engine.supersteps``
counters, over the run's calls, warm-up among them; None for a program
that keeps no ``engine.supersteps``."""


def read(run):
    try:
        from repro_torch.core import obs
    except ImportError:     # a program that keeps no such counters
        return None
    snap = obs.counters.snapshot()
    steps = snap.get("engine.supersteps", 0)
    if not steps:
        return None
    return snap.get("engine.graph_replays", 0) / steps
