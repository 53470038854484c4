"""Share of the lanes the engine scanned that carried a message: the
engine's ``engine.messages`` over its ``engine.lanes_scanned`` counter
(padding included), over the run's calls, warm-up among them."""


def read(run):
    try:
        from repro_torch.core import obs
    except ImportError:     # a program that keeps no such counters
        return None
    snap = obs.counters.snapshot()
    lanes = snap.get("engine.lanes_scanned", 0)
    if not lanes:
        return None
    return snap.get("engine.messages", 0) / lanes
