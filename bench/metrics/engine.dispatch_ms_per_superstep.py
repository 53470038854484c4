"""Host milliseconds to enqueue one superstep: the ``engine.superstep``
ranges in the profiled window (one step dispatch and its freeze, not the
read of the live bits) over their count."""
from bench.metrics import _spans


def read(run):
    steps = _spans.ranges(run, "engine.superstep")
    if not steps:
        return None
    return _spans.total_ms(steps) / len(steps)
