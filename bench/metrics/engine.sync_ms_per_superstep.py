"""Host milliseconds a superstep waits on the device: the
``engine.sync`` ranges in the profiled window (each host read of the
live bits) over the ``engine.superstep`` count."""
from bench.metrics import _spans


def read(run):
    steps = _spans.ranges(run, "engine.superstep")
    if not steps:
        return None
    return _spans.total_ms(_spans.ranges(run, "engine.sync")) / len(steps)
