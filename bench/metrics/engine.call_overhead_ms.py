"""Host milliseconds of an engine call outside its superstep loop: over
the ``engine.call`` ranges wholly in the profiled window, the mean of
each one's length less the ``engine.superstep`` and ``engine.sync``
ranges inside it (the query upload, init, collect)."""
from bench.metrics import _spans


def read(run):
    calls = _spans.ranges(run, "engine.call")
    if not calls:
        return None
    inner = sorted(_spans.ranges(run, "engine.superstep")
                   + _spans.ranges(run, "engine.sync"))
    out = []
    for a, b in calls:
        loop = sum(e - s for s, e in inner if s >= a and e <= b)
        out.append((b - a - loop) / 1e3)
    return sum(out) / len(out)
