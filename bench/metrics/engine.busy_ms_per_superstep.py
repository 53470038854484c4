"""Device busy milliseconds in the profiled calls over the supersteps
they ran."""
from bench import devtrace
from bench.metrics._common import per_superstep



def read(run):
    trace = run["trace"]
    return None if trace is None else per_superstep(
        run, 1e3 * devtrace.busy_s(trace))
