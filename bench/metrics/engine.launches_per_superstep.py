"""Device operations (kernels, copies, sets) in the profiled calls over
the supersteps those calls ran (the largest ``EngineResult.supersteps``
of each call)."""
from bench.metrics._common import per_superstep



def read(run):
    trace = run["trace"]
    return None if trace is None else per_superstep(run,
                                                    len(trace.in_window()))
