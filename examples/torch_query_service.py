"""Query-service quickstart on the PyTorch port: serve many BFS/SSSP
queries over one shared partitioned graph, with batching, plan caching,
and live stats.

The twin of ``examples/query_service.py`` over ``repro_torch``: the same
graph, seeds, requests and printed lines.

  PYTHONPATH=src python examples/torch_query_service.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core import graph as G
from repro_torch.service import GraphQueryService, QueryRequest


def main(device=None):
    """Print the demo's lines; return its answers: root 0's reach and
    depth, every burst query's supersteps, the continuous queries'
    supersteps and the continuous service's counters."""
    g = G.uniform(4096, 16.0, seed=0).symmetrized().with_unit_weights()
    out = {}

    svc = GraphQueryService(device=device, num_shards=4, max_batch=32)
    svc.add_graph("uniform-16", g)           # partition once, pin on device
    svc.warm("uniform-16", "bfs")            # build the hot plans

    # --- synchronous one-off -------------------------------------------
    res = svc.query("uniform-16", "bfs", root=0)
    hops = (res.state["parent"] >= 0).sum()
    out["root0"] = (int(hops), res.supersteps)
    print(f"bfs root=0: reached {hops}/{g.num_vertices} vertices "
          f"in {res.supersteps} supersteps")

    # --- a traffic burst: 64 queries batched under a deadline ----------
    svc.start()                               # async scheduler thread
    rng = np.random.default_rng(1)
    futs = [svc.submit(QueryRequest("uniform-16", "bfs",
                                    {"root": int(r)}, deadline_ms=100))
            for r in rng.integers(0, g.num_vertices, size=64)]
    depths = [max(f.result().supersteps for f in futs)]
    svc.stop()
    out["burst"] = [f.result().supersteps for f in futs]
    print(f"burst of {len(futs)} bfs queries served; max depth {depths[0]}")

    # --- stats endpoint -------------------------------------------------
    snap = svc.stats_snapshot()
    print("stats:", {k: (round(v, 2) if isinstance(v, float) else v)
                     for k, v in snap.items()
                     if k in ("queries_completed", "batches_dispatched",
                              "avg_batch_size", "plan_cache_hits",
                              "plan_cache_misses", "plan_traces",
                              "qps_busy", "latency_p50_ms",
                              "latency_p95_ms", "teps")})

    # --- continuous scheduling ------------------------------------------
    # scheduling="continuous" drives one superstep at a time: each query
    # retires at ITS OWN depth (not the batch maximum) and queued roots
    # splice into freed slots between supersteps. Identical resubmissions
    # hit the result cache without executing at all.
    csvc = GraphQueryService(device=device, num_shards=4, max_batch=16,
                             slots=16, scheduling="continuous")
    csvc.add_graph("uniform-16", g)
    csvc.warm("uniform-16", "bfs")
    croots = [int(r) for r in rng.integers(0, g.num_vertices, size=32)]
    futs = [csvc.submit(QueryRequest("uniform-16", "bfs", {"root": r},
                                     deadline_ms=5000)) for r in croots]
    csvc.flush()                              # pump supersteps to drain
    csvc.submit(QueryRequest("uniform-16", "bfs",
                             {"root": croots[0]}))  # result-cache hit
    csnap = csvc.stats_snapshot()
    out["continuous"] = [f.result().supersteps for f in futs]
    out["continuous_counters"] = {k: csnap[k] for k in (
        "queries_completed", "result_cache_hits", "plan_traces")}
    print(f"continuous: {csnap['queries_completed']} served, "
          f"p50={csnap['latency_p50_ms']:.1f}ms, "
          f"result_cache_hits={csnap['result_cache_hits']}, "
          f"re-traces={csnap['plan_traces']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
