"""Find the knee of an open-loop cell: the highest rate with no growing
backlog. Not part of a benchmark run; run once when a cell is defined:

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 3 4 5 --repeats 2

One process, one set-up; each rate gets ``--repeats`` windows of its
own, with fresh roots. Prints one JSON line a window: the queries, the
share answered within the window, p50 and p95 from the due time, the
backlog (queries due and not yet answered) at each quarter of the window,
its growth in queries a second (a least-squares line through the backlog
read each second of the window's last three quarters), how long it took
to drain, how late the issuers ran and how long ``submit`` held them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402,F401  (paths and caches, as a benchmark run)


def backlog(queries, t: float) -> int:
    return sum(1 for q in queries
               if q.due <= t and (q.done is None or q.done > t))


def growth_qps(queries, seconds: float) -> float:
    """Slope of the backlog over the window's last three quarters."""
    import numpy as np
    t = np.arange(np.ceil(seconds / 4), np.floor(seconds) + 1)
    b = [backlog(queries, x) for x in t]
    return float(np.polyfit(t, b, 1)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    from bench import harness
    from bench.gen import graphs
    from bench.loops import open_service as L
    spec = harness.cell(args.workload)
    g = graphs.make(spec["config"]["graph"], args.seed)
    ctx = harness.Ctx(torch, torch.device("cuda"), args.seed, args.seconds,
                      False, spec["config"], spec["traffic"], g, T_START)
    rng = np.random.default_rng(args.seed)
    free = L.ROOT_RULES[spec["traffic"]["roots"]](g)
    svc, QueryRequest = L.serve(ctx, 0)
    try:
        warm = [svc.submit(QueryRequest(L.GRAPH_ID, k, {"root": int(r)}))
                for k in sorted(spec["traffic"]["mix"]) for r in free[:2]]
        for f in warm:
            f.result(timeout=600)
        ctx.setup_done()
        print(json.dumps({"setup_s": ctx.setup_s}), flush=True)
        free = free[2:]
        for rate in args.rates:
            for _ in range(args.repeats):
                queries, _ = L.queries_of(ctx, rate, free, rng)
                used = {q.params["root"] for q in queries}
                free = free[~np.isin(free, list(used))]
                counters, _ = L.window(ctx, svc, QueryRequest, queries,
                                       False)
                T = args.seconds
                done = [q.done for q in queries if q.done is not None]
                print(json.dumps({
                    "rate_qps": rate, "queries": len(queries),
                    "answered_in_window": sum(1 for d in done if d <= T)
                    / len(queries),
                    "failed": sum(1 for q in queries
                                  if q.done is None or q.error),
                    "latency_p50_ms": harness.latency_ms(queries, 50),
                    "latency_p95_ms": harness.latency_ms(queries, 95),
                    "backlog_quarters": [backlog(queries, T * k / 4)
                                         for k in (1, 2, 3, 4)],
                    "backlog_growth_qps": growth_qps(queries, T),
                    "drain_s": max(done, default=T) - T,
                    "issue_late_ms_max": counters["issue_late_ms_max"],
                    "submit_ms_max": counters["submit_ms_max"],
                    "supersteps": counters["supersteps"]}), flush=True)
    finally:
        svc.stop(drain=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
