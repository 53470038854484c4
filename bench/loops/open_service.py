"""An open loop of independent users over ``GraphQueryService.submit``.

The mix's file gives the rate, the kernels' shares, the root rule and
how many answers of each kernel the check compares. From the seed: a
fixed number of queries (rate x window), the kernels in exact shares in
a random order, distinct roots. The arrival times are Poisson (sorted
uniform times over the window) drawn from the mix's own
``arrival_seed``, not from the seed, so every seed offers the same
arrivals and a run's tail does not swing with where a seed's bursts
fall. Each query is timed from when it was due, and is
issued then by a pool of threads, so a ``submit`` that waits for the
service holds back no later arrival.
"""
from __future__ import annotations

import concurrent.futures
import functools
import gc
import time

import numpy as np

from bench import devtrace
from bench.gen.graphs import ROOT_RULES
from bench.harness import GRACE_S, Query, Window

GRAPH_ID = "g"
WARM_QUERIES = 2            # real queries of each kernel before the window
ISSUERS = 64                # threads that issue the queries when they are due
# The traced run keeps every lifecycle event of the window: a query
# emits four, each device superstep one.
TRACE_EVENTS_PER_QUERY = 4
TRACE_SUPERSTEPS_PER_S = 5000
PROFILE_AT, PROFILE_S = 0.4, 2.0   # the profiled part of the window


def schedule(mix: dict, seconds: float, candidates: np.ndarray,
             rng: np.random.Generator):
    """(due times, kernels, roots, sampled) of the window's queries, and
    the warm-up queries' (kernels, roots)."""
    kernels = sorted(mix["mix"])
    n = int(round(mix["rate_qps"] * seconds))
    share = np.array([mix["mix"][k] for k in kernels], float)
    counts = np.floor(n * share / share.sum()).astype(int)
    counts[0] += n - counts.sum()
    kinds = rng.permutation(np.repeat(kernels, counts))
    due = np.sort(np.random.default_rng(mix["arrival_seed"])
                  .uniform(0.0, seconds, n))
    warm = [k for k in kernels for _ in range(WARM_QUERIES)]
    roots = rng.choice(candidates, size=n + len(warm), replace=False)
    sampled = np.zeros(n, bool)
    for k, want in mix["sample"].items():
        mine = np.flatnonzero(kinds == k)
        sampled[rng.choice(mine, size=min(want, mine.size),
                           replace=False)] = True
    return due, kinds, roots[:n], sampled, (warm, roots[n:])


def _sleep_until(t: float) -> None:
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


def _answered(q: Query, t0: float, fut) -> None:
    q.done = time.perf_counter() - t0
    exc = fut.exception()
    if exc is not None:
        q.error = repr(exc)
    elif q.sampled:
        q.answer = dict(fut.result().state)


def serve(ctx, n_queries: int):
    """Set-up: the service with the graph added, every kernel of the mix
    warmed and started; with tracing, the trace holds the events of
    ``n_queries`` queries and of the window's supersteps."""
    from repro_torch.service import GraphQueryService, QueryRequest
    kwargs = {"device": ctx.device, "scheduling": "continuous",
              "tracing": ctx.trace}
    if ctx.trace:
        kwargs["trace_capacity"] = int(
            TRACE_EVENTS_PER_QUERY * n_queries
            + TRACE_SUPERSTEPS_PER_S * (ctx.seconds + GRACE_S))
    svc = GraphQueryService(**kwargs)
    svc.add_graph(GRAPH_ID, ctx.port_graph())
    for k in sorted(ctx.traffic["mix"]):
        svc.warm(GRAPH_ID, k)
    svc.start()
    return svc, QueryRequest


def window(ctx, svc, QueryRequest, queries, profile: bool):
    """Issue every query when it is due and wait for the answers, at most
    GRACE_S past the window's close. Returns the counters (with how late
    the issuers ran and how long ``submit`` held them) and the profiled
    part's trace."""
    steps0 = svc.stats_snapshot()["supersteps_total"]
    svc.trace.clear()
    prof = devtrace.Profiler(ctx.torch) if profile else None
    # the profiled part starts at PROFILE_AT of the window and lasts
    # PROFILE_S (at most a fifth of it) from when it really started
    started, stop_at, trace = False, None, None
    issued, late, held = [], [], []
    t0 = time.perf_counter()

    def profile_until(t):
        nonlocal started, stop_at, trace
        if prof is None or trace is not None:
            return
        if not started and PROFILE_AT * ctx.seconds <= t:
            _sleep_until(t0 + PROFILE_AT * ctx.seconds)
            prof.start()
            started = True
            stop_at = (time.perf_counter() - t0
                       + min(PROFILE_S, 0.2 * ctx.seconds))
        if started and stop_at <= t:
            _sleep_until(t0 + stop_at)
            trace = prof.stop()

    def issue(q):
        t = time.perf_counter()
        late.append(t - t0 - q.due)
        fut = svc.submit(QueryRequest(GRAPH_ID, q.kernel, dict(q.params)))
        held.append(time.perf_counter() - t)
        fut.add_done_callback(functools.partial(_answered, q, t0))
        return fut

    pool = concurrent.futures.ThreadPoolExecutor(ISSUERS, "issue")
    try:
        for q in queries:
            profile_until(q.due)
            _sleep_until(t0 + q.due)
            issued.append(pool.submit(issue, q))
        profile_until(np.inf)
        deadline = t0 + ctx.seconds + GRACE_S
        done, _ = concurrent.futures.wait(
            issued, timeout=max(0.0, deadline - time.perf_counter()))
        concurrent.futures.wait(
            [f.result() for f in done if f.exception() is None],
            timeout=max(0.0, deadline - time.perf_counter()))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    for q, f in zip(queries, issued):
        if q.done is None and f.done() and f.exception() is not None:
            q.done, q.error = time.perf_counter() - t0, repr(f.exception())
    counters = {"supersteps": svc.stats_snapshot()["supersteps_total"]
                - steps0,
                "issue_late_ms_max": 1e3 * max(late, default=0.0),
                "submit_ms_max": 1e3 * max(held, default=0.0)}
    if ctx.trace:
        if svc.trace.dropped:
            raise RuntimeError(f"the trace dropped {svc.trace.dropped} "
                               "events: raise trace_capacity")
        counters["events"] = svc.trace.snapshot()
    return counters, trace


def queries_of(ctx, rate_qps: float, candidates, rng):
    due, kinds, roots, sampled, warm = schedule(
        dict(ctx.traffic, rate_qps=rate_qps), ctx.seconds, candidates, rng)
    return [Query(str(k), {"root": int(r)}, float(t), sampled=bool(s))
            for k, r, t, s in zip(kinds, roots, due, sampled)], warm


def run(ctx) -> Window:
    rng = np.random.default_rng(ctx.seed)
    queries, (warm_k, warm_r) = queries_of(
        ctx, ctx.traffic["rate_qps"],
        ROOT_RULES[ctx.traffic["roots"]](ctx.graph), rng)
    svc, QueryRequest = serve(ctx, len(queries) + len(warm_k))
    try:
        warm = [svc.submit(QueryRequest(GRAPH_ID, k, {"root": int(r)}))
                for k, r in zip(warm_k, warm_r)]
        for f in warm:
            f.result(timeout=600)
        del warm
        ctx.setup_done()
        counters, trace = window(ctx, svc, QueryRequest, queries, ctx.trace)
    finally:
        svc.stop(drain=False)
    del svc
    gc.collect()
    return Window(queries, ctx.seconds, counters, trace)
