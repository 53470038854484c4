"""One closed-loop client over the engine: ``Engine.run_batch`` over
``batch`` roots (or ``Engine.run`` where the mix has no batch), each call
sent when the last has answered, until the window is over.

The window closes with the first call that ends past ``--seconds``; its
length is the time to that call's end, so every call in it is whole.
The check compares the answers of ``sample`` calls, drawn from the seed
by reservoir sampling over the calls made.

:func:`drive` is the loop over any engine with ``run`` and ``run_batch``
(``closed_shard`` drives the shard engine with it). On many ranks every
rank makes the same calls, and each decision of the loop (where the
profiled part starts and stops, where the window closes) is rank 0's,
through ``ctx.agree``.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from bench import devtrace
from bench.gen.graphs import ROOT_RULES
from bench.harness import Query, Window

PROFILE_AT, PROFILE_S = 0.4, 1.0   # the traced part: whole calls from here


def run(ctx) -> Window:
    from repro_torch.core.engine import Engine
    mode = ctx.config["deployment"]["mode"]
    return drive(ctx, lambda kernel, pg: Engine(kernel, pg, mode=mode,
                                                device=ctx.device))


def drive(ctx, make) -> Window:
    """The closed loop over ``make(kernel, pg)``, the engine of the mix's
    kernel over the configuration's partition of the graph."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.partition import partition_graph
    mix, dep = ctx.traffic, ctx.config["deployment"]
    rng = np.random.default_rng(ctx.seed)
    pick = np.random.default_rng([ctx.seed, 1])
    batch = int(mix.get("batch", 0))
    candidates = ROOT_RULES[mix["roots"]](ctx.graph) if batch else None

    def call_params():
        if not batch:
            return [dict(mix["params"])]
        return [{"root": int(r)}
                for r in rng.choice(candidates, size=batch)]

    pg = partition_graph(ctx.port_graph(), dep["parts"],
                         method=dep["partition"])
    eng = make(ALG.ALGORITHMS[mix["kernel"]](**mix.get("params", {})), pg)
    ctx.built()

    def call(params):
        if not batch:
            return [eng.run()]
        return eng.run_batch(root=np.array([p["root"] for p in params]))

    call(call_params())                      # builds and warms every shape
    ctx.setup_done()

    prof = devtrace.Profiler(ctx.torch) if ctx.trace else None
    # the profiled part: whole calls from PROFILE_AT of the window, for
    # PROFILE_S from when the profiler has started; ``profiled_s`` spans
    # it with the profiler's start and stop
    trace, prof_t0, prof_from, profiled_steps = None, None, None, 0
    counters = {"profiled_s": 0.0}
    queries, reservoir, calls = [], [], 0
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter() - t0
        if prof is not None and prof_from is None \
                and ctx.agree(start >= PROFILE_AT * ctx.seconds):
            prof_t0 = start
            prof.start()
            prof_from = time.perf_counter() - t0
        profiled = prof_from is not None and trace is None
        params = call_params()
        results = call(params)
        end = time.perf_counter() - t0
        steps = max(r.supersteps for r in results)
        if profiled:
            profiled_steps += steps
            if ctx.agree(end - prof_from >= PROFILE_S):
                trace = prof.stop()
                counters["profiled_s"] = time.perf_counter() - t0 - prof_t0
        mine = [Query(mix["kernel"], p, start, end, traced=profiled)
                for p in params]
        queries += mine
        # reservoir sampling of whole calls
        calls += 1
        slot = (len(reservoir) if len(reservoir) < mix["sample"]
                else int(pick.integers(calls)))
        if slot < mix["sample"]:
            if slot < len(reservoir):
                for q in reservoir[slot]:
                    q.sampled, q.answer = False, None
                reservoir[slot] = mine
            else:
                reservoir.append(mine)
            for q, r in zip(mine, results):
                q.sampled, q.answer = True, r.state
        del results
        if ctx.agree(end >= ctx.seconds):
            break
    if prof is not None and trace is None:
        if prof_from is None:
            prof.start()
        trace = prof.stop()
        if prof_t0 is not None:
            counters["profiled_s"] = end - prof_t0
    del eng, pg
    gc.collect()
    counters.update(profiled_supersteps=profiled_steps, calls=calls)
    return Window(queries, end, counters, trace)
