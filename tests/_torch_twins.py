"""Helpers shared by the port's twins of the reference's host-side suites
(``tests/test_torch_{store,continuous,metrics,trace,service_suite,
preempt}.py``).

``mixed_graph`` is ``benchmarks.continuous._mixed_graph`` rebuilt over the
port's ``Graph`` (``test_torch_preempt.py`` holds its arrays equal to the
benchmark's). ``jax_graph`` hands the JAX package a port graph's arrays,
so both services of a parity test serve the same ``Graph``.
``assert_same_result`` is the exact comparison every parity test makes
of two ``EngineResult``s. ``wait_for_arrival`` is the threaded twins'
hand-off: it returns once a ``submit`` waits for the scheduler lock.
"""
import time

import numpy as np

from repro_torch.core import graph as G


def mixed_graph(n_core: int, avg_degree: float, tail: int,
                seed: int = 0) -> G.Graph:
    """uniform(n_core, avg_degree) plus a disconnected line of ``tail``
    vertices: core roots are shallow, tail roots are deep."""
    core = G.uniform(n_core, avg_degree, seed=seed).symmetrized()
    n = n_core + tail
    cs = np.arange(n_core, n - 1, dtype=np.int32)
    src = np.concatenate([core.src, cs, cs + 1]).astype(np.int32)
    dst = np.concatenate([core.dst, cs + 1, cs]).astype(np.int32)
    return G.Graph(n, src, dst)


def jax_graph(g):
    """The JAX package's ``Graph`` over a copy of a port graph's arrays."""
    from repro.core import graph as JG
    return JG.Graph(g.num_vertices, g.src.copy(), g.dst.copy(),
                    None if g.weights is None else g.weights.copy())


def assert_same_result(got, want):
    """Every field of two ``EngineResult``s equal, exactly (BFS, SSSP and
    WCC states are integers or min-combined floats)."""
    assert got.supersteps == want.supersteps
    assert got.messages == want.messages
    assert got.comm == want.comm
    for view in ("state", "raw_state"):
        g, w = getattr(got, view), getattr(want, view)
        assert set(g) == set(w), view
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (view, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{view}.{k}")


def wait_for_arrival(sched, timeout: float = 5.0) -> None:
    """Return once a ``submit`` is waiting for ``sched``'s lock (it has
    entered its event in ``_arrivals``)."""
    end = time.monotonic() + timeout
    while not sched._arrivals:
        assert time.monotonic() < end, "the submit never reached the lock"
        time.sleep(0.001)


# the exact counters of ``stats_snapshot()`` a parity stream holds equal
COUNTERS = ("queries_submitted", "queries_completed", "queries_shed",
            "batches_dispatched", "batch_pad_queries", "plan_cache_hits",
            "plan_cache_misses", "plan_traces", "result_cache_hits",
            "preemptions", "lane_restores", "supersteps_total",
            "messages_total", "wire_words_total")


def jax_service(graph, **kw):
    """The JAX service (its oracle, ``backend="ref"``) over ``graph``."""
    from repro.service import GraphQueryService
    svc = GraphQueryService(backend="ref", **kw)
    svc.add_graph("g", jax_graph(graph), pad_multiple=16)
    return svc


def serve_waves(svc, request_cls, waves, polls=4, arrival_s=0.0):
    """Submit each wave of ``(kernel, query_kwargs, request_kw)`` with
    the same injected arrival time, then ``polls`` polls; returns the
    futures and, after every poll, which of them are done. The caller
    flushes."""
    futs, done = [], []
    for wave in waves:
        futs += [svc.submit(request_cls("g", k, dict(qkw),
                                         arrival_s=arrival_s, **rkw))
                 for k, qkw, rkw in wave]
        for _ in range(polls):
            svc.poll()
            done.append(tuple(f.done() for f in futs))
    return futs, done
