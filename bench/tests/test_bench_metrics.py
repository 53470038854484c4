"""The metric arithmetic: intervals, traversed edges, byte counts, and the
readers over a synthetic trace."""
from __future__ import annotations

import importlib.util
import types

import numpy as np
import pytest

from bench import devtrace, edges, harness
from bench.gen import graphs


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, harness.BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_union_of_intervals():
    assert devtrace.union_s([]) == 0.0
    assert devtrace.union_s([(0, 10), (5, 15), (20, 30), (30, 31),
                             (22, 25)]) == pytest.approx(26e-6)


def trace_of(device, window=(0.0, 100.0), host=()):
    return devtrace.DeviceTrace(window, list(device), list(host))


def test_busy_gaps_and_breakdown():
    tr = trace_of([("k1", -5, 10), ("copy", 20, 30), ("k1", 25, 40),
                   ("late", 95, 120)],
                  host=[("aten::index_select", 10, 22),
                        ("aten::item", 40, 96), ("bench.window", 0, 100)])
    assert devtrace.busy_s(tr) == pytest.approx(35e-6)
    assert devtrace.gaps(tr) == [(10, 20), (40, 95)]
    b = devtrace.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(25e-6)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::index_select": pytest.approx(10e-6),
        "aten::item": pytest.approx(55e-6)}


def test_parse_chrome_trace():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "segment_combine_kernel<int>",
         "ts": 110, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 120,
         "dur": 2},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.window",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 105,
         "dur": 3},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    tr = devtrace.parse(events)
    assert tr.window == (100.0, 150.0)
    assert [d[0] for d in tr.device] == ["segment_combine_kernel<int>",
                                         "Memcpy DtoH"]
    assert tr.host == [("aten::add", 105.0, 108.0)]
    assert devtrace.parse(events[1:]) is None


def test_traversed_edges():
    # 0 <-> 1 <-> 2 (4 directed edges), 3 -> 4 (one way), 5 isolated
    g = graphs.Edges(6, np.array([0, 1, 1, 2, 3], np.int32),
                     np.array([1, 0, 2, 1, 4], np.int32), None)
    np.testing.assert_array_equal(edges.reach_edges(g, [0, 2, 3, 4, 0]),
                                  [4, 4, 1, 0, 4])
    assert edges.traversed(g, ["sssp", "bfs"],
                           [{"root": 1}, {"root": 3}]) == 5
    assert edges.traversed(g, ["pagerank"] * 2,
                           [{"num_supersteps": 30, "damping": 0.85}] * 2) \
        == 2 * 30 * 5


def test_byte_counts():
    k1 = reader("k1_roofline")
    assert k1.launch_bytes(10, 100, 1) == 400 + 400 + 40
    assert k1.launch_bytes(10, 100, 8) == 400 + 8 * 440
    q = reader("query_roofline")
    assert q.iteration_bytes(10, 100) == 400 + 44 + 120


def run_record(trace, *, counters=None, queries=(), graph=(1000, 16000),
               traffic=None, window_s=10.0, world=1):
    g = types.SimpleNamespace(num_vertices=graph[0], num_edges=graph[1])
    ctx = types.SimpleNamespace(graph=g, traffic=traffic or {}, world=world)
    win = harness.Window(list(queries), window_s, counters or {}, trace)
    return {"ctx": ctx, "window": win, "trace": trace,
            "counters": counters or {}, "kind": "NVIDIA H100 80GB HBM3",
            "peaks": {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 1e9}}}


def test_readers_on_a_synthetic_trace():
    tr = trace_of([("segment_combine_kernel<float>", 0, 50),
                   ("other", 50, 60), ("segment_combine_kernel<float>", 80,
                                       130)], window=(0.0, 200.0))
    run = run_record(tr, counters={"profiled_supersteps": 2})
    assert reader("device.idle_share.batch").read(run) == pytest.approx(0.45)
    assert reader("engine.launches_per_superstep").read(run) == 1.5
    assert reader("engine.busy_ms_per_superstep").read(run) == \
        pytest.approx(0.055)
    # two launches of 132 KB at 1 GB/s = 264 us, over 100 us measured
    assert reader("k1_roofline").read(run) == pytest.approx(264.0)
    # nothing to read: no trace, no device activity, no peak for the card
    for name in ("device.idle_share.batch", "engine.launches_per_superstep",
                 "k1_roofline"):
        assert reader(name).read(run_record(None)) is None
        assert reader(name).read(run_record(trace_of([]))) is None
    run["kind"] = "some other card"
    assert reader("k1_roofline").read(run) is None


def test_k1_roofline_reads_nothing_on_many_ranks():
    """On four ranks the kernel's launches are K2's over one shard."""
    tr = trace_of([("segment_combine_kernel<float>", 0, 50)])
    assert reader("k1_roofline").read(run_record(tr, world=4)) is None


def test_query_roofline_and_service_readers():
    done = [harness.Query("pagerank", {"num_supersteps": 30}, 0.0, 1.0)] * 4
    run = run_record(None, counters={"profiled_s": 2.0}, queries=done + [
        harness.Query("pagerank", {"num_supersteps": 30}, 0.0),
        harness.Query("pagerank", {"num_supersteps": 30}, 0.0, 1.0,
                      traced=True)])
    want = 100.0 * 120 * (4 * 16000 + 4 * 1001 + 12 * 1000) / (1e9 * 8.0)
    assert reader("query_roofline").read(run) == pytest.approx(want)
    # four cards: four cards' rate
    run["ctx"].world = 4
    assert reader("query_roofline").read(run) == pytest.approx(want / 4)
    ev = types.SimpleNamespace
    events = [ev(kind="submit", ts=0.0, qid=1, attrs={}),
              ev(kind="admit", ts=0.010, qid=1, attrs={}),
              ev(kind="submit", ts=0.0, qid=2, attrs={}),
              ev(kind="retire", ts=0.002, qid=2, attrs={"reason": "cache"}),
              ev(kind="retire", ts=0.5, qid=1,
                 attrs={"reason": "retired", "supersteps": 9}),
              ev(kind="superstep", ts=0.1, qid=None, attrs={})]
    run = run_record(None, counters={"events": events, "supersteps": 3})
    assert reader("service.queue_ms.p95").read(run) == \
        pytest.approx(np.percentile([10.0, 2.0], 95))
    assert reader("service.lanes_per_superstep").read(run) == 3.0
    assert reader("service.queue_ms.p95").read(run_record(None)) is None
