"""The readers of the engine's own spans and counters: exact values on a
hand-built trace, nothing to read from a program without them, and all
four in a small traced run of each closed cell."""
from __future__ import annotations

import sys

import pytest

from bench import devtrace
from bench.tests import _small
from bench.tests.test_bench_metrics import reader, run_record
import repro_torch.core
from repro_torch.core import obs

SPAN_READERS = ("engine.dispatch_ms_per_superstep",
                "engine.sync_ms_per_superstep", "engine.call_overhead_ms")
READERS = SPAN_READERS + ("engine.lane_yield",)
CLOSED = ("roadpa-sssp8-closed", "g500-s20-pagerank-closed")


def _trace():
    """Two calls in a window of 0-1000 us, one more ending past it, and
    a superstep before it: only ranges wholly inside the window count."""
    host = [("bench.window", 0, 1000),
            ("engine.superstep", -50, -10),
            # call 1: 500 us, 50 + 70 of supersteps, 30 + 50 + 10 of syncs
            ("engine.call", 100, 600), ("engine.init", 105, 118),
            ("engine.sync", 120, 150), ("engine.superstep", 150, 200),
            ("aten::index_select", 160, 170),
            ("engine.sync", 200, 250), ("engine.superstep", 250, 320),
            ("engine.sync", 320, 330), ("engine.collect", 330, 590),
            # call 2: 200 us, 100 of supersteps, 20 + 20 of syncs
            ("engine.call", 650, 850), ("engine.sync", 660, 680),
            ("engine.superstep", 680, 780), ("engine.sync", 780, 800),
            # cut by the window's end
            ("engine.call", 900, 1100), ("engine.sync", 950, 990),
            ("engine.superstep", 990, 1050)]
    return devtrace.DeviceTrace((0.0, 1000.0), [("k", 150, 190)], host)


def test_span_readers_on_a_hand_built_trace():
    run = run_record(_trace())
    # 50 + 70 + 100 + (990-1000 is cut) over 3 supersteps in the window
    assert reader("engine.dispatch_ms_per_superstep").read(run) == \
        pytest.approx(0.220 / 3)
    # syncs 30 + 50 + 10 + 20 + 20 + 40, over the same 3
    assert reader("engine.sync_ms_per_superstep").read(run) == \
        pytest.approx(0.170 / 3)
    # (500 - 120 - 90) and (200 - 100 - 40), the cut call left out
    assert reader("engine.call_overhead_ms").read(run) == \
        pytest.approx((0.290 + 0.060) / 2)


def test_lane_yield_reads_the_counters(monkeypatch):
    c = obs.Counters()
    monkeypatch.setattr(obs, "counters", c)
    assert reader("engine.lane_yield").read(run_record(None)) is None
    c.add("engine.lanes_scanned", 4000)
    c.add("engine.messages", 30)
    assert reader("engine.lane_yield").read(run_record(None)) == 30 / 4000


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_the_spans(monkeypatch, name):
    """The parent program: no spans in the trace, no counters module."""
    bare = devtrace.DeviceTrace((0.0, 100.0), [("k", 0, 50)],
                                [("aten::add", 10, 20)])
    monkeypatch.delattr(repro_torch.core, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.core.obs", None)
    for tr in (None, bare):
        assert reader(name).read(run_record(tr)) is None


@pytest.mark.parametrize("cell", CLOSED)
def test_small_traced_run_reports_all_four(cell):
    line = _small.run(cell, seed=2**31 + 11, trace=True)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    assert set(READERS) <= set(got)
    for name in SPAN_READERS:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    assert 0 < got["engine.lane_yield"]["value"] <= 1
