"""The reader of the engine's graph counters, ``engine.graph_share``:
exact values on hand-set counters, nothing to read from a program
without them, and 0 in a small traced run of each closed cell on the
CPU, where every superstep runs the eager loop."""
from __future__ import annotations

import sys

import pytest

from bench.tests import _small
from bench.tests.test_bench_metrics import reader, run_record
import repro_torch.core
from repro_torch.core import obs

NAME = "engine.graph_share"
CLOSED = ("roadpa-sssp8-closed", "g500-s20-pagerank-closed")


def test_graph_share_reads_the_counters(monkeypatch):
    c = obs.Counters()
    monkeypatch.setattr(obs, "counters", c)
    assert reader(NAME).read(run_record(None)) is None
    c.add("engine.graph_replays", 0)
    assert reader(NAME).read(run_record(None)) is None
    c.add("engine.supersteps", 40)
    assert reader(NAME).read(run_record(None)) == 0.0
    c.add("engine.graph_replays", 39)
    assert reader(NAME).read(run_record(None)) == 39 / 40


def test_nothing_to_read_without_the_counters_module(monkeypatch):
    """A program that has no ``repro_torch.core.obs``."""
    monkeypatch.delattr(repro_torch.core, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.core.obs", None)
    assert reader(NAME).read(run_record(None)) is None


def test_nothing_to_read_without_the_superstep_counter(monkeypatch):
    """A program whose ``obs`` keeps other counters but no
    ``engine.supersteps``, as before the superstep graph."""
    c = obs.Counters()
    c.add("engine.lanes_scanned", 4000)
    c.add("engine.messages", 30)
    monkeypatch.setattr(obs, "counters", c)
    assert reader(NAME).read(run_record(None)) is None


@pytest.mark.parametrize("cell", CLOSED)
def test_small_traced_run_reports_no_replay_on_the_cpu(cell):
    line = _small.run(cell, seed=2**31 + 11, trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "share"}
