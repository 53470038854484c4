"""The open loop's schedule comes from the seed alone, and a submit that
waits for the service holds back no later arrival."""
from __future__ import annotations

import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from bench.harness import Query
from bench.loops import open_service as L

MIX = {"rate_qps": 16.0, "arrival_seed": 1, "mix": {"bfs": 3, "sssp": 1},
       "sample": {"bfs": 12, "sssp": 4}}
CANDIDATES = np.arange(10, 5000)


def draw(seed, seconds=30.0, mix=MIX, candidates=CANDIDATES):
    return L.schedule(mix, seconds, candidates, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40])
def test_schedule(seed):
    due, kinds, roots, sampled, (warm_k, warm_r) = draw(seed)
    assert len(due) == 480                      # rate x window, every seed
    assert (np.diff(due) >= 0).all() and 0 <= due[0] and due[-1] < 30.0
    assert list(kinds).count("bfs") == 360 and list(kinds).count("sssp") == 120
    assert len(set(roots) | set(warm_r)) == 480 + len(warm_k)
    assert np.isin(roots, CANDIDATES).all()
    assert sampled.sum() == 16
    assert (kinds[sampled] == "bfs").sum() == 12
    assert warm_k == ["bfs", "bfs", "sssp", "sssp"]


def test_same_seed_same_schedule_other_seed_other():
    a, b, c = draw(9), draw(9), draw(10)
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1]) and not np.array_equal(a[2], c[2])
    # every seed offers the same arrivals; the mix's arrival_seed others
    np.testing.assert_array_equal(a[0], c[0])
    other = draw(9, mix=dict(MIX, arrival_seed=2))
    assert not np.array_equal(a[0], other[0])


def test_arrivals_look_poisson():
    due = draw(3, seconds=1000.0, candidates=np.arange(20000))[0]
    gaps = np.diff(due)
    assert abs(gaps.mean() - 1 / 16) < 0.005
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1   # exponential: cv 1


def test_exact_shares_with_remainder():
    _, kinds, *_ = draw(1, seconds=1.0, mix=dict(MIX, rate_qps=7.0))
    assert len(kinds) == 7 and list(kinds).count("sssp") == 1


class _SlowService:
    """A service whose submit holds its caller, one caller at a time, as
    a scheduler's lock does; answers come at once after."""

    def __init__(self, hold_s):
        self.hold_s, self.lock = hold_s, threading.Lock()
        self.trace = types.SimpleNamespace(clear=lambda: None, dropped=0)

    def stats_snapshot(self):
        return {"supersteps_total": 0}

    def submit(self, req):
        with self.lock:
            time.sleep(self.hold_s)
        fut = Future()
        fut.set_result(types.SimpleNamespace(state={}))
        return fut


def test_a_held_submit_holds_back_no_later_arrival():
    queries = [Query("bfs", {"root": i}, 0.05 * i) for i in range(8)]
    ctx = types.SimpleNamespace(torch=torch, seconds=0.5, trace=False)
    counters, _ = L.window(ctx, _SlowService(0.2), lambda *a: a, queries,
                           False)
    assert all(q.done is not None and q.error is None for q in queries)
    assert counters["issue_late_ms_max"] < 100      # issued when due
    assert counters["submit_ms_max"] >= 200
    # submits queue behind each other: the last answer comes about
    # 8 x 0.2 s after the first was due, and is timed from its due time
    assert queries[-1].done - queries[-1].due > 1.0
