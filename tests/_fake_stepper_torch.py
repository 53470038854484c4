"""Shared fake-stepper harness for the port's scheduler tests: a copy of
``tests/_fake_stepper.py`` over ``repro_torch.service.continuous``.

Implements the full LaneStepper protocol over host numpy arrays —
including the preemption verbs (``fetch_lane``/``restore``), so a
restored lane's step counter RESUMES (the fake's bit-identity) — plus
the hooks the lock/accounting regressions gate on:

  * ``step_hook`` fires inside ``step()`` while the scheduler lock is
    held, so tests can gate superstep boundaries deterministically;
  * ``trace_on_first_step`` makes the fake engine 'trace' once, for the
    compile-wall accounting tests.

A query with kwarg ``depth=d`` is alive for exactly ``d`` steps.
``submit_fake`` takes the caller's ``Future`` when one is given, so a
threaded test can attach its done-callbacks before the submit races a
pump.
"""
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np

from repro_torch.service import QueryClass, QueryRequest
from repro_torch.service.continuous import ContinuousScheduler


class FakeEngine:
    def __init__(self, trace_on_first_step=False):
        self.traces = 0
        self.kernel = SimpleNamespace(query_params=("depth",),
                                      max_supersteps=None)
        self._trace_pending = trace_on_first_step

    def lane_result(self, host, lane):
        return SimpleNamespace(messages=1,
                               supersteps=int(host["steps"][lane]))


class FakeStepper:
    def __init__(self, width, engine, step_hook=None):
        self.width = width
        self.engine = engine
        self.step_hook = step_hook or (lambda: None)

    def _probe(self, carry):
        return carry["remaining"] > 0, carry["steps"].copy()

    def init(self, qkw):
        carry = {"remaining": qkw["depth"].astype(np.int64).copy(),
                 "steps": np.zeros(self.width, np.int64)}
        return (carry, *self._probe(carry))

    def admit(self, carry, qkw, fresh):
        carry = {k: v.copy() for k, v in carry.items()}
        carry["remaining"][fresh] = qkw["depth"][fresh]
        carry["steps"][fresh] = 0
        return (carry, *self._probe(carry))

    def step(self, carry, alive):
        self.step_hook()
        if self.engine._trace_pending:
            self.engine.traces += 1
            self.engine._trace_pending = False
        carry = {k: v.copy() for k, v in carry.items()}
        carry["remaining"][alive] -= 1
        carry["steps"][alive] += 1
        return (carry, *self._probe(carry))

    def fetch(self, carry):
        return carry

    def fetch_lane(self, carry, lane):
        return {k: v[lane].copy() for k, v in carry.items()}

    def restore(self, carry, lane_carry, fresh):
        carry = {k: v.copy() for k, v in carry.items()}
        for k in carry:
            carry[k][fresh] = lane_carry[k]
        return (carry, *self._probe(carry))


def fake_scheduler(slots=2, stats=None, trace_on_first_step=False,
                   step_hook=None, **kw):
    """(ContinuousScheduler over a fake stepper, its QueryClass)."""
    eng = FakeEngine(trace_on_first_step)
    splan = SimpleNamespace(engine=eng,
                            stepper=FakeStepper(slots, eng, step_hook),
                            query_params=("depth",))
    sched = ContinuousScheduler(slots=slots, stats=stats,
                                get_stepper=lambda qc: splan, **kw)
    qclass = QueryClass("g", "fake", "gravfm", 4, "ref", 1)
    return sched, qclass


def submit_fake(sched, qclass, depth, deadline_ms=600_000, priority=0,
                tenant="default", fut=None):
    fut = Future() if fut is None else fut
    sched.submit(qclass, QueryRequest("g", "fake", {"depth": depth},
                                      deadline_ms=deadline_ms,
                                      priority=priority, tenant=tenant),
                 fut)
    return fut
