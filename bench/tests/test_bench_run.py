"""Whole runs of the cells at small sizes on the CPU: sound runs are
correct; the control and each fault the timed path can have are not; no
run loads JAX or the JAX package; without a card the command prints no
line."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests import _small

CELLS = sorted(_small.SMALL)
ROOT = harness.ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _small.run(cell, seed=2**31 + 3)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["unchecked"]["value"] == 0
    assert set(line["metrics"]) == set(_small.cell(cell)["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = _small.run(cell, control_dtype=torch.bfloat16)
    assert not line["correct"], line["checks"]


# --- faults planted in the timed path --------------------------------------

def _alter(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    finite = np.where(np.isfinite(x), x, -np.inf) if x.dtype.kind == "f" else x
    i = int(np.argmax(finite))
    x[i] = x[i] + 1 if x.dtype.kind in "iu" else x[i] * (1 + 1e-3)
    return x


def fault_state_unchanged(mp):
    from repro_torch.core.stepper import SuperstepProgram
    mp.setattr(SuperstepProgram, "step_combine",
               lambda self, data, carry, delivered: carry)


def fault_half_batch(mp):
    """Odd queries of a batch (or lanes of a slot array) are left out and
    given their even neighbour's answer."""
    from repro_torch.core.engine import Engine
    orig = Engine._result
    mp.setattr(Engine, "_result", lambda self, state, steps, stats, q:
               orig(self, state, steps, stats, q - q % 2))


def fault_exchange_left_out(mp):
    """Messages between the four partitions are dropped."""
    from repro_torch.core.engine import Engine
    orig = Engine._deliver_gravfm

    def deliver(self, data, payload, active):
        return orig(self, data._replace(
            lane_valid=data.lane_valid & ~data.lane_remote), payload, active)
    mp.setattr(Engine, "_deliver_gravfm", deliver)


def fault_answer_altered(mp):
    from repro_torch.core.engine import Engine
    orig = Engine._result

    def result(self, *args):
        res = orig(self, *args)
        key = next(k for k in ("parent", "dist", "score") if k in res.state)
        res.state[key] = _alter(res.state[key])
        return res
    mp.setattr(Engine, "_result", result)


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "exchange_left_out": fault_exchange_left_out,
          "answer_altered": fault_answer_altered}
# PageRank's calls are batches of one: no half to leave out
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_batch" and "pagerank" in c)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line = _small.run(cell)
    assert not line["correct"], line["checks"]


# --- what a run loads, and the run without a card ---------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_yardstick_imports_nothing_of_the_program():
    for folder in ("reference", "gen", "checks"):
        for path in (harness.BENCH / folder).glob("*.py"):
            for name in _imports(path):
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "jax"), (path, name)


def test_harness_never_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_a_whole_run_loads_no_jax():
    """Every cell's path, traced and untraced, in a fresh process."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench import harness\n"
        "from bench.tests import _small\n"
        "for cell in sorted(_small.SMALL):\n"
        "    for trace in (False, True):\n"
        "        assert _small.run(cell, trace=trace)['correct']\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_exits_nonzero_and_prints_no_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         harness.manifest()["workloads"][0]["name"], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "metrics" not in out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = harness.run_cell(cell, 11, _small.SECONDS, True, device="cuda",
                            spec=_small.spec(cell), log=lambda s: None)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
