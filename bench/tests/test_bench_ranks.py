"""A cell on four ranks, on the CPU over gloo, each rank a process: the
four-rank small cell through ``run_cell`` is correct, prints one line and
reports every card; the control and a fault of the exchange are not
correct; a rank that exits in set-up, or stops answering in the window,
ends the run with no process left behind. And a one-chip line keeps its
keys and device numbers."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, ranks
from bench.tests import _rank_fault, _small

ROOT = harness.ROOT
# the group's timeout in the fault runs; each four-rank run's own limit
GROUP_TIMEOUT_S = 5.0
RUN_LIMIT_S = 240


def _rank0(seed: int, *, trace=False, fault=None, control=False,
           device="cpu"):
    """The four-rank small cell, rank 0 in a process of its own: its exit
    code, line (None without one), standard output and error, and the
    time it ended."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "from bench.tests import _rank_fault, _small\n"
        "kw = {}\n"
        f"fault = {fault!r}\n"
        "if fault:\n"
        "    _rank_fault.plant(fault, 0)\n"
        f"    kw['launch'] = {{'entry': [sys.executable, "
        f"{_rank_fault.__file__!r}, fault], 'timeout_s': {GROUP_TIMEOUT_S!r}}}\n"
        f"if {control!r}:\n"
        "    kw['control_dtype'] = torch.bfloat16\n"
        f"line = _small.run_ranks(seed={seed!r}, trace={trace!r}, "
        f"device={device!r}, **kw)\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=RUN_LIMIT_S, cwd=ROOT)
    ended = time.time()
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out, line, ended


def _gone(stderr: str) -> None:
    """Every rank that rank 0 started has ended."""
    pids = [int(p) for p in re.findall(r"rank \d+ pid (\d+)", stderr)]
    assert len(pids) == _small.RANKS - 1, stderr[-3000:]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("trace", [False, True])
def test_four_rank_small_cell_is_correct(trace):
    out, line, _ = _rank0(2**31 + 11 + trace, trace=trace)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(out.stdout.strip().splitlines()) == 1   # the ranks print none
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["unchecked"]["value"] == 0
    dev = line["device"]
    assert dev["count"] == _small.RANKS
    assert dev["memory_peak_bytes_by_card"] == [0] * _small.RANKS
    assert dev["memory_peak_bytes"] == 0
    assert line["ranks"]["rendezvous_s"] > 0
    spec = _small.shard_spec()
    if trace:
        assert dev["busy_s"] >= 0 and dev["window_s"] > 0
        assert set(line["metrics"]) <= set(spec["per_layer"])
    else:
        assert set(line["metrics"]) == set(spec["end_to_end"])
    _gone(out.stderr)


@pytest.mark.parametrize("case", ["control", "exchange_left_out"])
def test_four_rank_control_and_fault_are_not_correct(case):
    out, line, _ = _rank0(2**31 + 21, control=case == "control",
                          fault=None if case == "control" else case)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not line["correct"], line["checks"]
    _gone(out.stderr)


@pytest.mark.parametrize("fault,limit_s", [
    ("exit_in_setup", 10.0),
    ("stuck_in_window", GROUP_TIMEOUT_S + ranks.POLL_GRACE_S)])
def test_a_failed_rank_ends_the_run(fault, limit_s):
    out, line, ended = _rank0(2**31 + 31, fault=fault)
    assert out.returncode != 0 and line is None
    assert out.stdout.strip() == ""
    struck = re.search(r"FAULT 2 (\S+)", out.stderr)
    assert struck, out.stderr[-3000:]
    assert ended - float(struck.group(1)) < limit_s, out.stderr[-3000:]
    _gone(out.stderr)


@pytest.mark.parametrize("cards,want", [
    ([{"peak": 7, "busy_s": None, "forbidden": []}],
     {"count": 1, "memory_peak_bytes": 7, "forbidden": []}),
    ([{"peak": 5, "busy_s": 0.5, "forbidden": []},
      {"peak": 9, "busy_s": 0.7, "forbidden": ["jax"]},
      {"peak": 2, "busy_s": 0.3, "forbidden": []},
      {"peak": 9, "busy_s": 0.5, "forbidden": []}],
     {"count": 4, "memory_peak_bytes": 9,
      "memory_peak_bytes_by_card": [5, 9, 2, 9], "busy_s": 0.5,
      "forbidden": ["rank 1: jax"]}),
])
def test_fold_reads_the_fullest_card(cards, want):
    got = ranks.fold(cards)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v) if k == "busy_s" else got[k] == v


@pytest.mark.parametrize("cell", sorted(_small.SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_one_chip_line_keeps_its_keys(cell, trace):
    line = _small.run(cell, seed=2**31 + 41, trace=trace)
    open_loop = _small.spec(cell)["traffic"]["loop"] == "open_service"
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + ["breakdown"] * trace
                          + ["load"] * open_loop + ["checks"])
    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    assert list(line["device"]) == list(device) + ["busy_s",
                                                   "window_s"] * trace
    assert {k: line["device"][k] for k in device} == device
    if trace:
        assert line["device"]["busy_s"] == 0.0


@pytest.mark.gpu
def test_four_rank_small_cell_on_four_cards():
    """The same cell over NCCL, a rank a card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    out, line, _ = _rank0(2**31 + 51, trace=True, device="cuda")
    assert out.returncode == 0, out.stderr[-3000:]
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == _small.RANKS
    assert line["device"]["busy_s"] > 0
    _gone(out.stderr)
