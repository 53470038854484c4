"""BENCHMARK.json against the contract its driver checks, and every name
it gives against the files the harness finds by that name."""
from __future__ import annotations

import copy
import importlib.util
import json
import re

import pytest

from bench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"]
    assert M["command"] == ["python3", "bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]]
             + [w["traffic"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in M[group]]
        assert len(got) == len(set(got)), group
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in M["workloads"] + M["configs"]]
                 + [c["source"] for c in M["configs"]]
                 + [m["layer"] for m in M["per_layer"]]):
        assert LINE.match(text), text


def four_chip_rule(workloads) -> bool:
    """The benchmark's rule on chips: a cell takes 1 or 4, and at most
    max(1, cells // 4) cells take 4."""
    chips = [w["chips"] for w in workloads]
    return (all(c in (1, 4) for c in chips)
            and chips.count(4) <= max(1, len(chips) // 4))


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert four_chip_rule(M["workloads"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _cells(chips):
    """Copies of the manifest's first cell, one for each entry of
    ``chips``, taking that many chips."""
    return [dict(copy.deepcopy(M["workloads"][0]), name=f"c{i}", chips=n)
            for i, n in enumerate(chips)]


@pytest.mark.parametrize("chips,holds", [
    ((1, 4, 1), True), ((4,), True), ((4, 1, 1, 1, 1, 1, 1, 4), True),
    ((4, 4, 1), False), ((1, 2, 1), False), ((4, 1, 1, 1, 1, 1, 4), False)])
def test_four_chip_rule_on_copies(chips, holds):
    assert four_chip_rule(_cells(chips)) is holds


def reported(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reported(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(cell, m) for m in M["per_layer"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert reported(cell, moved), (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.cell(cell)
    conf = next(c for c in M["configs"] if c["name"] == spec["entry"]["config"])
    assert conf["file"] == f"bench/configs/{conf['name']}.json"
    assert spec["config"]["name"] == conf["name"]
    assert spec["config"]["source"] == conf["source"]
    assert sorted(spec["config"]["reduced"]) == sorted(conf["reduced"])
    loop = harness.BENCH / "loops" / f"{spec['traffic']['loop']}.py"
    assert loop.exists()
    kernels = (spec["traffic"].get("mix") or {spec["traffic"]["kernel"]: 1})
    for k in kernels:
        assert (harness.BENCH / "checks" / f"{k}.py").exists()


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_reader_per_metric(metric):
    path = harness.BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_every_config_used():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
