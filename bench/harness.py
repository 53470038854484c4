"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``); the mix names the loop that drives the window
(``loops/<loop>.py``); each kernel the window serves has a judge
(``checks/<kernel>.py``); each per-layer metric has a reader
(``metrics/<metric>.py``). A later cell adds files and entries and edits
none of these.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)
# how long after the window's close the harness waits for answers due in
# it; one that has not come by then counts as failed
GRACE_S = 60.0

__all__ = ["Ctx", "Query", "Window", "cell", "run_cell", "forbidden_modules"]


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str) -> Dict[str, Any]:
    """The cell's entry, configuration, traffic mix, and its metrics'
    names and units."""
    m = manifest()
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")

    def mine(metrics):
        return {x["name"]: x["unit"] for x in metrics
                if workload in x.get("workloads", [workload])}
    return {"entry": entry,
            "config": _json(BENCH / "configs" / f"{entry['config']}.json"),
            "traffic": _json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            "end_to_end": mine(m["end_to_end"]),
            "per_layer": mine(m["per_layer"])}


def _module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Query:
    """One query of the window: what was asked, when it was due and
    answered (host seconds from the window's start), and its answer if
    it is in the sample the check compares."""
    kernel: str
    params: Dict[str, Any]
    due: float
    done: Optional[float] = None
    error: Optional[str] = None
    sampled: bool = False
    answer: Optional[Dict[str, np.ndarray]] = None
    traced: bool = False            # answered inside the profiled part


@dataclasses.dataclass
class Window:
    """What a loop hands back: every query, the window's length, and
    what the traced run recorded for the readers."""
    queries: List[Query]
    window_s: float
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Any = None               # devtrace.DeviceTrace of the traced part


@dataclasses.dataclass
class Ctx:
    torch: Any
    device: Any
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    graph: Any                      # gen.graphs.Edges
    t_start: float
    setup_s: Optional[float] = None
    group: Any = None               # ranks.Group of a cell on many cards

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def world(self) -> int:
        return 1 if self.group is None else self.group.world

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop`` on every rank, so that all close a window on
        the same call (one tiny collective; ``stop`` itself on one card)."""
        return stop if self.group is None else self.group.agree(stop)

    def built(self) -> None:
        """The program is built: on many cards, wait for every rank's."""
        if self.group is not None:
            self.group.built()

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def port_graph(self):
        from repro_torch.core.graph import Graph
        g = self.graph
        return Graph(g.num_vertices, g.src, g.dst, g.weights)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class _Edges:
    """The benchmark's graph as device tensors, for the reference."""

    def __init__(self, torch, g, device):
        self.num_vertices = g.num_vertices
        self.src = torch.as_tensor(g.src, dtype=torch.int64, device=device)
        self.dst = torch.as_tensor(g.dst, dtype=torch.int64, device=device)
        self.w = (None if g.weights is None
                  else torch.as_tensor(g.weights, device=device))


def judge(torch, g, queries: List[Query], device):
    """The sampled answers against the plain reference: the numbers each
    kernel's judge gives, summed (mismatches) or the largest (gaps), and
    their limits."""
    edges = _Edges(torch, g, device)
    numbers: Dict[str, float] = {}
    limits: Dict[str, float] = {}
    by_kernel: Dict[str, List[Query]] = {}
    for q in queries:
        if q.sampled and q.answer is not None:
            by_kernel.setdefault(q.kernel, []).append(q)
    for kernel, qs in sorted(by_kernel.items()):
        check = _module("checks", kernel)
        want = check.reference(edges, [q.params for q in qs])
        for name, value in check.compare([q.answer for q in qs],
                                         want).items():
            numbers[name] = (numbers.get(name, 0) + value
                             if name == "mismatch"
                             else max(numbers.get(name, value), value))
            limits[name] = check.LIMITS[name]
    return numbers, limits


def control_answers(torch, g, queries: List[Query], device, dtype) -> None:
    """Put the reference, computed in ``dtype``, in the program's place:
    the sampled queries' answers become the lower-precision reference's."""
    edges = _Edges(torch, g, device)
    by_kernel: Dict[str, List[Query]] = {}
    for q in queries:
        if q.sampled:
            by_kernel.setdefault(q.kernel, []).append(q)
    for kernel, qs in by_kernel.items():
        check = _module("checks", kernel)
        for q, a in zip(qs, check.reference(edges, [q.params for q in qs],
                                            dtype=dtype)):
            q.answer = a


def latency_ms(queries: List[Query], q: float) -> float:
    """The ``q``-th percentile of due-to-answer latency over every query;
    a query that failed or never came counts as beyond every answer."""
    lat = np.array([(x.done - x.due) * 1e3 if x.done is not None
                    and x.error is None else np.inf for x in queries])
    value = float(np.percentile(lat, q))
    if not np.isfinite(value):
        value = float(np.max(np.where(np.isfinite(lat), lat, 0.0))
                      + GRACE_S * 1e3)
    return value


def end_to_end(ctx: Ctx, win: Window, peak_bytes: int) -> Dict[str, float]:
    from bench import edges as E
    out = {"setup_s": ctx.setup_s, "device_mem_peak_gib": peak_bytes / GIB}
    if ctx.traffic["loop"] == "open_service":
        out["latency_p50_ms"] = latency_ms(win.queries, 50)
        out["latency_p95_ms"] = latency_ms(win.queries, 95)
    else:
        done = [q for q in win.queries if q.done is not None]
        out["gteps"] = (E.traversed(ctx.graph, [q.kernel for q in done],
                                    [q.params for q in done])
                        / win.window_s / 1e9)
    return out


def window(torch, spec: Dict[str, Any], seed: int, seconds: float,
           trace: bool, dev, t_start: float, group=None):
    """The cell's graph from the seed, and its loop's set-up and window on
    ``dev``: the :class:`Ctx` and the :class:`Window`. On many cards the
    rank joins its group once it has the graph."""
    from bench.gen import graphs
    g = graphs.make(spec["config"]["graph"], seed)
    if group is not None:
        group.join()
    ctx = Ctx(torch, dev, seed, seconds, trace, spec["config"],
              spec["traffic"], g, t_start, group=group)
    loop = _module("loops", spec["traffic"]["loop"])
    return ctx, loop.run(ctx)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             spec: Optional[Dict[str, Any]] = None,
             control_dtype=None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr),
             launch: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of ``workload``; returns the result line as a dict (the
    compared numbers last, under ``checks``). ``spec`` replaces the
    cell's entry from ``BENCHMARK.json`` (the tests' small cells);
    ``control_dtype`` judges the reference computed in that dtype in the
    program's place (the control, never run by the benchmark). A cell on
    more than one card runs here as rank 0, on the card the one-chip
    path uses, with a rank a card (``ranks.Launch``, which takes
    ``launch`` as keyword arguments: the tests' faults and timeout)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from bench import devtrace, ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = spec or cell(workload)
    many = spec["entry"]["chips"] > 1
    with (ranks.Launch(torch, spec, seed, seconds, trace, device,
                       **(launch or {})) if many
          else contextlib.nullcontext()) as ranked:
        dev = ranked.group.device if many else torch.device(device)
        ctx, win = window(torch, spec, seed, seconds, trace, dev, t_start,
                          ranked.group if many else None)
        cuda = dev.type == "cuda"
        cards = [{"peak": torch.cuda.max_memory_allocated(dev) if cuda else 0,
                  "busy_s": (devtrace.busy_s(win.trace)
                             if trace and win.trace is not None else None),
                  "forbidden": forbidden_modules()}]
        if many:
            cards += ranked.collect()
    peak = max(c["peak"] for c in cards)
    e2e = end_to_end(ctx, win, peak)
    if cuda:
        torch.cuda.empty_cache()

    folded = ranks.fold(cards)
    found = folded.pop("forbidden")
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    if control_dtype is not None:
        control_answers(torch, ctx.graph, win.queries, dev, control_dtype)
    numbers, limits = judge(torch, ctx.graph, win.queries, dev)
    failed = sum(1 for q in win.queries if q.done is None or q.error)
    sampled = sum(1 for q in win.queries if q.sampled)
    checked = sum(1 for q in win.queries if q.sampled and q.answer is not None)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    checks["failed"] = {"value": failed, "limit": 0}
    checks["unchecked"] = {"value": sampled - checked, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        run = {"ctx": ctx, "window": win, "trace": win.trace,
               "counters": win.counters, "peaks": _json(BENCH / "peaks.json"),
               "kind": torch.cuda.get_device_name(dev) if cuda else None}
        metrics = {}
        for name, unit in spec["per_layer"].items():
            value = _module("metrics", name).read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {k: {"value": e2e[k], "unit": unit}
                   for k, unit in spec["end_to_end"].items()}
    busy = folded.pop("busy_s", None)
    devinfo = {"platform": "gpu" if cuda else dev.type,
               "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
               **folded}
    if cuda:
        devinfo["power_limit_w"] = power_limit_w()
    line = {"correct": correct, "attempted": len(win.queries),
            "failed": failed, "metrics": metrics, "device": devinfo}
    if trace and win.trace is not None:
        devinfo["busy_s"] = busy
        devinfo["window_s"] = win.trace.window_s
        line["breakdown"] = devtrace.breakdown(win.trace)
    if many:
        line["ranks"] = {"rendezvous_s": ranked.group.rendezvous_s,
                         "built_wait_s": ranked.group.built_wait_s}
        log(f"ranks: rendezvous {ranked.group.rendezvous_s} s, rank 0 "
            f"waited {ranked.group.built_wait_s} s for the slowest build; "
            f"peaks by card {folded['memory_peak_bytes_by_card']}")
    if "issue_late_ms_max" in win.counters:
        # beside the latency: how far the open loop's issue of a query
        # fell behind its due time, and how long the service's submit
        # held an issuer
        line["load"] = {k: win.counters[k]
                        for k in ("issue_late_ms_max", "submit_ms_max")}
        log(f"queries issued late by at most "
            f"{win.counters['issue_late_ms_max']:.3f} ms; submit held an "
            f"issuer at most {win.counters['submit_ms_max']:.3f} ms")
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return line
