#!/usr/bin/env python3
"""Drive the PyTorch port of GraVF-M on one NVIDIA card, and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero:
  1. device : the card's name, the device count, nvidia-smi's name and
              power limit. Without CUDA the script exits 2 at once.
  2. build  : nvcc builds every kernel of src/repro_torch/kernels/csrc
              (-Xptxas -v: registers, shared memory, spills).
  3. host   : graph500's R-MAT at scale 20 (edge factor 16, weighted,
              symmetrized), greedy 4-way partition, the engines' layouts.
  4. sweep  : the segment-combine kernel against its plain PyTorch version
              on the card: {add, min, max} x {float32, int32} over the
              shapes of tests/test_kernels.py and the full-width layout,
              at B=1 and B=8. Exact for min, max and int32 add;
              float32 add at rtol = atol = 1e-5, and at the full width
              (hub rows of 64k terms of both signs) within 1e-5 of each
              row's sum of |value|.
  5. main   : the engine's entry points on the card (BFS run and an 8-root
              run_batch, WCC, PageRank 30, SSSP), with the kernel's launch
              count set to 0 just before and read just after; BFS checked
              by graph500's rules, every run against the port's
              backend="ref" engine on the same graph.
  6. profile: torch.profiler over one BFS and one PageRank run: the
              busiest operators and the device's idle share.
  7. timing : CUDA-event times of the kernel at the main path's shapes,
              beside its plain version, one scatter_reduce_ call on the
              same data (the yardstick; the port never calls it on its
              kernel path) and the bytes bound at 3.35 TB/s.
Then one JSON line with the kernel's numbers, the nvidia-smi line, and
the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, GRAPH_SEED, PARTS = 20, 16, 7, 4
TILE_E, TILE_R = 512, 256
BATCH = 8
TIMING_ITERS = 50
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PAGERANK_RTOL, PAGERANK_ATOL = 1e-4, 1e-9
KERNEL = {
    "name": "segment_combine",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
    "replaces": "src/repro/kernels/edge_gather.py:99",
}
SWEEP_SHAPES = [(0, 16, 32, 16), (1, 1, 32, 16), (500, 64, 64, 32),
                (500, 2000, 64, 32), (777, 130, 128, 64),
                (2048, 64, 256, 256)]
COMBINERS = ("add", "min", "max")
# The main path's key combines: (combiner, dtype name, who calls it).
TIMED = [("min", "int32", "BFS/WCC key, SSSP carry"),
         ("min", "float32", "SSSP key"),
         ("add", "float32", "PageRank")]


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(layout, batch: int) -> float:
    """Least time for the combine: the bytes it must move (rel and
    tile_start read once, vals once per query, the output written once
    per query) over the card's memory rate. One fold per lane per query
    at float32's 67 TFLOP/s is three orders of magnitude less."""
    lanes = layout.rel.numel()
    nbytes = 4 * (lanes + layout.tile_start.numel()
                  + batch * (lanes + layout.num_segments))
    return nbytes / HBM_BYTES_PER_S * 1e3


def lane_values(torch, layout, combiner, dtype, batch, gen):
    """Random (batch, lanes) values with the identity in padding lanes."""
    from repro_torch.kernels.ref import identity_for
    shape = (batch, layout.rel.numel())
    device = layout.rel.device
    if dtype == torch.float32:
        vals = torch.randn(shape, generator=gen, device=device)
    else:
        vals = torch.randint(-1000, 1000, shape, generator=gen,
                             device=device, dtype=torch.int32)
    return torch.where(layout.rel == layout.tile_r,
                       identity_for(combiner, dtype), vals)


def plain(layout, vals, combiner):
    from repro_torch.kernels.edge_gather import segment_combine_plain
    return segment_combine_plain(layout.window_id, layout.rel, vals,
                                 combiner=combiner, tile_e=layout.tile_e,
                                 tile_r=layout.tile_r,
                                 num_segments=layout.num_segments)


def compare(torch, got, want, combiner, mass=None) -> float:
    """Max |kernel - plain| (0 where both hold the same value, infinities
    included); raises beyond the tolerance. float32 add: rtol = atol =
    1e-5, or, where ``mass`` (the rows' sums of |value|) is given,
    1e-5 * mass + 1e-5: two orders of summing tens of thousands of terms
    of both signs differ by the rounding of the terms, not of the sum."""
    if combiner == "add" and got.dtype == torch.float32:
        if mass is None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        elif not bool(((got - want).abs() <= 1e-5 * mass + 1e-5).all()):
            raise AssertionError("float32 add beyond 1e-5 of the rows' "
                                 "absolute mass")
    elif not torch.equal(got, want):
        raise AssertionError(f"{combiner}/{got.dtype}: "
                             f"{int((got != want).sum())} rows differ")
    if not got.numel():
        return 0.0
    diff = (got.double() - want.double()).abs()
    return float(torch.where(got == want, 0.0, diff).max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        entry = "?"
        for line in _build.log_of(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log("build", library=name, entry=entry,
                    ptxas=repr(line.strip()))
    log("build", libraries=len(libs),
        seconds=round(time.perf_counter() - t0, 3),
        dynamic_smem_per_block=f"{TILE_R * 4}B (tile_r={TILE_R} x 4 B)")


def phase_host():
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    t0 = time.perf_counter()
    g = G.rmat(SCALE, EDGE_FACTOR, seed=GRAPH_SEED,
               weighted=True).symmetrized()
    t1 = time.perf_counter()
    pg = PT.partition_graph(g, PARTS, method="greedy")
    t2 = time.perf_counter()
    log("host", graph=f"rmat{SCALE}-ef{EDGE_FACTOR}-sym",
        vertices=g.num_vertices, edges=g.num_edges, parts=PARTS,
        v_max=pg.v_max, e_in_max=pg.e_in_max,
        graph_s=round(t1 - t0, 3), partition_s=round(t2 - t1, 3))
    return g, pg


def phase_sweep(torch, full_layout, device) -> float:
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import build_layout
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    layouts = []
    for n_edges, n_seg, tile_e, tile_r in SWEEP_SHAPES:
        seg = np.sort(rng.integers(0, n_seg, size=n_edges))
        layouts.append(build_layout(seg, n_seg, tile_e=tile_e,
                                    tile_r=tile_r).to(device))
    layouts.append(full_layout)
    max_err, checks = 0.0, 0
    for layout in layouts:
        for combiner in COMBINERS:
            for dtype in (torch.float32, torch.int32):
                for batch in (1, BATCH):
                    vals = lane_values(torch, layout, combiner, dtype,
                                       batch, gen)
                    if batch == 1:
                        vals = vals[0]
                    got = ops.segment_combine_layout(vals, layout, combiner)
                    torch.cuda.synchronize()
                    want = plain(layout, vals, combiner)
                    mass = None
                    if layout is full_layout and combiner == "add":
                        mass = plain(layout, vals.abs(), "add")
                    torch.cuda.synchronize()
                    max_err = max(max_err, compare(torch, got, want,
                                                   combiner, mass))
                    checks += 1
    log("sweep", checks=checks, max_abs_err=max_err,
        full_width_lanes=full_layout.rel.numel(),
        full_width_windows=full_layout.tile_start.numel() - 1)
    return max_err


def validate_bfs(torch, g, parent, root: int, supersteps: int,
                 messages: int, device) -> int:
    """graph500's BFS checks, on the card: the root is its own parent;
    unreached vertices have parent -1; every other parent edge is an edge
    of the graph; the parent pointers form a tree rooted at ``root``
    (pointer jumping reaches the root), so parent level = level - 1;
    every edge joins vertices whose levels differ by at most one, or two
    unreached ones. Also: supersteps = depth + 1 and messages = edges out
    of reached vertices. Returns the depth."""
    V = g.num_vertices
    par = torch.as_tensor(parent, device=device, dtype=torch.int64)
    src = torch.as_tensor(g.src, device=device, dtype=torch.int64)
    dst = torch.as_tensor(g.dst, device=device, dtype=torch.int64)
    if int(par[root]) != root:
        raise AssertionError("root is not its own parent")
    if bool(((par < -1) | (par >= V)).any()):
        raise AssertionError("parent out of range")
    reached = par >= 0
    ids = torch.arange(V, device=device)
    child = reached & (ids != root)
    keys = torch.sort(src * V + dst).values
    want = par[child] * V + ids[child]
    pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    if not bool((keys[pos] == want).all()):
        raise AssertionError("a parent edge is not an edge of the graph")
    anc = torch.where(reached, par, ids)
    depth = child.to(torch.int64)
    for _ in range(max(1, V.bit_length()) + 1):
        depth = depth + depth[anc]
        anc = anc[anc]
    if not bool((anc[reached] == root).all()):
        raise AssertionError("parent pointers do not form a tree at root")
    if not bool((depth[par[child]] == depth[child] - 1).all()):
        raise AssertionError("parent level != level - 1")
    if not bool((reached[src] == reached[dst]).all()):
        raise AssertionError("an edge leaves the reached component")
    both = reached[src]
    if not bool(((depth[src] - depth[dst]).abs()[both] <= 1).all()):
        raise AssertionError("an edge spans more than one level")
    level_max = int(depth[reached].max())
    if supersteps != level_max + 1:
        raise AssertionError(f"supersteps {supersteps} != depth "
                             f"{level_max} + 1")
    if messages != int(both.sum()):
        raise AssertionError("messages != edges out of reached vertices")
    return level_max


def same_result(got, want, name: str) -> None:
    if (got.supersteps, got.messages, got.comm) != (
            want.supersteps, want.messages, want.comm):
        raise AssertionError(
            f"{name}: kernel engine supersteps/messages/comm "
            f"{got.supersteps}/{got.messages}/{got.comm} != ref "
            f"{want.supersteps}/{want.messages}/{want.comm}")
    for k in want.state:
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=PAGERANK_RTOL,
                                       atol=PAGERANK_ATOL)
        elif not np.array_equal(got.state[k], want.state[k]):
            raise AssertionError(f"{name}: state[{k!r}] differs from ref")


def phase_main(torch, g, pg, kernel_engine, ref_engine, roots):
    """Run the main path through the kernel engine with the launch count
    from 0; check each run; return the launch count of the whole path."""
    from repro_torch.kernels import edge_gather
    runs = [
        ("bfs", "run", {"root": int(roots[0])}, 1),
        ("bfs", "run_batch", {"root": roots}, 1),
        ("wcc", "run", {}, 1),
        ("pagerank", "run", {}, 1),
        ("sssp", "run", {"root": int(roots[0])}, 2),
    ]
    results = []
    kernel_engine("bfs").run(root=int(roots[0]))  # warm-up, untimed
    torch.cuda.synchronize()
    edge_gather.launches = 0
    for name, entry, kwargs, calls in runs:
        eng = kernel_engine(name)
        before = edge_gather.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(eng, entry)(**kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = edge_gather.launches - before
        outs = out if isinstance(out, list) else [out]
        steps = max(r.supersteps for r in outs)
        messages = sum(r.messages for r in outs)
        log("main", algorithm=name, entry=entry, queries=len(outs),
            supersteps=steps, messages=messages,
            wire_words=sum(r.comm["wire_words"] for r in outs),
            wall_s=round(wall, 6), teps=round(messages / wall),
            launches=launched,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        if launched != steps * calls:
            raise AssertionError(f"{name} {entry}: {launched} launches for "
                                 f"{steps} supersteps x {calls} calls")
        results.append((name, entry, kwargs, outs))
    total = edge_gather.launches
    log("main", launches_total=total)

    for name, entry, kwargs, outs in results:
        want = getattr(ref_engine(name), entry)(**kwargs)
        want = want if isinstance(want, list) else [want]
        for got, ref in zip(outs, want):
            same_result(got, ref, name)
        if name == "bfs":
            for r, res in zip(np.atleast_1d(kwargs["root"]), outs):
                depth = validate_bfs(torch, g, res.state["parent"], int(r),
                                     res.supersteps, res.messages,
                                     kernel_engine(name).device)
                log("check", algorithm="bfs", entry=entry, root=int(r),
                    graph500="ok", depth=depth)
        log("check", algorithm=name, entry=entry, versus_ref="ok")
    return total


def phase_timing(torch, layout, device):
    """Kernel, plain-version and scatter_reduce_ times at the main path's
    full-width layout, for the main path's key combines."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import REDUCE, identity_for
    gen = torch.Generator(device=device).manual_seed(1)
    rows = (layout.window_id.to(torch.int64).repeat_interleave(layout.tile_e)
            * layout.tile_r + layout.rel)
    rows = torch.where(layout.rel < layout.tile_r, rows,
                       layout.num_segments).clamp(max=layout.num_segments)
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    records = []
    for combiner, dname, used_by in TIMED:
        dtype = dtypes[dname]
        for batch in (1, BATCH):
            vals = lane_values(torch, layout, combiner, dtype, batch, gen)
            index = rows.expand(vals.shape)
            out = torch.full((batch, layout.num_segments + 1),
                             identity_for(combiner, dtype), dtype=dtype,
                             device=device)
            ms = event_ms(torch, lambda: ops.segment_combine_layout(
                vals, layout, combiner), TIMING_ITERS)
            plain_ms = event_ms(torch, lambda: plain(layout, vals, combiner),
                                10)
            library_ms = event_ms(torch, lambda: out.scatter_reduce_(
                1, index, vals, REDUCE[combiner], include_self=True),
                TIMING_ITERS)
            rec = {"combiner": combiner, "dtype": dname, "batch": batch,
                   "used_by": used_by, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms(layout, batch),
                   "library_ms": library_ms}
            rec["bound_share"] = rec["bound_ms"] / ms
            log("timing", **{k: v for k, v in rec.items() if k != "used_by"})
            records.append(rec)
            del vals, index, out
    return records


def drive(torch, device):
    """Phases 3-7. Returns the kernel's record for the JSON line."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine import Engine

    g, pg = phase_host()

    kernel_engines, ref_engines = {}, {}

    def engine(cache, backend):
        def get(name):
            if name not in cache:
                t0 = time.perf_counter()
                cache[name] = Engine(ALG.ALGORITHMS[name](), pg,
                                     backend=backend, tile_e=TILE_E,
                                     tile_r=TILE_R, device=device)
                log("host", engine=name, backend=backend,
                    build_s=round(time.perf_counter() - t0, 3),
                    device_nbytes=cache[name].device_nbytes)
            return cache[name]
        return get

    kernel_engine = engine(kernel_engines, "kernel")
    ref_engine = engine(ref_engines, "ref")
    layout = kernel_engine("bfs")._layout

    max_err = phase_sweep(torch, layout, device)

    deg = g.out_degrees()
    rng = np.random.default_rng(GRAPH_SEED)
    roots = rng.choice(np.flatnonzero(deg > 0), size=BATCH, replace=False)
    launches = phase_main(torch, g, pg, kernel_engine, ref_engine, roots)

    phase_profile(torch, kernel_engine, int(roots[0]))
    records = phase_timing(torch, layout, device)
    head = records[0]  # int32 min at B=1: the BFS/WCC key combine
    return {**KERNEL, "launches": launches, "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "variants": records}


def phase_profile(torch, kernel_engine, root: int) -> None:
    """Where a superstep's device time goes: torch.profiler over one BFS
    run and one PageRank run, the busiest operators by self device time,
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    for name, kwargs in (("bfs", {"root": root}), ("pagerank", {})):
        eng = kernel_engine(name)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = eng.run(**kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # Device-side events only (the kernels and copies themselves): the
        # operators' own device totals would count each kernel twice.
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        busy = sum(dev_us(e) for e in kernels) / 1e6
        log("profile", algorithm=name, supersteps=res.supersteps,
            wall_s=round(wall, 6), device_busy_s=round(busy, 6),
            idle_share=round(1 - busy / wall, 4),
            device_launches=sum(e.count for e in kernels))
        for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
            log("profile", algorithm=name, kernel=repr(e.key[:100]),
                calls=e.count, self_device_ms=round(dev_us(e) / 1e3, 4))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", kind=repr(kind), count=torch.cuda.device_count(),
        nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)
    phase_build()
    record = drive(torch, torch.device("cuda"))
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
