#!/usr/bin/env python3
"""Drive the PyTorch port of GraVF-M on one NVIDIA card, and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --kernels  # phases 1-4, 7-9 and 12 only

Phases, in order; any failure exits non-zero:
  1. device : the card's name, the device count, nvidia-smi's name and
              power limit. Without CUDA the script exits 2 at once.
  2. build  : nvcc builds every kernel of src/repro_torch/kernels/csrc;
              one line per entry: registers, spills, static shared memory
              (-Xptxas -v) and the dynamic shared memory of its launch.
  3. host   : graph500's R-MAT at scale 20 (edge factor 16, weighted,
              symmetrized), greedy 4-way partition, the engines' layouts.
  4. sweep  : the segment-combine kernel against its plain PyTorch version
              on the card: {add, min, max} x {float32, int32} over the
              shapes of tests/test_kernels.py, a layout with a window of
              ~530 tiles (cut into many work items) and the full-width
              layout, at B = 1, 3, 8 and 17 (below, at and above the 8
              queries a block folds together). Exact for min, max and
              int32 add; float32 add at rtol = atol = 1e-5, and at the
              full width (hub rows of 64k terms of both signs) within
              1e-5 of each row's sum of |value|.
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
              kernel path) and the bytes bound at 3.35 TB/s; each row with
              its launches on phase 5's path and launches x (ms -
              bound_ms), the time they lose against the bound.
  8. shard host : build_shard_data on the same graph (4 shards): the
              stacked CSC lanes and the combined exchange's lanes.
  9. shard sweep: the stacked kernel (K2) against its plain version, as
              in phase 4, over small stacks (an empty shard, windows that
              own no tile, hub rows, a window cut into many work items)
              and the two full-width stacks, at phase 4's batch sizes.
 10. shard  : ShardEngine(mesh=LocalMesh(4, cuda)) for the allgather,
              unicast and combined exchanges (BFS run and the 8-root
              run_batch, WCC, PageRank 30, SSSP), K2's launch count set to
              0 just before and read just after; each run against the
              backend="ref" shard engine on the same exchange and against
              phase 5's one-device engine, BFS by graph500's rules; the
              wire words of each exchange beside the average degree.
 11. shard profile: phase 6 for each exchange.
 12. shard timing: K2 at the two full-width stacks, as in phase 7, with
              the launches of phase 10's path.
Then one JSON line with both kernels' numbers, the nvidia-smi line, and
the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import re
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
TIMING_ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PAGERANK_RTOL, PAGERANK_ATOL = 1e-4, 1e-9
KERNEL = {
    "name": "segment_combine",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
    "replaces": "src/repro/kernels/edge_gather.py:99",
}
KERNEL2 = {
    "name": "segment_combine_windows",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/segment_combine.cu",
    "replaces": "src/repro/kernels/edge_gather.py:136",
}
EXCHANGES = ("allgather", "unicast", "combined")
# Small stacks for K2's sweep: (edges of each shard, segments, tile_e,
# tile_r): an empty shard, windows that own no tile, hub rows.
# The last stack and the last shape put ~17,000 lanes of 32 in one window:
# ~530 tiles, so the window is cut into many work items.
SWEEP_STACKS = [((300, 0, 45, 1), 130, 32, 16),
                ((0, 500, 30, 2000), 2000, 64, 32),
                ((4096, 700, 0, 64), 64, 256, 256),
                ((20000, 0, 3000, 64), 300, 32, 256)]
SWEEP_SHAPES = [(0, 16, 32, 16), (1, 1, 32, 16), (500, 64, 64, 32),
                (500, 2000, 64, 32), (777, 130, 128, 64),
                (2048, 64, 256, 256), (20000, 300, 32, 256)]
# Batch sizes of the sweeps: one query, a batch below QB (the queries a
# block folds together, at most 8), the main path's batch, and one that
# leaves a ragged last chunk.
SWEEP_BATCHES = (1, 3, BATCH, 17)
COMBINERS = ("add", "min", "max")
# The main path's key combines: (combiner, dtype name, who calls it).
TIMED = [("min", "int32", "BFS/WCC key, SSSP carry"),
         ("min", "float32", "SSSP key"),
         ("add", "float32", "PageRank")]
# The shard path's K2 combines: the allgather exchange's receiver folds
# (as K1's) and the combined exchange's source folds, which add the
# send_act max to each superstep.
TIMED_STACKED = {"csc": TIMED,
                 "combined": TIMED + [("max", "int32", "send_act")]}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, iters: int, warmup: int = 3,
             rounds: int = TIMING_ROUNDS) -> float:
    """Milliseconds of one ``fn``: the median over ``rounds`` of the mean
    over ``iters`` launches (CUDA events), so one stalled round does not
    move the number."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))


def bound_ms(layout, batch: int) -> float:
    """Least time for the combine: the bytes it must move (rel and
    tile_start read once, vals once per query, the output written once
    per query) over the card's memory rate. One fold per lane per query
    at float32's 67 TFLOP/s is three orders of magnitude less."""
    lanes = layout.rel.numel()
    nbytes = 4 * (lanes + layout.tile_start.numel()
                  + batch * (lanes + layout.num_segments))
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_ms_stacked(layout, batch: int) -> float:
    """K2's least time: ``bound_ms`` over the lanes the shards own (the
    tiles a shorter shard is padded with are never read)."""
    lanes = int(layout.tile_start[:, -1].sum()) * layout.tile_e
    rows = layout.rel.shape[0] * layout.num_segments
    nbytes = 4 * (lanes + layout.tile_start.numel() + batch * (lanes + rows))
    return nbytes / HBM_BYTES_PER_S * 1e3


def lane_values(torch, layout, combiner, dtype, batch, gen):
    """Random (batch, *rel.shape) values with the identity in padding
    lanes."""
    from repro_torch.kernels.ref import identity_for
    shape = (batch,) + tuple(layout.rel.shape)
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


def plain_stacked(layout, vals, combiner):
    from repro_torch.kernels.edge_gather import segment_combine_windows_plain
    return segment_combine_windows_plain(
        layout.tile_start, layout.rel, vals, combiner=combiner,
        tile_e=layout.tile_e, tile_r=layout.tile_r,
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

ENTRY_DTYPE = {"f": "float32", "i": "int32"}


def entry_label(mangled: str) -> str:
    """``segment_combine_kernel<T, OP, QB>``'s template arguments, from its
    mangled name, as "int32 min QB=8"; other names as they are."""
    m = re.search(r"kernelI([fi])Li(\d)ELi(\d+)E", mangled)
    if not m:
        return mangled
    return (f"{ENTRY_DTYPE[m.group(1)]} {COMBINERS[int(m.group(2))]} "
            f"QB={m.group(3)}")


def phase_build() -> None:
    """Build every kernel; one line per entry with its registers, spills,
    static shared memory and the dynamic shared memory a launch at
    tile_r = TILE_R gives it (its QB x tile_r accumulators)."""
    from repro_torch.kernels import _build, edge_gather
    t0 = time.perf_counter()
    libs = _build.build_all()
    smem = edge_gather._kernel()[1]
    for name in libs:
        entry, spills = "?", "?"
        for line in _build.log_of(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line:
                label = entry_label(entry)
                regs = re.search(r"Used (\d+) registers", line).group(1)
                static = re.search(r"(\d+) bytes smem", line)
                qb = re.search(r"QB=(\d+)", label)
                log("build", library=name, entry=repr(label), registers=regs,
                    static_smem_bytes=static.group(1) if static else 0,
                    dynamic_smem_bytes=(smem(int(qb.group(1)), TILE_R)
                                        if qb else "-"),
                    spills=repr(spills))
    log("build", libraries=len(libs),
        seconds=round(time.perf_counter() - t0, 3))


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
                for batch in SWEEP_BATCHES:
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


def dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def combines_of(kernel, exchange: str = "allgather"):
    """The (combiner, dtype) of each kernel launch a superstep makes: the
    key, `got` unless the kernel derives it from the identity, and the
    carry; the combined exchange also folds send_act (int32 max) at the
    source and derives `got` from it. Unicast launches none."""
    if exchange == "unicast":
        return []
    calls = [(kernel.combiner, dtype_name(kernel.msg_dtype))]
    if exchange == "combined":
        calls.append(("max", "int32"))
    elif not kernel.got_from_identity:
        calls.append(("max", "int32"))
    if kernel.carry_dtype is not None:
        calls.append(("min", dtype_name(kernel.carry_dtype)))
    return calls


def row_launches(runs):
    """Launches a timing row stands for on the main path: ``runs`` holds
    (combines, batch, supersteps) of each run; a row is (combiner, dtype,
    batch), a run's batch is 1 for `run` and 8 for `run_batch`."""
    counts = {}
    for calls, batch, steps in runs:
        for combiner, dname in calls:
            key = (combiner, dname, min(batch, BATCH))
            counts[key] = counts.get(key, 0) + steps
    return counts


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
    from 0; check each run; return the launch count of the whole path,
    the runs and the launches of each timing row (``row_launches``)."""
    from repro_torch.kernels import edge_gather
    runs = [
        ("bfs", "run", {"root": int(roots[0])}),
        ("bfs", "run_batch", {"root": roots}),
        ("wcc", "run", {}),
        ("pagerank", "run", {}),
        ("sssp", "run", {"root": int(roots[0])}),
    ]
    results, counted = [], []
    kernel_engine("bfs").run(root=int(roots[0]))  # warm-up, untimed
    torch.cuda.synchronize()
    edge_gather.launches = 0
    for name, entry, kwargs in runs:
        eng = kernel_engine(name)
        calls = combines_of(eng.kernel)
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
        if launched != steps * len(calls):
            raise AssertionError(f"{name} {entry}: {launched} launches for "
                                 f"{steps} supersteps x {calls}")
        results.append((name, entry, kwargs, outs))
        counted.append((calls, len(outs), steps))
    total = edge_gather.launches
    log("main", launches_total=total)
    rows = row_launches(counted)

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
    return total, results, rows


def with_launches(rec, rows) -> dict:
    """A timing row with its launches on the main path and the time they
    lose against the bound, launches x (ms - bound_ms)."""
    n = None if rows is None else rows.get(
        (rec["combiner"], rec["dtype"], rec["batch"]), 0)
    rec["launches"] = n
    rec["loss_ms"] = None if n is None else n * (rec["ms"] - rec["bound_ms"])
    return rec


def phase_timing(torch, layout, device, rows=None):
    """Kernel, plain-version and scatter_reduce_ times at the main path's
    full-width layout, for the main path's key combines, with each row's
    launches on the main path (``rows``, from phase 5)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import REDUCE, identity_for
    gen = torch.Generator(device=device).manual_seed(1)
    row_of = (layout.window_id.to(torch.int64).repeat_interleave(
        layout.tile_e) * layout.tile_r + layout.rel)
    row_of = torch.where(layout.rel < layout.tile_r, row_of,
                         layout.num_segments).clamp(max=layout.num_segments)
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    records = []
    for combiner, dname, used_by in TIMED:
        dtype = dtypes[dname]
        for batch in (1, BATCH):
            vals = lane_values(torch, layout, combiner, dtype, batch, gen)
            index = row_of.expand(vals.shape)
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
            with_launches(rec, rows)
            log("timing", **{k: v for k, v in rec.items() if k != "used_by"})
            records.append(rec)
            del vals, index, out
    return records


def window_spread(tag: str, tile_start) -> None:
    """Tiles a (shard, window) owns, over a layout's windows: the spread
    the work list's cut is chosen from."""
    tiles = np.diff(tile_start.cpu().numpy().reshape(-1, tile_start.shape[-1]),
                    axis=1).ravel()
    p50, p90, p99 = np.percentile(tiles, [50, 90, 99])
    log("layout", layout=tag, windows=tiles.size, tiles=int(tiles.sum()),
        empty=int((tiles == 0).sum()), p50=p50, p90=p90, p99=p99,
        max=int(tiles.max()))


def drive(torch, device, full: bool = True):
    """Phases 3-12 (``full=False``: only the host, sweep and timing
    phases). Returns the kernels' records for the JSON line."""
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
    window_spread("engine", layout.tile_start)

    max_err = phase_sweep(torch, layout, device)

    deg = g.out_degrees()
    rng = np.random.default_rng(GRAPH_SEED)
    roots = rng.choice(np.flatnonzero(deg > 0), size=BATCH, replace=False)
    launches, engine_runs, rows = None, [], None
    if full:
        launches, engine_runs, rows = phase_main(torch, g, pg, kernel_engine,
                                                 ref_engine, roots)
        phase_profile(torch, kernel_engine, int(roots[0]))
    records = phase_timing(torch, layout, device, rows)
    kernel_engines.clear()
    ref_engines.clear()
    del layout
    gc.collect()  # an engine and its superstep program form a cycle
    head = records[0]  # int32 min at B=1: the BFS/WCC key combine
    k1 = {**KERNEL, "launches": launches, "max_abs_err": max_err,
          "ms": head["ms"], "plain_ms": head["plain_ms"],
          "bound_ms": head["bound_ms"], "bound_by": "bytes",
          "library_ms": head["library_ms"], "variants": records}
    return [k1, drive_shard(torch, device, g, pg, roots, engine_runs, full)]


def drive_shard(torch, device, g, pg, roots, engine_runs, full=True):
    """Phases 8-12. Returns K2's record for the JSON line."""
    from repro_torch.core.engine_shardmap import build_shard_data
    t0 = time.perf_counter()
    data = build_shard_data(pg, tile_e=TILE_E, tile_r=TILE_R)
    meta = data[1]
    log("shard_host", build_shard_data_s=round(time.perf_counter() - t0, 3),
        n_tiles=meta.n_tiles, n_windows=meta.n_windows,
        comb_max=meta.comb_max, comb_tiles=meta.comb_tiles,
        comb_windows=meta.comb_windows, e_pair_max=meta.e_pair_max)
    engine = shard_engines(torch, device, pg, data)
    stacks = {"csc": engine("allgather", "bfs", "kernel")._csc,
              "combined": engine("combined", "bfs", "kernel")._comb}
    for name, stack in stacks.items():
        window_spread(name, stack.tile_start)
    max_err = phase_sweep_stacked(torch, stacks, device)
    launches, rows = None, None
    if full:
        launches, rows = phase_shard(torch, device, g, engine, roots,
                                     engine_runs)
        for exchange in EXCHANGES:
            phase_profile(torch,
                          lambda name: engine(exchange, name, "kernel"),
                          int(roots[0]), exchange=exchange)
    records = phase_timing_stacked(torch, stacks, device, rows)
    head = records[0]  # CSC int32 min at B=1: allgather's BFS/WCC key
    return {**KERNEL2, "launches": launches, "max_abs_err": max_err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "variants": records}


def shard_engines(torch, device, pg, data):
    """engine(exchange, algorithm, backend): a ShardEngine on all four
    shards of the card, over the one host build ``data``; the last one
    built of each (exchange, backend) is kept."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core.engine_shardmap import ShardEngine
    from repro_torch.core.mesh import LocalMesh
    mesh = LocalMesh(PARTS, device)
    kept = {}

    def engine(exchange, name, backend):
        key = (exchange, backend)
        if key in kept and kept[key].kernel.name == name:
            return kept[key]
        if kept.pop(key, None) is not None:
            gc.collect()  # an engine and its superstep program form a cycle
        t0 = time.perf_counter()
        eng = ShardEngine(ALG.ALGORITHMS[name](), pg, mesh=mesh,
                          exchange=exchange, backend=backend, tile_e=TILE_E,
                          tile_r=TILE_R, shard_data=data)
        log("shard_host", exchange=exchange, engine=name, backend=backend,
            build_s=round(time.perf_counter() - t0, 3),
            device_nbytes=eng.device_nbytes)
        kept[key] = eng
        return eng
    return engine


def phase_sweep_stacked(torch, full_stacks, device) -> float:
    """K2 against its plain version on the card; phase 4's tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import (build_layout, stack_layouts,
                                            stacked_layout)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(2)
    stacks = []
    for sizes, n_seg, tile_e, tile_r in SWEEP_STACKS:
        st, _, _ = stack_layouts([build_layout(
            np.sort(rng.integers(0, n_seg + 1, size=n)), n_seg,
            tile_e=tile_e, tile_r=tile_r) for n in sizes])
        stacks.append(stacked_layout(
            torch.as_tensor(st["tile_start"], device=device),
            torch.as_tensor(st["rel"], device=device), tile_e, tile_r,
            n_seg))
    stacks += list(full_stacks.values())
    max_err, checks = 0.0, 0
    for layout in stacks:
        full = any(layout is f for f in full_stacks.values())
        for combiner in COMBINERS:
            for dtype in (torch.float32, torch.int32):
                for batch in SWEEP_BATCHES:
                    vals = lane_values(torch, layout, combiner, dtype,
                                       batch, gen)
                    if batch == 1:
                        vals = vals[0]
                    got = ops.segment_combine_stacked(vals, layout, combiner)
                    torch.cuda.synchronize()
                    want = plain_stacked(layout, vals, combiner)
                    mass = None
                    if full and combiner == "add":
                        mass = plain_stacked(layout, vals.abs(), "add")
                    torch.cuda.synchronize()
                    max_err = max(max_err, compare(torch, got, want,
                                                   combiner, mass))
                    checks += 1
                    del vals, got, want, mass
    log("shard_sweep", checks=checks, max_abs_err=max_err,
        **{f"{k}_lanes": tuple(v.rel.shape) for k, v in full_stacks.items()},
        **{f"{k}_windows": v.tile_start.shape[1] - 1
           for k, v in full_stacks.items()})
    return max_err


def same_as_engine(got, want, name: str) -> None:
    """A shard-engine run against the one-device engine's: states,
    supersteps and messages (a per-query state leaf is held once per shard
    by the shard engine)."""
    if (got.supersteps, got.messages) != (want.supersteps, want.messages):
        raise AssertionError(f"{name}: shard engine supersteps/messages "
                             f"{got.supersteps}/{got.messages} != engine "
                             f"{want.supersteps}/{want.messages}")
    for k, v in want.state.items():
        v = np.broadcast_to(v, got.state[k].shape)
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], v, rtol=PAGERANK_RTOL,
                                       atol=PAGERANK_ATOL)
        elif not np.array_equal(got.state[k], v):
            raise AssertionError(f"{name}: state[{k!r}] differs from the "
                                 "one-device engine")


def phase_shard(torch, device, g, engine, roots, engine_runs) -> int:
    """The shard path: every exchange's runs through the kernel shard
    engine with K2's launch count from 0; then each run against the
    backend="ref" shard engine and the one-device engine. Returns the
    launch count of the whole path and the launches of each stack's
    timing rows (``row_launches``)."""
    from repro_torch.kernels import edge_gather
    for exchange in EXCHANGES:  # warm-up, untimed
        engine(exchange, "bfs", "kernel").run(root=int(roots[0]))
    torch.cuda.synchronize()
    edge_gather.windows_launches = 0
    results, words = [], {}
    # Launches of each stack's timing rows: the allgather exchange folds
    # over the CSC stack, the combined exchange over the combined stack.
    counted = {"allgather": [], "unicast": [], "combined": []}
    for exchange in EXCHANGES:
        for name, entry, kwargs, _ in engine_runs:
            eng = engine(exchange, name, "kernel")
            before = edge_gather.windows_launches
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(eng, entry)(**kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = edge_gather.windows_launches - before
            outs = out if isinstance(out, list) else [out]
            steps = max(r.supersteps for r in outs)
            messages = sum(r.messages for r in outs)
            wire = outs[0].comm["wire_words"]
            words[exchange, name, entry] = wire
            log("shard", exchange=exchange, algorithm=name, entry=entry,
                queries=len(outs), supersteps=steps, messages=messages,
                wire_words=wire, wall_s=round(wall, 6),
                teps=round(messages / wall), launches=launched,
                max_memory_allocated=torch.cuda.max_memory_allocated())
            calls = combines_of(eng.kernel, exchange)
            if launched != steps * len(calls):
                raise AssertionError(
                    f"{exchange} {name} {entry}: {launched} launches for "
                    f"{steps} supersteps x {calls}")
            results.append((exchange, name, entry, kwargs, outs))
            counted[exchange].append((calls, len(outs), steps))
    total = edge_gather.windows_launches
    log("shard", launches_total=total)
    rows = {"csc": row_launches(counted["allgather"]),
            "combined": row_launches(counted["combined"])}

    avg_degree = g.num_edges / g.num_vertices
    for name, entry, _, _ in engine_runs:
        uni = words["unicast", name, entry]
        comb = words["combined", name, entry]
        log("shard", algorithm=name, entry=entry,
            wire_words_allgather=words["allgather", name, entry],
            wire_words_unicast=uni, wire_words_combined=comb,
            unicast_over_combined=uni / comb, average_degree=avg_degree)

    by_run = {(name, entry): outs for name, entry, _, outs in engine_runs}
    for exchange, name, entry, kwargs, outs in results:
        want = getattr(engine(exchange, name, "ref"), entry)(**kwargs)
        want = want if isinstance(want, list) else [want]
        for got, ref, one in zip(outs, want, by_run[name, entry]):
            same_result(got, ref, name)
            same_as_engine(got, one, name)
        if name == "bfs":
            for r, res in zip(np.atleast_1d(kwargs["root"]), outs):
                validate_bfs(torch, g, res.state["parent"], int(r),
                             res.supersteps, res.messages, device)
        log("check", exchange=exchange, algorithm=name, entry=entry,
            versus_ref="ok", versus_engine="ok",
            graph500="ok" if name == "bfs" else "-")
    return total, rows


def phase_timing_stacked(torch, stacks, device, rows=None):
    """K2's kernel, plain-version and scatter_reduce_ times at the two
    full-width stacks, for the shard path's combines, with each row's
    launches on the shard path (``rows[stack]``, from phase 10)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import REDUCE, identity_for
    gen = torch.Generator(device=device).manual_seed(3)
    dtypes = {"float32": torch.float32, "int32": torch.int32}
    records = []
    for stack, layout in stacks.items():
        n_tiles = layout.rel.shape[1] // layout.tile_e
        tile = torch.arange(n_tiles, dtype=torch.int32, device=device)
        window = torch.searchsorted(
            layout.tile_start[:, 1:].contiguous(),
            tile.expand(layout.rel.shape[0], -1).contiguous(),
            right=True).repeat_interleave(layout.tile_e, dim=1)
        row_of = torch.where(
            (layout.rel < layout.tile_r)
            & (window < layout.tile_start.shape[1] - 1),
            window * layout.tile_r + layout.rel, layout.num_segments)
        row_of = row_of.clamp(max=layout.num_segments)
        del window
        for combiner, dname, used_by in TIMED_STACKED[stack]:
            dtype = dtypes[dname]
            for batch in (1, BATCH):
                vals = lane_values(torch, layout, combiner, dtype, batch,
                                   gen)
                index = row_of.expand(vals.shape)
                out = torch.full(vals.shape[:-1] + (layout.num_segments + 1,),
                                 identity_for(combiner, dtype), dtype=dtype,
                                 device=device)
                ms = event_ms(torch, lambda: ops.segment_combine_stacked(
                    vals, layout, combiner), TIMING_ITERS)
                plain_ms = event_ms(torch, lambda: plain_stacked(
                    layout, vals, combiner), 10)
                library_ms = event_ms(torch, lambda: out.scatter_reduce_(
                    2, index, vals, REDUCE[combiner], include_self=True),
                    TIMING_ITERS)
                rec = {"stack": stack, "combiner": combiner, "dtype": dname,
                       "batch": batch, "used_by": used_by, "ms": ms,
                       "plain_ms": plain_ms,
                       "bound_ms": bound_ms_stacked(layout, batch),
                       "library_ms": library_ms}
                rec["bound_share"] = rec["bound_ms"] / ms
                with_launches(rec, None if rows is None else rows[stack])
                log("shard_timing",
                    **{k: v for k, v in rec.items() if k != "used_by"})
                records.append(rec)
                del vals, index, out
    return records


def phase_profile(torch, kernel_engine, root: int, **label) -> None:
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
        log("profile", **label, algorithm=name, supersteps=res.supersteps,
            wall_s=round(wall, 6), device_busy_s=round(busy, 6),
            idle_share=round(1 - busy / wall, 4),
            device_launches=sum(e.count for e in kernels))
        for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
            log("profile", **label, algorithm=name,
                kernel=repr(e.key[:100]), calls=e.count,
                self_device_ms=round(dev_us(e) / 1e3, 4))


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
    full = "--kernels" not in sys.argv[1:]
    records = drive(torch, torch.device("cuda"), full)
    print(json.dumps({"kernels": records}), flush=True)
    if not full:
        return 0
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
