"""The port on the card: the CUDA segment-combine kernels (K1, and K2 over
stacked per-shard layouts) against their plain versions, the engines'
kernel paths against their oracle paths, the one-device engine's
superstep graph (bit-identical to its eager loop, its counters, a
recapture after upload, two threads on one engine, its peak and held
memory), and the query service on the card: its answers (on the eager
loop), an offloaded engine's dispatch (still K1 on the card)
and bucketed and continuous dispatch on one engine at the same time; the
shard engine's five exchanges in both schedules, its lane stepper, an
offloaded shard engine (still K2 on the card) and a shard class of the
service; the LM serving path (the reduced configs of every family, the
MoE router's choices, the enc-dec decode) on the card against the CPU,
its prefill/decode consistency, and its device rules; one train step of
reduced configs on the card against the CPU, and a checkpoint round trip
from the card.

Marked ``gpu``; each test decides inside itself whether there is a card
and skips without one. The file imports no JAX, so it runs on a machine
that has only PyTorch: ``python -m pytest -m gpu tests/test_torch_cuda.py``.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import obs
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
from repro_torch.core.engine_shardmap import EXCHANGES, ShardEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch.kernels import edge_gather, ops
from repro_torch.kernels.layout import (WORK_TILES, StackedLayout,
                                       build_layout, stack_layouts,
                                       stacked_layout)
from repro_torch import configs as LMC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as LML
from repro_torch.models import lm as LMM
from repro_torch.serve import engine as LMS
from repro_torch.service import GraphQueryService, QueryRequest

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
COMBINER_DTYPES = [(c, d) for c in ("add", "min", "max")
                   for d in (np.float32, np.int32)]
SHAPES = [(0, 16, 32, 16), (1, 1, 32, 16), (500, 64, 64, 32),
          (500, 2000, 64, 32), (777, 130, 128, 64), (2048, 64, 256, 256)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
def test_cuda_kernel_matches_plain(combiner, dtype):
    _need_card()
    rng = np.random.default_rng(2)
    for n_edges, n_segments, tile_e, tile_r in SHAPES:
        for batch in ((), (8,)):
            seg = np.sort(rng.integers(0, n_segments, size=n_edges))
            if np.issubdtype(dtype, np.floating):
                vals = rng.standard_normal(batch + (n_edges,)).astype(dtype)
            else:
                vals = rng.integers(-1000, 1000, batch + (n_edges,))
                vals = vals.astype(dtype)
            tl = build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
            vp = np.full(batch + (tl.num_lanes,),
                         edge_gather.identity_for(combiner, torch.from_numpy(
                             vals).dtype), dtype)
            vp[..., tl.lane_of_edge] = vals
            vp = torch.from_numpy(vp)
            want = ops.segment_combine_layout(vp, tl.to("cpu"), combiner)
            before = edge_gather.launches
            got = ops.segment_combine_layout(vp.cuda(), tl.to("cuda"),
                                             combiner)
            torch.cuda.synchronize()
            assert edge_gather.launches == before + 1
            if combiner == "add" and dtype == np.float32:
                torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                           atol=1e-5)
            else:
                assert torch.equal(got.cpu(), want)


def _values(rng, dtype, shape):
    if np.issubdtype(dtype, np.floating):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype))
    return torch.from_numpy(rng.integers(-1000, 1000, shape).astype(dtype))


def _assert_kernel_matches(got, want, combiner, dtype):
    if combiner == "add" and dtype == np.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got.cpu(), want)


# A hub window of ~60 tiles of 32 lanes (more than WORK_TILES, so it is cut
# into several work items) beside sparse windows and windows with no tile.
HUB = (2400, 300, 32, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 8, 17])
@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
def test_cuda_kernel_batches_match_plain(combiner, dtype, batch):
    """B below, at and above the 8 queries a block folds together, over a
    layout with a window cut into several work items."""
    _need_card()
    rng = np.random.default_rng(batch)
    n_edges, n_segments, tile_e, tile_r = HUB
    seg = np.sort((n_segments * rng.random(n_edges) ** 4).astype(np.int64))
    tl = build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    assert np.diff(tl.tile_start).max() > WORK_TILES
    vals = _values(rng, dtype, (batch, tl.num_lanes))
    want = ops.segment_combine_layout(vals, tl.to("cpu"), combiner)
    got = ops.segment_combine_layout(vals.cuda(), tl.to("cuda"), combiner)
    _assert_kernel_matches(got, want, combiner, dtype)
    st, _, _ = stack_layouts([tl, build_layout(seg[:0], n_segments,
                                               tile_e=tile_e, tile_r=tile_r),
                              build_layout(seg[::7], n_segments,
                                           tile_e=tile_e, tile_r=tile_r)])
    vals = _values(rng, dtype, (batch,) + st["rel"].shape)
    tile_start = torch.from_numpy(st["tile_start"])
    rel = torch.from_numpy(st["rel"])
    want = ops.segment_combine_stacked(
        vals, StackedLayout(tile_start, rel, tile_e, tile_r, n_segments),
        combiner)
    got = ops.segment_combine_stacked(
        vals.cuda(), stacked_layout(tile_start.cuda(), rel.cuda(), tile_e,
                                    tile_r, n_segments), combiner)
    _assert_kernel_matches(got, want, combiner, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("combiner", ["add", "min"])
def test_cuda_split_windows_repeat(combiner):
    """A layout whose windows are cut into work items, launched twice on
    the same layout: equal results show each window's arrival counter was
    reset to 0 by the first call."""
    _need_card()
    rng = np.random.default_rng(9)
    seg = np.sort(rng.integers(0, 40, 6000))  # one window, ~190 tiles
    layout = build_layout(seg, 40, tile_e=32, tile_r=64).to("cuda")
    assert int(layout.work.arrivals.numel()) == 1
    assert layout.work.n_slots == -(-layout.window_id.numel() // WORK_TILES)
    vals = _values(rng, np.int32, (5, layout.rel.numel())).cuda()
    first = ops.segment_combine_layout(vals, layout, combiner)
    second = ops.segment_combine_layout(vals, layout, combiner)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert int(layout.work.arrivals.abs().sum()) == 0
    want = ops.segment_combine_layout(vals.cpu(), layout._replace(
        window_id=layout.window_id.cpu(), tile_start=layout.tile_start.cpu(),
        rel=layout.rel.cpu()), combiner)
    assert torch.equal(first.cpu(), want)


@pytest.mark.gpu
def test_cuda_kernel_needs_work_list():
    _need_card()
    layout = build_layout(np.arange(10), 10, tile_e=16, tile_r=8).to("cuda")
    with pytest.raises(ValueError, match="work list"):
        ops.segment_combine_layout(torch.zeros(layout.rel.numel(),
                                               device="cuda"),
                                   layout._replace(work=None), "min")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bfs", "wcc", "sssp", "pagerank"])
def test_cuda_engine_matches_ref(name):
    _need_card()
    g = TG.rmat(10, 8, seed=3, weighted=True).symmetrized()
    pg = TPT.partition_graph(g, 4, pad_multiple=16)
    want = Engine(TA.ALGORITHMS[name](), pg, backend="ref",
                  device="cpu").run()
    before = edge_gather.launches
    got = Engine(TA.ALGORITHMS[name](), pg, device="cuda").run()
    calls = 2 if name == "sssp" else 1
    assert edge_gather.launches - before == calls * got.supersteps
    assert (got.supersteps, got.messages, got.comm) == (
        want.supersteps, want.messages, want.comm)
    for k in want.state:
        if k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=1e-4, atol=1e-9)
        else:
            np.testing.assert_array_equal(got.state[k], want.state[k])


def _engine_pg():
    g = TG.rmat(10, 8, seed=3, weighted=True).symmetrized()
    return TPT.partition_graph(g, 4, pad_multiple=16)


GRAPH_COUNTERS = ("engine.supersteps", "engine.graph_replays",
                  "engine.graph_captures")
ROOTS = np.array([3, 200, 77, 5, 901, 12, 640, 33])


def _graph_counts():
    snap = obs.counters.snapshot()
    return {k: snap.get(k, 0) for k in GRAPH_COUNTERS}


def _grew(before):
    now = _graph_counts()
    return tuple(now[k] - before[k] for k in GRAPH_COUNTERS)


def _call(eng, entry, batch, cap=None):
    if entry == "run":
        kw = {"root": int(ROOTS[0])} if eng.kernel.query_params else {}
        return [eng.run(cap, **kw)]
    return eng.run_batch(cap, root=ROOTS[:batch])


def _same_bits(got, want, name):
    """Equal bits, but for PageRank's ranks: K1's float32 add rounds its
    last bit in the order its atomics land, which varies from launch to
    launch (``csrc/segment_combine.cu``, "Determinism")."""
    assert (got.supersteps, got.messages, got.comm) == (
        want.supersteps, want.messages, want.comm)
    assert set(got.state) == set(want.state)
    for k in want.state:
        assert got.state[k].dtype == want.state[k].dtype
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(got.state[k], want.state[k])


# run at B = 1 for every kernel, run_batch at B = 1, 2, 8 for those that
# take a per-query array
GRAPH_CASES = ([(n, "run", 1) for n in ("bfs", "wcc", "sssp", "pagerank",
                                        "degree")]
               + [(n, "run_batch", b) for n in ("bfs", "sssp")
                  for b in (1, 2, 8)])
CAPS = (None, 2, None)


@pytest.mark.gpu
@pytest.mark.parametrize("name,entry,batch", GRAPH_CASES)
def test_cuda_graphed_engine_matches_ref_and_eager(name, entry, batch):
    """run / run_batch on the card replay one superstep graph: each call
    (to quiescence, stopped at 2 supersteps, again to quiescence) answers
    as the CPU oracle engine does, and as the eager loop on the card (the
    same engine offloaded) bit for bit (:func:`_same_bits`). K1 launches as many times a
    superstep as before; the first superstep runs eagerly and captures,
    every later one is a replay; the eager loop replays nothing."""
    _need_card()
    pg = _engine_pg()
    kernel = TA.ALGORITHMS[name]()
    ref = Engine(kernel, pg, backend="ref", device="cpu")
    eng = Engine(kernel, pg, device="cuda")
    per_step = 2 if kernel.carry_dtype is not None else 1
    graphed = []
    for i, cap in enumerate(CAPS):
        before, k1 = _graph_counts(), edge_gather.launches
        got = _call(eng, entry, batch, cap)
        steps = max(r.supersteps for r in got)
        assert steps <= (cap or steps) and steps > 0
        assert edge_gather.launches - k1 == per_step * steps
        assert _grew(before) == (steps, steps - (i == 0), int(i == 0))
        for a, b in zip(got, _call(ref, entry, batch, cap)):
            _same_as(a, b, name)
        graphed.append(got)
    eng.offload()
    for got, cap in zip(graphed, CAPS):
        before, k1 = _graph_counts(), edge_gather.launches
        eager = _call(eng, entry, batch, cap)
        steps = max(r.supersteps for r in eager)
        assert edge_gather.launches - k1 == per_step * steps
        assert _grew(before) == (steps, 0, 0)
        for a, b in zip(got, eager):
            _same_bits(a, b, name)


@pytest.mark.gpu
def test_cuda_graph_recaptured_after_upload():
    """offload drops the engine's graphs (they hold the data's old
    addresses); after upload the next call captures anew, and every call
    gives the same bits."""
    _need_card()
    eng = Engine(TA.sssp(), _engine_pg())
    first = eng.run_batch(root=ROOTS[:2])
    assert set(eng._graphs) == {(2, "root")}
    eng.offload()
    assert not eng._graphs
    eager = eng.run_batch(root=ROOTS[:2])
    eng.upload()
    before = _graph_counts()
    again = eng.run_batch(root=ROOTS[:2])
    steps = max(r.supersteps for r in again)
    assert _grew(before) == (steps, steps - 1, 1)
    for a, b, c in zip(first, eager, again):
        _same_bits(a, b, "sssp")
        _same_bits(a, c, "sssp")


@pytest.mark.gpu
def test_cuda_two_threads_run_batch_on_one_engine():
    """Twelve threads (more than the machine's cores) call run_batch on
    one engine at once, from its first call on, with a short switch
    interval: one at a time holds the graph (the first also captures
    it), the others run the eager loop meanwhile; every answer equals
    the oracle's, exactly one graph is captured, and K1's launch count
    loses no update."""
    _need_card()
    pg = _engine_pg()
    eng = Engine(TA.sssp(), pg)
    ref = Engine(TA.sssp(), pg, backend="ref", device="cpu")
    n = 12
    roots = [np.roll(ROOTS, i) for i in range(n)]
    want = [ref.run_batch(root=r) for r in roots]
    barrier = threading.Barrier(n)
    out, errors = {i: [] for i in range(n)}, []

    def drive(i):
        try:
            barrier.wait()
            for _ in range(3):
                out[i].append(eng.run_batch(root=roots[i]))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    before, k1 = _graph_counts(), edge_gather.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    supersteps, replays, captures = _grew(before)
    assert captures == 1 and 0 < replays < supersteps
    assert edge_gather.launches - k1 == 2 * supersteps
    for i in range(n):
        assert len(out[i]) == 3
        for got in out[i]:
            for a, b in zip(got, want[i]):
                _same_as(a, b, "sssp")


_PEAK = """
import sys
import numpy as np
import torch
from repro_torch.core import algorithms as TA, graph as TG, obs
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
g = TG.rmat(18, 8, seed=3, weighted=True).symmetrized()
eng = Engine(TA.sssp(), TPT.partition_graph(g, 4, pad_multiple=16))
roots = np.array([3, 200, 77, 5, 901, 12, 640, 33])
batches = (8, 2, 1)
held = ([eng._graph(b, {"root": None}) for b in batches]
        if sys.argv[1] == "eager" else None)
torch.cuda.synchronize()
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
base_reserved = torch.cuda.memory_reserved()
for b in batches:
    for _ in range(2):
        eng.run_batch(root=roots[:b])
    torch.cuda.synchronize()
    if b == batches[0]:
        first_peak_reserved = torch.cuda.max_memory_reserved() - base_reserved
print(torch.cuda.max_memory_allocated() - base,
      torch.cuda.memory_reserved() - base_reserved, first_peak_reserved,
      obs.counters.snapshot().get("engine.graph_captures", 0))
"""


@pytest.mark.gpu
def test_cuda_graphed_peak_memory_within_eager():
    """Graphed run_batch calls at three batch sizes (captures included)
    take no more device memory than the eager loop of a twin engine, plus
    1 %: at their peak allocation; at the peak reservation of the first
    batch size's calls (the capture's pool takes the warm-up's place);
    and held after all the calls, when the graphs' pool and static
    carries stay reserved and the eager loop's blocks stay cached. Each
    graph pair updates one set of carry buffers in place, a call
    allocates no carry of its own, and the three pairs share one pool.
    A later batch size's first call warms up eagerly beside the held
    pool, so the peak reservation over all three is not held to the
    twin's (PERF.md). Each side runs in a process of its own, from an
    emptied cache after the engine's build."""
    _need_card()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    read = {}
    for side in ("graphed", "eager"):
        out = subprocess.run([sys.executable, "-c", _PEAK, side],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        *read[side], captures = map(int, out.stdout.split())
        assert captures == (3 if side == "graphed" else 0)
    for graphed, eager in zip(read["graphed"], read["eager"]):
        assert 0 < graphed <= 1.01 * eager, read


# (edges of each shard, segments, tile_e, tile_r): an empty shard, windows
# that own no tile, hub rows spanning many tiles, shards of unequal length
STACKS = [((300, 0, 45, 1), 130, 32, 16), ((0, 500, 30, 2000), 2000, 64, 32),
          ((4096, 700, 0, 64), 64, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
def test_cuda_stacked_kernel_matches_plain(combiner, dtype):
    _need_card()
    rng = np.random.default_rng(4)
    for sizes, n_segments, tile_e, tile_r in STACKS:
        st, _, _ = stack_layouts([build_layout(
            np.sort(rng.integers(0, n_segments + 1, n)), n_segments,
            tile_e=tile_e, tile_r=tile_r) for n in sizes])
        for batch in ((), (8,)):
            shape = batch + st["rel"].shape
            if np.issubdtype(dtype, np.floating):
                vals = rng.standard_normal(shape).astype(dtype)
            else:
                vals = rng.integers(-1000, 1000, shape).astype(dtype)
            vals = torch.from_numpy(vals)
            layout = StackedLayout(torch.from_numpy(st["tile_start"]),
                                   torch.from_numpy(st["rel"]), tile_e,
                                   tile_r, n_segments)
            want = ops.segment_combine_stacked(vals, layout, combiner)
            before = edge_gather.windows_launches
            got = ops.segment_combine_stacked(
                vals.cuda(), stacked_layout(layout.tile_start.cuda(),
                                            layout.rel.cuda(), tile_e, tile_r,
                                            n_segments), combiner)
            torch.cuda.synchronize()
            assert edge_gather.windows_launches == before + 1
            if combiner == "add" and dtype == np.float32:
                torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                           atol=1e-5)
            else:
                assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["allgather", "unicast", "combined"])
@pytest.mark.parametrize("name", ["bfs", "sssp", "pagerank"])
def test_cuda_shard_engine_matches_ref(exchange, name):
    _need_card()
    g = TG.rmat(10, 8, seed=3, weighted=True).symmetrized()
    pg = TPT.partition_graph(g, 4, pad_multiple=16)
    want = ShardEngine(TA.ALGORITHMS[name](), pg, exchange=exchange,
                       backend="ref", mesh=LocalMesh(4, "cpu")).run()
    before = edge_gather.windows_launches
    got = ShardEngine(TA.ALGORITHMS[name](), pg, exchange=exchange).run()
    calls = {"allgather": 1, "unicast": 0, "combined": 2}[exchange]
    calls += calls and name == "sssp"
    assert edge_gather.windows_launches - before == calls * got.supersteps
    assert (got.supersteps, got.messages, got.comm) == (
        want.supersteps, want.messages, want.comm)
    for k in want.state:
        if k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=1e-4, atol=1e-9)
        else:
            np.testing.assert_array_equal(got.state[k], want.state[k])


def _service_graph():
    g = TG.rmat(9, 8, seed=5, weighted=True).symmetrized()
    return g, TPT.partition_graph(g, 4, pad_multiple=16)


def _same_as(got, want, name):
    assert (got.supersteps, got.messages, got.comm) == (
        want.supersteps, want.messages, want.comm)
    for k in want.state:
        if name == "pagerank" and k == "score":
            np.testing.assert_allclose(got.state[k], want.state[k],
                                       rtol=1e-4, atol=1e-9)
        else:
            np.testing.assert_array_equal(got.state[k], want.state[k])


@pytest.mark.gpu
@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_cuda_service_matches_engine(scheduling):
    """The service on the card (its default device and backend) answers
    every query class as the oracle engine does, through K1."""
    _need_card()
    g, pg = _service_graph()
    svc = GraphQueryService(max_batch=8, slots=4, scheduling=scheduling,
                            result_cache_size=0)
    assert svc.device.type == "cuda" and svc.backend == "kernel"
    svc.add_graph("g", g, pad_multiple=16)
    for k in ("bfs", "sssp"):
        svc.warm("g", k)
    for k in ("wcc", "pagerank", "degree"):
        svc.warm("g", k, batch_sizes=[1])
    traces = svc.stats_snapshot()["plan_traces"]
    graphs = _graph_counts()
    asked = [(k, {"root": r}) for k in ("bfs", "sssp")
             for r in range(0, g.num_vertices, 47)]
    asked += [(k, {}) for k in ("wcc", "pagerank", "degree")]
    before = edge_gather.launches
    futs = [svc.submit(QueryRequest("g", k, kw, deadline_ms=60_000))
            for k, kw in asked]
    svc.flush()
    assert edge_gather.launches > before
    ref = {k: Engine(TA.ALGORITHMS[k](), pg, backend="ref", device="cpu")
           for k in ("bfs", "sssp", "wcc", "pagerank", "degree")}
    for (k, kw), f in zip(asked, futs):
        _same_as(f.result(timeout=0), ref[k].run(**kw), k)
    assert svc.stats_snapshot()["plan_traces"] == traces
    # the service's plans and steppers run the eager loop
    assert _grew(graphs)[1:] == (0, 0)


@pytest.mark.gpu
def test_cuda_offloaded_engine_launches_kernel():
    """An offloaded engine stages its host copies to the card for each
    call: K1 still runs there, for run and for a stepper."""
    _need_card()
    _, pg = _service_graph()
    eng = Engine(TA.sssp(), pg)
    want = eng.run(root=3)
    st = eng.make_stepper(2)
    carry, act, _ = st.init({"root": np.array([3, 9], np.int32)})
    assert eng.offload() == eng.device_nbytes > 0
    assert not eng.device_resident
    assert eng._data.vert_gid.device.type == "cpu"
    before = edge_gather.launches
    got = eng.run(root=3)
    assert edge_gather.launches - before == 2 * got.supersteps
    _same_as(got, want, "sssp")
    before = edge_gather.launches
    carry, act, _ = st.step(carry, act)
    assert edge_gather.launches - before == 2
    assert carry.active.device.type == "cuda"
    assert eng.upload() > 0.0 and eng.device_resident
    assert eng._data.vert_gid.device.type == "cuda"
    while act.any():
        carry, act, _ = st.step(carry, act)
    _same_as(eng.lane_result(st.fetch(carry), 0), want, "sssp")


@pytest.mark.gpu
def test_cuda_bucketed_and_continuous_share_one_engine():
    """A bucketed service and a continuous one over one plan cache share
    one engine (and its kernel layout); driven from two threads at once,
    both answer as the oracle engine does."""
    _need_card()
    g, pg = _service_graph()
    bsvc = GraphQueryService(max_batch=8, result_cache_size=0)
    bsvc.add_graph("g", g, pad_multiple=16)
    csvc = GraphQueryService(scheduling="continuous", slots=4,
                             plan_cache=bsvc.plans, result_cache_size=0)
    bsvc.warm("g", "bfs")
    csvc.warm("g", "bfs")
    assert len(bsvc.plans._engines) == 1
    roots = list(range(0, g.num_vertices, 13))
    out, errors = {}, []

    def drive(name, svc):
        try:
            futs = [svc.submit(QueryRequest("g", "bfs", {"root": r},
                                            deadline_ms=60_000))
                    for r in roots]
            svc.flush()
            out[name] = [f.result(timeout=60) for f in futs]
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=drive, args=("bucketed", bsvc)),
               threading.Thread(target=drive, args=("continuous", csvc))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    ref = Engine(TA.bfs(), pg, backend="ref", device="cpu")
    for r, b, c in zip(roots, out["bucketed"], out["continuous"]):
        want = ref.run(root=r)
        _same_as(b, want, "bfs")
        _same_as(c, want, "bfs")


@pytest.mark.gpu
def test_cuda_service_needs_the_card_or_cpu(monkeypatch):
    _need_card()
    assert GraphQueryService().device.type == "cuda"
    assert GraphQueryService(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphQueryService()


def _k2_calls(kernel, exchange, overlap=False):
    """K2 launches a superstep of ``exchange`` makes: the receiver's key,
    `got` unless derived from the identity, and the carry (allgather,
    frontier); the source's key, the mail bit (always in the synchronous
    schedule, else unless derived from the identity) and the carry
    (combined); none for the ring and unicast (oracle folds)."""
    if exchange in ("ring", "unicast"):
        return 0
    calls = 1 + (kernel.carry_dtype is not None)
    if exchange == "combined" and not overlap:
        return calls + 1
    return calls + (not kernel.got_from_identity)


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_cuda_shard_schedules_match_ref(exchange, overlap, name):
    """Every exchange in both schedules on the card equals the ref shard
    engine on the CPU, and launches K2 as many times as its folds say."""
    _need_card()
    g = TG.rmat(10, 8, seed=3, weighted=True).symmetrized()
    pg = TPT.partition_graph(g, 4, pad_multiple=16)
    want = ShardEngine(TA.ALGORITHMS[name](), pg, exchange=exchange,
                       backend="ref", mesh=LocalMesh(4, "cpu")).run(root=3)
    eng = ShardEngine(TA.ALGORITHMS[name](), pg, exchange=exchange)
    before = edge_gather.windows_launches
    got = eng.run(root=3, overlap=overlap)
    assert edge_gather.windows_launches - before == _k2_calls(
        eng.kernel, exchange, overlap) * got.supersteps
    _same_as(got, want, name)
    batch = eng.run_batch(root=np.array([3, 40, 99]), overlap=overlap)
    for r, res in zip((3, 40, 99), batch):
        solo = eng.run(root=r)
        assert (res.supersteps, res.messages) == (solo.supersteps,
                                                  solo.messages)
        for k in solo.state:
            np.testing.assert_array_equal(res.state[k], solo.state[k])


@pytest.mark.gpu
@pytest.mark.parametrize("exchange,overlap", [("combined", False),
                                              ("frontier", True)])
def test_cuda_shard_stepper_launches_k2(exchange, overlap):
    """A ShardLaneStepper steps its lanes through K2 on the card, and its
    lanes retire with their solo runs' results."""
    _need_card()
    _, pg = _service_graph()
    eng = ShardEngine(TA.sssp(), pg, exchange=exchange)
    st = eng.make_stepper(4, overlap=overlap)
    roots = np.array([3, 9, 40, 77], np.int32)
    carry, act, _ = st.init({"root": roots})
    assert carry.active.device.type == "cuda"
    steps = 0
    before = edge_gather.windows_launches
    while act.any():
        carry, act, _ = st.step(carry, act)
        steps += 1
    assert edge_gather.windows_launches - before == _k2_calls(
        eng.kernel, exchange, overlap) * steps
    host = st.fetch(carry)
    for lane, r in enumerate(roots):
        _same_as(eng.lane_result(host, lane), eng.run(root=int(r)), "sssp")


@pytest.mark.gpu
def test_cuda_offloaded_shard_engine_launches_k2():
    """An offloaded shard engine stages its host copies (the stacked
    layouts included) to the card for each call: K2 still runs there,
    for run and for a stepper."""
    _need_card()
    _, pg = _service_graph()
    eng = ShardEngine(TA.sssp(), pg, exchange="combined")
    want = eng.run(root=3)
    st = eng.make_stepper(2)
    carry, act, _ = st.init({"root": np.array([3, 9], np.int32)})
    assert eng.offload() == eng.device_nbytes > 0
    assert not eng.device_resident
    assert eng._data.comb.rel.device.type == "cpu"
    before = edge_gather.windows_launches
    got = eng.run(root=3)
    assert edge_gather.windows_launches - before == 3 * got.supersteps
    _same_as(got, want, "sssp")
    before = edge_gather.windows_launches
    carry, act, _ = st.step(carry, act)
    assert edge_gather.windows_launches - before == 3
    assert carry.active.device.type == "cuda"
    assert eng.upload() > 0.0 and eng.device_resident
    assert eng._data.comb.rel.device.type == "cuda"
    while act.any():
        carry, act, _ = st.step(carry, act)
    _same_as(eng.lane_result(st.fetch(carry), 0), want, "sssp")


@pytest.mark.gpu
@pytest.mark.parametrize("scheduling", ["bucketed", "continuous"])
def test_cuda_shard_service_matches_engine(scheduling):
    """A shard class of the service on the card (four shards of one
    card) answers as the oracle engine does, through K2, with the
    schedule toggled per request."""
    _need_card()
    g, pg = _service_graph()
    svc = GraphQueryService(num_shards=4, exchange="combined", max_batch=8,
                            slots=4, scheduling=scheduling,
                            result_cache_size=0)
    svc.add_graph("g", g, pad_multiple=16)
    for k in ("bfs", "sssp"):
        for ov in (False, True):
            svc.warm("g", k, overlap=ov)
    traces = svc.stats_snapshot()["plan_traces"]
    asked = [(k, r, i % 2 == 1) for i, (k, r) in enumerate(
        (k, r) for k in ("bfs", "sssp")
        for r in range(0, g.num_vertices, 37))]
    before = edge_gather.windows_launches
    futs = [svc.submit(QueryRequest("g", k, {"root": r}, deadline_ms=60_000,
                                    overlap=ov)) for k, r, ov in asked]
    svc.flush()
    assert edge_gather.windows_launches > before
    ref = {k: Engine(TA.ALGORITHMS[k](), pg, backend="ref", device="cpu")
           for k in ("bfs", "sssp")}
    for (k, r, _), f in zip(asked, futs):
        got, want = f.result(timeout=0), ref[k].run(root=r)
        assert (got.supersteps, got.messages) == (want.supersteps,
                                                  want.messages)
        assert got.comm["exchange"] == "combined"
        for key in want.state:
            np.testing.assert_array_equal(got.state[key], want.state[key])
    assert svc.stats_snapshot()["plan_traces"] == traces


# tests/test_models.py's prefill/decode tolerance for bf16 logits
LM_TOL = dict(rtol=0.1, atol=0.75)


def _lm(arch, seed=0):
    cfg = LMC.get(arch, reduced=True)
    cpu = LML.init_params(LMM.lm_spec(cfg),
                          generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (2, 13))
    prefix = None
    if cfg.family == "vlm":
        prefix = torch.from_numpy(rng.standard_normal(
            (2, cfg.prefix_len, cfg.d_model)).astype(np.float32)).to(
                torch.bfloat16)
    return cfg, cpu, tokens, prefix


def _lm_agree(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LM_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(LMC.DENSE_IDS))
def test_cuda_lm_serving_matches_cpu(arch):
    """Prefill and one decode step of a reduced dense config on the card
    against the same bf16 weights on the CPU."""
    _need_card()
    cfg, cpu, tokens, prefix = _lm(arch)
    start = 12 + (0 if prefix is None else cfg.prefix_len)
    out = {}
    for dev in ("cpu", "cuda"):
        params = LML.tree_map(lambda t: t.to(dev), cpu)
        pre = None if prefix is None else prefix.to(dev)
        prefill, decode, init_cache = LMS.make_serve_fns(
            cfg, batch=2, max_len=start + 4, device=dev)
        logits, pcache = prefill(params, tokens[:, :12], pre)
        cache = LMS.place_prefill_cache(cfg, pcache, init_cache(), 12)
        step, cache = decode(params, cache, tokens[:, 12:], start)
        out[dev] = (logits, step, cache)
    logits, step, cache = out["cuda"]
    assert logits.device.type == step.device.type == "cuda"
    assert cache["stage"]["0"]["k"].device.type == "cuda"
    _lm_agree(logits, out["cpu"][0])
    _lm_agree(step, out["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"])
def test_cuda_lm_prefill_decode_consistency(arch):
    """The reference's own check on the card: decode at position T from
    the prefill cache against the full forward at T."""
    _need_card()
    cfg, cpu, tokens, _ = _lm(arch, seed=1)
    params = LML.tree_map(lambda t: t.cuda(), cpu)
    full = LMM.lm_forward(params, torch.from_numpy(tokens).cuda(), cfg,
                          last_only=True)
    prefill, decode, init_cache = LMS.make_serve_fns(cfg, batch=2,
                                                     max_len=20)
    _, pcache = prefill(params, tokens[:, :12])
    cache = LMS.place_prefill_cache(cfg, pcache, init_cache(), 12)
    step, _ = decode(params, cache, tokens[:, 12:], 12)
    _lm_agree(step[:, -1], full[:, -1])
    gen = LMS.greedy_generate(cfg, params, tokens[:, :12], num_new=5)
    assert gen.shape == (2, 5) and ((gen >= 0) & (gen < cfg.vocab)).all()


@pytest.mark.gpu
def test_cuda_lm_serving_defaults_to_the_card():
    _need_card()
    cfg, cpu, tokens, _ = _lm("qwen3-4b")
    _, _, init_cache = LMS.make_serve_fns(cfg, batch=2, max_len=16)
    assert init_cache()["stage"]["0"]["k"].device.type == "cuda"
    tree = LML.tree_map(lambda t: t.float().numpy(), cpu)
    on_card = lm_params_from_numpy(cfg, tree)
    assert on_card["embed"].device.type == "cuda"
    assert LMS.greedy_generate(cfg, on_card, tokens[:, :8],
                               num_new=3).shape == (2, 3)


@pytest.mark.gpu
def test_cuda_lm_params_left_on_the_cpu_raise():
    """Converted params left on the CPU make a card call raise, not run
    on the CPU."""
    _need_card()
    cfg, cpu, tokens, _ = _lm("qwen3-4b")
    tree = LML.tree_map(lambda t: t.float().numpy(), cpu)
    left = lm_params_from_numpy(cfg, tree, device="cpu")
    prefill, decode, init_cache = LMS.make_serve_fns(cfg, batch=2,
                                                     max_len=16)
    with pytest.raises(ValueError, match="params lie on cpu"):
        prefill(left, tokens[:, :8])
    with pytest.raises(ValueError, match="params lie on cpu"):
        decode(left, init_cache(), tokens[:, :1], 8)
    with pytest.raises(ValueError, match="params lie on cpu"):
        LMS.greedy_generate(cfg, left, tokens[:, :8], num_new=2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [
    ("deepseek-moe-16b", "bf16"), ("deepseek-v2-236b", "bf16"),
    ("recurrentgemma-9b", "bf16"), ("xlstm-350m", "f32")])
def test_cuda_lm_other_mixers_match_cpu(arch, dtype):
    """Prefill and one decode step of a reduced MoE, MLA, RG-LRU or xLSTM
    config on the card against the same weights on the CPU, and every
    cache leaf (recurrent states included) on the card. xlstm-350m runs
    in float32: in bf16 its 16 gated recurrent layers carry the two
    devices' last-bit differences past the tolerance on 1-5 % of the
    logits (chip_smoke's LM_SMALL_F32, lm_precision_probe.py)."""
    _need_card()
    cfg, cpu, tokens, _ = _lm(arch)
    if dtype == "f32":
        cpu = LML.tree_map(lambda t: t.float(), cpu)
    out = {}
    for dev in ("cpu", "cuda"):
        params = LML.tree_map(lambda t: t.to(dev), cpu)
        prefill, decode, init_cache = LMS.make_serve_fns(
            cfg, batch=2, max_len=16, device=dev)
        logits, pcache = prefill(params, tokens[:, :12])
        cache = LMS.place_prefill_cache(cfg, pcache, init_cache(), 12)
        step, cache = decode(params, cache, tokens[:, 12:], 12)
        out[dev] = (logits, step, cache)
    logits, step, cache = out["cuda"]
    devices = set()
    LML.tree_map(lambda t: devices.add(t.device.type), cache)
    assert devices == {"cuda"}
    _lm_agree(logits, out["cpu"][0])
    _lm_agree(step, out["cpu"][1])


@pytest.mark.gpu
def test_cuda_moe_choices_match_cpu():
    """The router's (token, expert) choices and the dispatch on the card
    against the CPU in float32: the same experts, outputs to 1e-4."""
    _need_card()
    from repro_torch.models import moe as MOE
    g = torch.Generator().manual_seed(0)
    p = LML.init_params(MOE.moe_spec(64, 32, 16, 0), generator=g)
    p = LML.tree_map(lambda t: t.float(), p)
    x2 = torch.randn(96, 64, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        q = LML.tree_map(lambda t: t.to(dev), p)
        _, idx = MOE.route(x2.to(dev), q["router"], topk=4,
                           renormalize=True)
        y = MOE._dispatch_compute(
            x2.to(dev), q["router"], q["we_gate"], q["we_up"],
            q["we_down"], topk=4, capacity=16, n_routed=16, e_start=0,
            e_local=16, renormalize=True)
        out[dev] = (idx.cpu(), y.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_cuda_encdec_matches_cpu():
    """seamless-m4t-medium reduced: encode, the cross cache and three
    teacher-forced decode steps on the card against the CPU (bf16)."""
    _need_card()
    from repro_torch.models import encdec as ED
    cfg = LMC.get("seamless-m4t-medium", reduced=True)
    g = torch.Generator().manual_seed(0)
    cpu = LML.init_params(ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec),
                          generator=g)
    frames = torch.randn(2, 12, cfg.d_model, generator=g).to(torch.bfloat16)
    tokens = torch.randint(1, cfg.vocab, (2, 3), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        params = LML.tree_map(lambda t: t.to(dev), cpu)
        enc = ED.encode(params, frames.to(dev), cfg)
        cache = ED.init_encdec_cache(cfg, cfg.n_dec, 2, 8, 12, device=dev)
        ED.fill_cross_cache(params, enc, cache, cfg)
        steps = [ED.encdec_decode_step(params, cache,
                                       tokens[:, t:t + 1].to(dev), t,
                                       cfg)[0] for t in range(3)]
        out[dev] = torch.cat(steps, dim=1)
    assert out["cuda"].device.type == "cuda"
    _lm_agree(out["cuda"], out["cpu"])


def _identity_cast(monkeypatch):
    """``grad_cast_bf16`` as the identity: a float32 step rounds no
    cotangent to bf16, so two devices' steps agree at float32's
    tolerance (tests/_train_reference.py)."""
    from repro_torch.models import moe as LMOE
    monkeypatch.setattr(LML, "grad_cast_bf16", lambda x: x)
    monkeypatch.setattr(LMOE, "grad_cast_bf16", lambda x: x)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b",
                                  "deepseek-moe-16b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_cuda_train_step_matches_cpu(arch, monkeypatch):
    """One float32 train step of a reduced config on the card against the
    CPU from the same params and batch: loss, grad norm, every gradient
    and the moments at 1e-4; the params within float32 rounding except
    where a near-zero gradient may take the other sign (2 lr)."""
    _need_card()
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import encdec as ED
    from repro_torch.train import loop as TLOOP
    from repro_torch.train import optimizer as TOPT
    _identity_cast(monkeypatch)
    cfg = LMC.get(arch, reduced=True)
    spec = (ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
            if cfg.family == "encdec" else LMM.lm_spec(cfg))
    cpu = LML.tree_map(lambda t: t.float(), LML.init_params(
        spec, generator=torch.Generator().manual_seed(0)))
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=4,
                                       seq_len=16)).batch(0)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, 16, cfg.d_model,
                                      generator=torch.Generator()
                                      .manual_seed(1))
    oc = TOPT.AdamWConfig(lr_peak=1e-3, warmup_steps=3, total_steps=30)
    out = {}
    for dev in ("cpu", "cuda"):
        # a copy on the CPU too: the step updates its params in place
        params = LML.tree_map(lambda t: t.to(dev, copy=True), cpu)
        loss, grads = TLOOP.value_and_grad(TLOOP.make_loss(cfg), params,
                                           TLOOP.batch_on(batch, dev))
        params, state, m = TLOOP.make_train_step(cfg, oc)(
            params, TOPT.adamw_init(params), batch, 1)
        out[dev] = (loss, m, grads, params, state)
    tol = dict(rtol=1e-4, atol=1e-4)
    (loss, m, grads, params, state), want = out["cuda"], out["cpu"]
    assert loss.device.type == m["grad_norm"].device.type == "cuda"
    for a, b in ((loss, want[0]), (m["loss"], want[1]["loss"]),
                 (m["grad_norm"], want[1]["grad_norm"])):
        torch.testing.assert_close(a.cpu(), b, **tol)
    for got, ref in ((grads, want[2]), (state.m, want[4].m),
                     (state.v, want[4].v)):
        for a, b in zip(LML.leaves(got), LML.leaves(ref)):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a.cpu(), b, **tol)
    two_lr = 2 * float(TOPT.warmup_cosine(oc, 1)) * (1 + 1e-3)
    for a, b, g in zip(LML.leaves(params), LML.leaves(want[3]),
                       LML.leaves(want[2])):
        near0 = g.abs() <= tol["atol"] + tol["rtol"] * g.abs()
        allowed = torch.where(near0, two_lr, 0.0) + 1e-6 + 1e-6 * b.abs()
        assert bool(((a.cpu() - b).abs() <= allowed).all())


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip(tmp_path):
    """A bf16 model and its AdamW state after one step on the card, saved
    and restored onto the card bit for bit; restored onto the CPU too."""
    _need_card()
    from repro_torch.train import checkpoint as TCKPT
    from repro_torch.train import loop as TLOOP
    from repro_torch.train import optimizer as TOPT
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    cfg = LMC.get("qwen3-4b", reduced=True)
    params = LML.init_params(LMM.lm_spec(cfg), generator=torch.Generator(
        device="cuda").manual_seed(0))
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=4,
                                       seq_len=16)).batch(0)
    params, state, _ = TLOOP.make_train_step(cfg, TOPT.AdamWConfig())(
        params, TOPT.adamw_init(params), batch, 0)
    tree = {"params": params, "opt": state}
    TCKPT.save(str(tmp_path), 1, tree)
    for dev in ("cuda", "cpu"):
        got, meta = TCKPT.restore_latest(str(tmp_path), tree, device=dev)
        assert meta["step"] == 1
        for a, b in zip(LML.leaves(got["params"]) + LML.leaves(got["opt"].m)
                        + LML.leaves(got["opt"].v) + [got["opt"].count],
                        LML.leaves(params) + LML.leaves(state.m)
                        + LML.leaves(state.v) + [state.count]):
            assert a.device.type == dev and a.dtype == b.dtype
            assert torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                               b.cpu().reshape(-1).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_cuda_world_one_mesh_matches_no_mesh(arch):
    """A one-rank NCCL process group and a (1, 1) ("data", "model")
    DeviceMesh on the card: the DTensor path (params placed by the rules,
    the MoE layer expert-parallel) serves the same logits and greedy
    tokens as ``mesh=None``, and trains the same step."""
    _need_card()
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding as SH
    from repro_torch.train import loop as TLOOP
    from repro_torch.train import optimizer as TOPT
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = LMC.get(arch, reduced=True)
        spec = LMM.lm_spec(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        plain = LML.tree_map(lambda t: t.float(),
                             LML.init_params(spec, generator=gen))
        placed = SH.place_tree(mesh, LML.tree_map(torch.clone, plain),
                               SH.param_sharding_rules(
                                   mesh, plain, LML.axes_tree(spec)))
        tokens = np.random.default_rng(1).integers(1, cfg.vocab, (2, 12))
        with torch.no_grad():
            want = LMM.lm_forward(plain, torch.as_tensor(tokens).cuda(), cfg)
            got = LMM.lm_forward(placed, tokens, cfg, mesh=mesh)
        assert SH.is_dtensor(got) and got.device.type == "cuda"
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            LMS.greedy_generate(cfg, placed, tokens, num_new=4, mesh=mesh),
            LMS.greedy_generate(cfg, plain, tokens, num_new=4))
        oc = TOPT.AdamWConfig()
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        _, _, m1 = TLOOP.make_train_step(cfg, oc)(
            plain, TOPT.adamw_init(plain), batch, 1)
        _, _, m2 = TLOOP.make_train_step(cfg, oc, mesh)(
            placed, TOPT.adamw_init(placed), batch, 1)
        torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"],
                                   rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()
