"""The port on the card: the CUDA segment-combine kernels (K1, and K2 over
stacked per-shard layouts) against their plain versions, and the engines'
kernel paths against their oracle paths.

Marked ``gpu``; each test decides inside itself whether there is a card
and skips without one. The file imports no JAX, so it runs on a machine
that has only PyTorch: ``python -m pytest -m gpu tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
from repro_torch.core.engine_shardmap import ShardEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch.kernels import edge_gather, ops
from repro_torch.kernels.layout import (WORK_TILES, StackedLayout,
                                       build_layout, stack_layouts,
                                       stacked_layout)

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

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
