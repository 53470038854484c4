"""The port's kernel layer against the JAX package's, on the same inputs.

The inputs are made with numpy from a seed and handed to both sides. The
port's plain windowed combine (what its wrapper runs on a CPU tensor) is
held against the Pallas kernel in interpret mode, and its
``scatter_reduce_`` oracle against the JAX oracle: exact, except float32
add at rtol = atol = 1e-5 (the tolerance tests/test_kernels.py applies to
Pallas vs. its oracle). The stacked combine's plain version (K2, the
shard engine's) is held, shard by shard, against the JAX package's
``segment_combine_windows`` in interpret mode, and so is what the CUDA
kernel does with its work list (each item folded by the plain oracle, the
partials of split windows folded after). The host-side copies
(graph generators, partitioner, layout) must give field-identical arrays.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import partition as JPT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.edge_gather import segment_combine_windows as jax_windows
from repro.kernels.layout import build_layout as jax_build_layout
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.kernels import edge_gather, ops, ref
from repro_torch.kernels.layout import (WORK_TILES, StackedLayout,
                                       build_layout, stack_layouts, work_list)

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

COMBINER_DTYPES = [
    ("min", np.float32), ("min", np.int32),
    ("max", np.float32), ("max", np.int32),
    ("add", np.float32), ("add", np.int32),
]
SHAPES = [  # the sweep of tests/test_kernels.py
    (0, 16, 32, 16),         # empty graph
    (1, 1, 32, 16),          # single edge
    (500, 64, 64, 32),       # dense-ish
    (500, 2000, 64, 32),     # sparse (most segments empty)
    (777, 130, 128, 64),     # non-multiple sizes
    (2048, 64, 256, 256),    # hub rows spanning many tiles
]


def _inputs(rng, n_edges, n_segments, dtype, batch=None):
    seg = np.sort(rng.integers(0, n_segments, size=n_edges)).astype(np.int64)
    shape = (n_edges,) if batch is None else (batch, n_edges)
    if np.issubdtype(dtype, np.floating):
        vals = rng.standard_normal(shape).astype(dtype)
    else:
        vals = rng.integers(-1000, 1000, size=shape).astype(dtype)
    return seg, vals


def _padded(layout, vals, combiner):
    """Lane-ordered values with the identity in padding lanes (numpy)."""
    ident = jops.identity_for(combiner, vals.dtype)
    out = np.full(vals.shape[:-1] + (layout.num_lanes,), ident, vals.dtype)
    out[..., layout.lane_of_edge] = vals
    return out


def _assert_match(got, want, combiner, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if combiner == "add" and np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
@pytest.mark.parametrize("n_edges,n_segments,tile_e,tile_r", SHAPES)
def test_windowed_combine_matches_pallas(combiner, dtype, n_edges,
                                         n_segments, tile_e, tile_r):
    rng = np.random.default_rng(n_edges * 7 + n_segments)
    seg, vals = _inputs(rng, n_edges, n_segments, dtype)
    jl = jax_build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    vp = _padded(jl, vals, combiner)
    want = jops.segment_combine_layout(jnp.asarray(vp), jl, combiner,
                                       interpret=True)
    tl = build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    launched = edge_gather.launches
    got = ops.segment_combine_layout(torch.from_numpy(vp), tl.to("cpu"),
                                     combiner)
    assert edge_gather.launches == launched  # CPU: the plain version
    _assert_match(got, want, combiner, dtype)
    # The twin oracles agree too.
    want_ref = jref.segment_combine(jnp.asarray(vals),
                                    jnp.asarray(seg.astype(np.int32)),
                                    n_segments, combiner)
    got_ref = ref.segment_combine(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n_segments, combiner)
    _assert_match(got_ref, want_ref, combiner, dtype)


@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
def test_batched_combine_matches_pallas_per_query(combiner, dtype):
    """A (B, lanes) call equals B single-query Pallas calls."""
    rng = np.random.default_rng(11)
    n_edges, n_segments, tile_e, tile_r = 900, 150, 64, 32
    seg, vals = _inputs(rng, n_edges, n_segments, dtype, batch=5)
    jl = jax_build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    vp = _padded(jl, vals, combiner)
    tl = build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    got = ops.segment_combine_layout(torch.from_numpy(vp), tl.to("cpu"),
                                     combiner)
    got_ref = ref.segment_combine(torch.from_numpy(vals),
                                  torch.from_numpy(seg), n_segments, combiner)
    assert got.shape == (5, n_segments)
    for b in range(5):
        want = jops.segment_combine_layout(jnp.asarray(vp[b]), jl, combiner,
                                           interpret=True)
        _assert_match(got[b], want, combiner, dtype)
        _assert_match(got_ref[b], want, combiner, dtype)


@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
def test_dispatcher_matches_jax(combiner, dtype):
    """``ops.segment_combine`` with and without a layout, as in JAX."""
    rng = np.random.default_rng(5)
    seg, vals = _inputs(rng, 600, 90, dtype)
    jl = jax_build_layout(seg, 90, tile_e=64, tile_r=32)
    lane_vals = jl.place(vals, 0)  # pads hold 0, masked by the dispatcher
    want = jops.segment_combine(jnp.asarray(lane_vals), None, 90, combiner,
                                layout=jl, interpret=True)
    tl = build_layout(seg, 90, tile_e=64, tile_r=32)
    got = ops.segment_combine(torch.from_numpy(lane_vals), None, 90,
                              combiner, layout=tl)
    _assert_match(got, want, combiner, dtype)
    want = jops.segment_combine(jnp.asarray(vals),
                                jnp.asarray(seg.astype(np.int32)), 90,
                                combiner)
    got = ops.segment_combine(torch.from_numpy(vals), torch.from_numpy(seg),
                              90, combiner)
    _assert_match(got, want, combiner, dtype)


@pytest.mark.parametrize("combiner", ["min", "max"])
@pytest.mark.parametrize("key_dtype", [np.float32, np.int32])
def test_carry_combine_matches_jax(combiner, key_dtype):
    rng = np.random.default_rng(3)
    n, s = 400, 37
    seg = np.sort(rng.integers(0, s + 1, size=n)).astype(np.int32)  # s = pad
    keys = rng.integers(0, 10, size=n).astype(key_dtype)  # many ties
    carry = rng.integers(0, 1000, size=n).astype(np.int32)
    cid = np.iinfo(np.int32).max
    want_acc, want_car = jref.segment_combine_carry(
        jnp.asarray(keys), jnp.asarray(carry), jnp.asarray(seg), s,
        combiner, cid)
    got_acc, got_car = ref.segment_combine_carry(
        torch.from_numpy(keys), torch.from_numpy(carry),
        torch.from_numpy(seg), s, combiner, cid)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    np.testing.assert_array_equal(got_car.numpy(), np.asarray(want_car))


@pytest.mark.parametrize("n_edges,n_segments,tile_e,tile_r", SHAPES)
def test_layout_matches_jax(n_edges, n_segments, tile_e, tile_r):
    rng = np.random.default_rng(n_edges + 3 * n_segments)
    seg = np.sort(rng.integers(0, n_segments + 1, size=n_edges))
    want = jax_build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    got = build_layout(seg, n_segments, tile_e=tile_e, tile_r=tile_r)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    # tile_start is the per-window tile range the CUDA grid walks.
    counts = np.bincount(got.window_id, minlength=got.n_windows)
    np.testing.assert_array_equal(np.diff(got.tile_start), counts)
    assert got.tile_start[0] == 0 and got.tile_start[-1] == got.n_tiles


def _assert_dataclass_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_generators_match_jax(seed):
    pairs = [
        (JG.uniform(300, 5.0, seed=seed), TG.uniform(300, 5.0, seed=seed)),
        (JG.uniform(200, 4.0, seed=seed, weighted=True).symmetrized(),
         TG.uniform(200, 4.0, seed=seed, weighted=True).symmetrized()),
        (JG.rmat(8, 6, seed=seed).symmetrized(),
         TG.rmat(8, 6, seed=seed).symmetrized()),
        (JG.rmat(9, 16, seed=seed, weighted=True),
         TG.rmat(9, 16, seed=seed, weighted=True)),
        (JG.ladder(6, 9, 2, seed=seed), TG.ladder(6, 9, 2, seed=seed)),
        (JG.line(50), TG.line(50)),
        (JG.road(12, seed=seed), TG.road(12, seed=seed)),
    ]
    for want, got in pairs:
        _assert_dataclass_equal(got, want)


@pytest.mark.parametrize("method", ["greedy", "round_robin", "snake_lpt",
                                    "ldg"])
@pytest.mark.parametrize("seed", [1, 7])
def test_partition_matches_jax(method, seed):
    jg = JG.rmat(8, 6, seed=seed, weighted=True).symmetrized()
    tg = TG.rmat(8, 6, seed=seed, weighted=True).symmetrized()
    want = JPT.partition_graph(jg, 4, method=method, pad_multiple=16)
    got = TPT.partition_graph(tg, 4, method=method, pad_multiple=16)
    _assert_dataclass_equal(got, want)
    assert got.device_nbytes == want.device_nbytes


def test_wrapper_rejects_bad_inputs():
    tl = build_layout(np.arange(10), 10, tile_e=16, tile_r=8).to("cpu")
    lanes = tl.rel.numel()
    with pytest.raises(TypeError):
        ops.segment_combine_layout(torch.zeros(lanes, dtype=torch.float64),
                                   tl, "min")
    with pytest.raises(ValueError):
        ops.segment_combine_layout(torch.zeros(lanes + 4), tl, "min")
    with pytest.raises(ValueError):
        ops.segment_combine_layout(torch.zeros(lanes), tl, "mul")
    with pytest.raises(ValueError):
        ops.segment_combine_layout(torch.zeros(2, lanes).t(), tl, "min")



# Stacked per-shard layouts: (edges of each shard, segments, tile_e,
# tile_r, skew). Each has an empty shard, and sparse shards leave windows
# that own no tile; segment ids are drawn as n_segments * u**skew, so the
# last stack has hub rows spanning many tiles.
STACKS = [
    ((300, 0, 45, 1), 130, 32, 16, 1),
    ((0, 500, 30, 2000), 2000, 64, 32, 1),
    ((2048, 700, 0, 64), 2000, 64, 64, 4),
]


def _stack(rng, sizes, n_segments, tile_e, tile_r, skew, dtype, batch):
    """A stacked layout (numpy arrays) and random values in every lane,
    padding lanes and the pad tiles of shorter shards included."""
    layouts = [build_layout(
        np.sort((n_segments + 1) * rng.random(n) ** skew).astype(np.int64),
        n_segments, tile_e=tile_e, tile_r=tile_r) for n in sizes]
    st, _, _ = stack_layouts(layouts)
    assert not st["window_written"].all()  # some window owns no tile
    shape = (batch, len(sizes), st["rel"].shape[1])
    if np.issubdtype(dtype, np.floating):
        vals = rng.standard_normal(shape).astype(dtype)
    else:
        vals = rng.integers(-1000, 1000, size=shape).astype(dtype)
    return st, vals


@pytest.mark.parametrize("combiner,dtype", COMBINER_DTYPES)
@pytest.mark.parametrize("sizes,n_segments,tile_e,tile_r,skew", STACKS)
def test_stacked_combine_matches_pallas_windows(combiner, dtype, sizes,
                                                n_segments, tile_e, tile_r,
                                                skew):
    rng = np.random.default_rng(n_segments + tile_e)
    st, vals = _stack(rng, sizes, n_segments, tile_e, tile_r, skew, dtype,
                      3)
    if skew > 1:  # a hub window
        assert np.diff(st["tile_start"]).max() >= 8
    layout = StackedLayout(torch.from_numpy(st["tile_start"]),
                           torch.from_numpy(st["rel"]), tile_e, tile_r,
                           n_segments)
    launched = edge_gather.windows_launches
    got = ops.segment_combine_stacked(torch.from_numpy(vals), layout,
                                      combiner)
    got1 = ops.segment_combine_stacked(torch.from_numpy(vals[0]), layout,
                                       combiner)
    assert edge_gather.windows_launches == launched  # CPU: the plain version
    assert got.shape == vals.shape[:2] + (n_segments,)
    _assert_match(got1, got[0], combiner, dtype)
    n_windows = st["window_written"].shape[1]
    for s in range(len(sizes)):
        for b in range(vals.shape[0]):
            want = jax_windows(
                jnp.asarray(st["window_id"][s]), jnp.asarray(st["rel"][s]),
                jnp.asarray(vals[b, s]), combiner=combiner, tile_e=tile_e,
                tile_r=tile_r, n_windows=n_windows,
                window_written=jnp.asarray(st["window_written"][s]),
                num_segments=n_segments, interpret=True)
            _assert_match(got[b, s], want, combiner, dtype)


def test_stack_layouts_checks_unwritten_windows():
    layouts = [build_layout(np.array([0, 0, 9]), 40, tile_e=16, tile_r=8),
               build_layout(np.array([], np.int64), 40, tile_e=16, tile_r=8)]
    st, n_tiles, n_windows = stack_layouts(layouts)
    assert (n_tiles, n_windows) == (2, 6)
    # the empty shard's one dummy tile points at window 0, as in JAX
    np.testing.assert_array_equal(st["tile_start"][1], [0, 1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(st["window_id"][1], [0, 0])
    bad = dataclasses.replace(
        layouts[0], window_written=np.zeros(n_windows, bool))
    with pytest.raises(ValueError, match="unwritten"):
        stack_layouts([bad])
    with pytest.raises(ValueError, match="tile shape"):
        stack_layouts([layouts[0], build_layout(np.arange(3), 40, tile_e=16,
                                                tile_r=16)])


def test_stacked_wrapper_rejects_bad_inputs():
    st, _, _ = stack_layouts([build_layout(np.arange(10), 10, tile_e=16,
                                           tile_r=8)] * 2)
    layout = StackedLayout(torch.from_numpy(st["tile_start"]),
                           torch.from_numpy(st["rel"]), 16, 8, 10)
    lanes = st["rel"].shape[1]
    with pytest.raises(TypeError):
        ops.segment_combine_stacked(torch.zeros(2, lanes, dtype=torch.int64),
                                    layout, "min")
    with pytest.raises(ValueError):
        ops.segment_combine_stacked(torch.zeros(3, lanes), layout, "min")
    with pytest.raises(ValueError):
        ops.segment_combine_stacked(torch.zeros(2, lanes), layout, "mul")
    with pytest.raises(ValueError):
        ops.segment_combine_stacked(torch.zeros(lanes, 2).t(), layout, "min")
    with pytest.raises(ValueError):
        ops.segment_combine_stacked(torch.zeros(2, lanes),
                                    layout._replace(num_segments=40), "min")


# The CUDA kernel's work list (kernels/layout.py:work_list). Two layouts:
# "hub" puts ~110 tiles of 32 lanes in its first window (more than
# WORK_TILES, so that window is cut into several items); "stack" holds a
# hub shard, an empty shard and a sparse shard whose windows mostly own no
# tile. (edges of each shard, segments, tile_e, tile_r, skew).
WORK_LAYOUTS = {
    "hub": ((5000,), 300, 32, 64, 4),
    "stack": ((4000, 0, 40), 900, 32, 64, 4),
}


@functools.cache
def _work_layout(name):
    sizes, n_segments, tile_e, tile_r, skew = WORK_LAYOUTS[name]
    rng = np.random.default_rng(len(name))
    layouts = [build_layout(
        np.sort(n_segments * rng.random(n) ** skew).astype(np.int64),
        n_segments, tile_e=tile_e, tile_r=tile_r) for n in sizes]
    st, _, _ = stack_layouts(layouts)
    return st


@pytest.mark.parametrize("name,max_tiles", [("hub", WORK_TILES),
                                            ("stack", WORK_TILES),
                                            ("stack", 5), ("stack", 1)])
def test_work_list_covers_every_tile_range(name, max_tiles):
    """Each (shard, window) tile range is covered exactly once, in items
    of at most ``max_tiles`` tiles; a window that owns no tile is one
    empty item (so it is still written); a split window's partial slots
    are consecutive and its counter is its own."""
    tile_start = _work_layout(name)["tile_start"].astype(np.int64)
    n_shards, n_windows = tile_start.shape[0], tile_start.shape[1] - 1
    items = work_list(tile_start, max_tiles)
    assert items.dtype == np.int32 and items.shape[1] == 8
    tiles = items[:, 3] - items[:, 2]
    assert (tiles <= max_tiles).all() and (tiles >= 0).all()
    assert (np.diff(tiles) <= 0).all()  # most tiles first
    if name == "hub" or max_tiles < WORK_TILES:
        assert (items[:, 7] > 1).any()  # some window is cut
    counters, slots = [], []
    for s in range(n_shards):
        for w in range(n_windows):
            mine = items[(items[:, 0] == s) & (items[:, 1] == w)]
            mine = mine[np.argsort(mine[:, 2], kind="stable")]
            lo, hi = tile_start[s, w], tile_start[s, w + 1]
            parts = len(mine)
            assert parts == max(1, -(-(hi - lo) // max_tiles))
            assert (mine[:, 7] == parts).all()
            # consecutive, gap-free, exactly [lo, hi)
            np.testing.assert_array_equal(mine[:, 2], np.r_[lo, mine[:-1, 3]])
            assert mine[0, 2] == lo and mine[-1, 3] == hi
            if hi == lo:
                assert parts == 1 and mine[0, 2] == mine[0, 3]
            if parts == 1:
                assert (mine[0, 4], mine[0, 5], mine[0, 6]) == (-1, -1, -1)
                continue
            assert len(set(mine[:, 4])) == 1 and len(set(mine[:, 6])) == 1
            np.testing.assert_array_equal(
                np.sort(mine[:, 5]), mine[0, 6] + np.arange(parts))
            counters.append(mine[0, 4])
            slots.extend(mine[:, 5])
    np.testing.assert_array_equal(np.sort(counters), np.arange(len(counters)))
    np.testing.assert_array_equal(np.sort(slots), np.arange(len(slots)))


FOLD = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def _fold_by_items(items, tile_start, rel, vals, combiner, tile_e, tile_r,
                   num_segments):
    """What the CUDA kernel does with the work list, in the list's order,
    with the plain oracle as each item's fold: an item that is its whole
    window stores its rows; one of a split window stores its partial in
    its slot, and the last of the window to arrive folds the slots in
    slot order and stores the rows. Every row is written exactly once."""
    batch, n_shards = vals.shape[:2]
    bad = torch.iinfo(torch.int32).min + 7 if vals.dtype == torch.int32 \
        else float("nan")
    out = torch.full((batch, n_shards, num_segments), bad, dtype=vals.dtype)
    written = torch.zeros((n_shards, num_segments), dtype=torch.int32)
    n_slots = int((items[:, 5] >= 0).sum())
    scratch = torch.full((n_slots, batch, tile_r), bad, dtype=vals.dtype)
    arrivals = np.zeros(int(items[:, 4].max()) + 1, np.int64)
    for s, w, lo, hi, counter, slot, first, parts in items.tolist():
        lanes = slice(lo * tile_e, hi * tile_e)
        part = ref.segment_combine(vals[:, s, lanes],
                                   rel[s, lanes].to(torch.int64), tile_r,
                                   combiner)
        if parts > 1:
            scratch[slot] = part
            arrivals[counter] += 1
            if arrivals[counter] < parts:
                continue
            arrivals[counter] = 0
            part = scratch[first]
            for k in range(1, parts):
                part = FOLD[combiner](part, scratch[first + k])
        rows = slice(w * tile_r, min((w + 1) * tile_r, num_segments))
        width = rows.stop - rows.start
        if width > 0:
            out[:, s, rows] = part[:, :width]
            written[s, rows] += 1
    assert (arrivals == 0).all()  # every counter back to 0 for the next call
    assert (written == 1).all()
    return out


@functools.cache
def _pallas_windows(name, combiner, dtype):
    """The JAX Pallas result (interpret mode) for 17 queries of random
    values over a WORK_LAYOUTS layout, shard by shard."""
    st = _work_layout(name)
    _, n_segments, tile_e, tile_r, _ = WORK_LAYOUTS[name]
    rng = np.random.default_rng(17)
    shape = (17,) + st["rel"].shape
    if np.issubdtype(dtype, np.floating):
        vals = rng.standard_normal(shape).astype(dtype)
    else:
        vals = rng.integers(-1000, 1000, size=shape).astype(dtype)
    n_windows = st["window_written"].shape[1]
    want = []
    for s in range(shape[1]):
        fold = jax.vmap(functools.partial(
            jax_windows, jnp.asarray(st["window_id"][s]),
            jnp.asarray(st["rel"][s]), combiner=combiner, tile_e=tile_e,
            tile_r=tile_r, n_windows=n_windows,
            window_written=jnp.asarray(st["window_written"][s]),
            num_segments=n_segments, interpret=True))
        want.append(np.asarray(fold(jnp.asarray(vals[:, s]))))
    return vals, np.stack(want, axis=1)


@pytest.mark.parametrize("batch", [1, 3, 8, 17])
@pytest.mark.parametrize("combiner,dtype", [("min", np.int32),
                                            ("max", np.float32),
                                            ("add", np.float32)])
@pytest.mark.parametrize("name", list(WORK_LAYOUTS))
def test_work_items_fold_matches_pallas(name, combiner, dtype, batch):
    """Folding each work item's lanes with the plain version and then
    combining the split windows' partials equals the Pallas kernel."""
    vals, want = _pallas_windows(name, combiner, dtype)
    st = _work_layout(name)
    _, n_segments, tile_e, tile_r, _ = WORK_LAYOUTS[name]
    items = work_list(st["tile_start"])
    assert (items[:, 7] > 1).any()  # a window is cut into several items
    got = _fold_by_items(items, torch.from_numpy(st["tile_start"]),
                         torch.from_numpy(st["rel"]),
                         torch.from_numpy(vals[:batch]), combiner, tile_e,
                         tile_r, n_segments)
    _assert_match(got, want[:batch], combiner, dtype)
    # The wrapper's plain version agrees on the same stack.
    layout = StackedLayout(torch.from_numpy(st["tile_start"]),
                           torch.from_numpy(st["rel"]), tile_e, tile_r,
                           n_segments)
    plain = ops.segment_combine_stacked(torch.from_numpy(vals[:batch]),
                                        layout, combiner)
    _assert_match(plain, want[:batch], combiner, dtype)
