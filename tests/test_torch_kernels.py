"""The port's kernel layer against the JAX package's, on the same inputs.

The inputs are made with numpy from a seed and handed to both sides. The
port's plain windowed combine (what its wrapper runs on a CPU tensor) is
held against the Pallas kernel in interpret mode, and its
``scatter_reduce_`` oracle against the JAX oracle: exact, except float32
add at rtol = atol = 1e-5 (the tolerance tests/test_kernels.py applies to
Pallas vs. its oracle). The host-side copies (graph generators,
partitioner, layout) must give field-identical arrays. The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import partition as JPT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.layout import build_layout as jax_build_layout
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.kernels import edge_gather, ops, ref
from repro_torch.kernels.layout import build_layout

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

