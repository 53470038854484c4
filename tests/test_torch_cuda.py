"""The port on the card: the CUDA segment-combine kernel against its plain
version, and the engine's kernel path against its oracle path.

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
from repro_torch.kernels import edge_gather, ops
from repro_torch.kernels.layout import build_layout

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
