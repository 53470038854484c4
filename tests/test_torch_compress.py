"""The port's int8 gradient compression (``repro_torch.train.compress``).

The reference's own checks on the port (tests/test_train.py): the
quantizer's error stays within one block scale (1/127 of the block's
largest |value|), stochastic rounding is unbiased, and ``wire_bytes``
equals the reference's. ``allreduce_int8`` over ``LocalMesh(4, "cpu")``
and over gloo (``ProcessGroupMesh``: four spawned CPU processes meeting
through a ``file://`` store, as in tests/test_torch_mesh.py) returns on
every shard the sum of the four shards' values within the sum of their
block scales, the same on every rank.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.train import compress as JCMP  # noqa: E402
from repro_torch.core.mesh import LocalMesh  # noqa: E402
from repro_torch.train import compress as TCMP  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
N = 1000     # values a shard all-reduces (not a multiple of the block)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(1, 5000))
def test_int8_quantizer_error_bound(seed, n):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 10
    q, s, cnt = TCMP.quantize_int8(x, torch.Generator().manual_seed(seed))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and cnt == n
    back = TCMP.dequantize_int8(q, s, cnt, x.shape, torch.float32)
    err = (back - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_int8_quantizer_unbiased():
    """Stochastic rounding: the mean dequantized value converges to x."""
    x = torch.full((TCMP.BLOCK,), 0.31337)
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(TCMP.BLOCK, dtype=torch.float64)
    K = 200
    for _ in range(K):
        q, s, n = TCMP.quantize_int8(x, gen)
        acc += TCMP.dequantize_int8(q, s, n, x.shape, torch.float32)
    assert abs(float(acc.mean()) / K - 0.31337) < 1e-3


@pytest.mark.parametrize("n", [1, 255, 256, 1_000_000])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_wire_bytes_equal_the_reference(n, dtype_bytes):
    assert TCMP.wire_bytes(n, dtype_bytes) == JCMP.wire_bytes(n, dtype_bytes)
    assert TCMP.wire_bytes(1_000_000)["ratio"] > 3.5


def _shards():
    """Each shard's values: (WORLD, N) float32, shard r scaled by r + 1."""
    rng = np.random.default_rng(7)
    return (rng.standard_normal((WORLD, N)).astype(np.float32)
            * np.arange(1, WORLD + 1, dtype=np.float32)[:, None])


def _bound(x):
    """The sum over shards of each element's block scale."""
    pad = (-x.shape[1]) % TCMP.BLOCK
    blocks = np.pad(x, ((0, 0), (0, pad))).reshape(WORLD, -1, TCMP.BLOCK)
    scale = np.abs(blocks).max(-1) / 127.0                    # (P, nblk)
    return np.repeat(scale.sum(0), TCMP.BLOCK)[:x.shape[1]]


def test_allreduce_int8_local_mesh():
    x = _shards()
    got = TCMP.allreduce_int8(torch.from_numpy(x), LocalMesh(WORLD, "cpu"),
                              torch.Generator().manual_seed(1))
    assert got.shape == (WORLD, N) and got.dtype == torch.float32
    for r in range(WORLD):
        assert torch.equal(got[r], got[0])
    err = np.abs(got[0].numpy() - x.sum(0))
    assert np.all(err <= _bound(x) + 1e-5)
    bf = TCMP.allreduce_int8(torch.from_numpy(x).to(torch.bfloat16),
                             LocalMesh(WORLD, "cpu"),
                             torch.Generator().manual_seed(1))
    assert bf.dtype == torch.bfloat16


_RANK_SCRIPT = r"""
import sys
sys.path.insert(0, {src!r})
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, world_size={world},
                        rank=rank)
from repro_torch.core.mesh import ProcessGroupMesh
from repro_torch.train.compress import allreduce_int8
x = np.load({shards!r})[rank:rank + 1]
got = allreduce_int8(torch.from_numpy(x), ProcessGroupMesh(device="cpu"),
                     torch.Generator().manual_seed(100 + rank))
np.save({out!r}.format(rank=rank), got.numpy())
dist.destroy_process_group()
assert "jax" not in sys.modules and "repro" not in sys.modules
print("GLOO-RANK-OK")
"""


def test_allreduce_int8_over_gloo(tmp_path):
    x = _shards()
    np.save(tmp_path / "shards.npy", x)
    here = os.path.dirname(os.path.abspath(__file__))
    script = _RANK_SCRIPT.format(
        src=os.path.join(os.path.dirname(here), "src"),
        init=f"file://{tmp_path / 'store'}", world=WORLD,
        shards=str(tmp_path / "shards.npy"),
        out=str(tmp_path / "rank{rank}.npy"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(WORLD)]
    deadline = time.monotonic() + 240
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and "GLOO-RANK-OK" in stdout, stderr[-3000:]
    got = [np.load(tmp_path / f"rank{r}.npy") for r in range(WORLD)]
    for g in got:
        assert g.shape == (1, N)
        np.testing.assert_array_equal(g, got[0])   # every rank the same sum
    assert np.all(np.abs(got[0][0] - x.sum(0)) <= _bound(x) + 1e-5)
