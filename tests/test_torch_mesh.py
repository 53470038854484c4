"""The shard engine's two meshes: ``LocalMesh`` (every shard on one
device) and ``ProcessGroupMesh`` (one shard per ``torch.distributed``
rank).

``LocalMesh``'s collectives are checked against their definition
(``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``:
``recv[me][q] = send[q][me]``). ``ProcessGroupMesh`` runs on gloo in four
CPU processes, launched as subprocesses with a timeout so that a hung
collective fails the test instead of stalling the suite; they meet
through a ``file://`` store under the test's temporary directory (no TCP
port to collide with other test workers) and import no JAX. Each rank
checks the collectives against ``LocalMesh`` on the stacked array
(``ppermute`` and the async ``all_to_all`` among them), then runs BFS and
SSSP (``run`` and ``run_batch``) on the five exchanges and on the
overlapped frontier and combined schedules (``ppermute_async`` and
``all_to_all_async`` on the wire); the results of every rank must equal
``LocalMesh``'s exactly.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine_shardmap import ShardEngine, build_shard_data
from repro_torch.core.mesh import LocalMesh, ProcessGroupMesh

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

WORLD = 4
# the exchanges, and two overlapped schedules ("-ov")
EXCHANGES = ["allgather", "ring", "frontier", "unicast", "combined",
             "frontier-ov", "combined-ov"]
ROOT, ROOTS = 5, [0, 17, 99]


def test_local_mesh_collectives():
    mesh = LocalMesh(WORLD, "cpu")
    rng = np.random.default_rng(0)
    send = torch.from_numpy(rng.integers(0, 99, (2, WORLD, WORLD, 3)))
    recv = mesh.all_to_all(send)
    for me in range(WORLD):
        for q in range(WORLD):
            assert torch.equal(recv[:, me, q], send[:, q, me])
    assert torch.equal(mesh.all_gather(send), send)
    assert torch.equal(mesh.all_to_all_async(send).wait(), recv)
    hop = mesh.ppermute(send)
    for me in range(WORLD):     # shard me receives shard me-1's block
        assert torch.equal(hop[:, me], send[:, (me - 1) % WORLD])
    assert torch.equal(mesh.ppermute_async(send).wait(), hop)
    assert mesh.devices == ("cpu",) * WORLD
    x = torch.from_numpy(rng.integers(-9, 9, (3, WORLD)))
    assert torch.equal(mesh.psum(x, dim=1), x.sum(dim=1))
    assert torch.equal(mesh.pmax(x, dim=1), x.amax(dim=1))
    assert mesh.pmax(x) is x and mesh.shards == slice(0, WORLD)


def test_process_group_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessGroupMesh(device="cpu")


def _graph():
    g = TG.uniform(200, 4.0, seed=9, weighted=True).symmetrized()
    pg = TPT.partition_graph(g, WORLD, method="greedy", pad_multiple=16)
    return pg, build_shard_data(pg, tile_e=64, tile_r=32)


def _runs(mesh, pg, data):
    """name -> the results the gloo ranks and LocalMesh both produce."""
    out = {}
    for schedule in EXCHANGES:
        exchange, _, ov = schedule.partition("-")
        for name in ("bfs", "sssp"):
            eng = ShardEngine(TA.ALGORITHMS[name](), pg, mesh=mesh,
                              exchange=exchange, shard_data=data,
                              tile_e=64, tile_r=32)
            res = [eng.run(root=ROOT, overlap=bool(ov))] + eng.run_batch(
                root=np.array(ROOTS), overlap=bool(ov))
            out[f"{schedule}-{name}"] = res
    return out


_RANK_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, world_size={world},
                        rank=rank)
from repro_torch.core.mesh import LocalMesh, ProcessGroupMesh
from test_torch_mesh import _graph, _runs

mesh, local = ProcessGroupMesh(device="cpu"), LocalMesh({world}, "cpu")
me = slice(rank, rank + 1)
assert mesh.num_shards == {world} and mesh.shards == me
rng = np.random.default_rng(1)
send = torch.from_numpy(rng.integers(0, 99, (2, {world}, {world}, 3)))
assert torch.equal(mesh.all_to_all(send[:, me]), local.all_to_all(send)[:, me])
bits = send[:, :, 0, 0] > 50
blocks = send[..., 0] > 50
assert torch.equal(mesh.all_to_all(blocks[:, me]),
                   local.all_to_all(blocks)[:, me])
assert torch.equal(mesh.all_gather(bits[:, me]), bits)
assert torch.equal(mesh.all_to_all_async(send[:, me]).wait(),
                   local.all_to_all(send)[:, me])
assert torch.equal(mesh.ppermute(send[:, me]), local.ppermute(send)[:, me])
assert torch.equal(mesh.ppermute_async(bits[:, me]).wait(),
                   local.ppermute(bits)[:, me])
assert mesh.devices == ("cpu",)
x = send[:, :, :, 0].sum(-1)
assert torch.equal(mesh.psum(x[:, me], dim=1), x.sum(dim=1))
assert torch.equal(mesh.pmax(x[:, me], dim=1), x.amax(dim=1))
w = send.to(torch.float32)[0, :, 0, 0]
assert torch.equal(mesh.psum(w[me], dim=0), w.sum(dim=0))

out = {{}}
for key, results in _runs(mesh, *_graph()).items():
    for i, r in enumerate(results):
        for view in ("state", "raw_state"):
            for k, v in getattr(r, view).items():
                out[f"{{key}}.{{i}}/{{view}}/{{k}}"] = np.asarray(v)
        out[f"{{key}}.{{i}}/meta"] = np.array(json.dumps(
            [r.supersteps, r.messages, r.comm]))
np.savez({out!r}.format(rank=rank), **out)
dist.destroy_process_group()
assert "jax" not in sys.modules and "repro" not in sys.modules
print("GLOO-RANK-OK")
"""


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Each rank's results, from four gloo processes."""
    tmp = tmp_path_factory.mktemp("gloo")
    here = os.path.dirname(os.path.abspath(__file__))
    script = _RANK_SCRIPT.format(
        src=os.path.join(os.path.dirname(here), "src"), tests=here,
        init=f"file://{tmp / 'store'}", world=WORLD,
        out=str(tmp / "rank{rank}.npz"))
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
    results = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz", allow_pickle=False) as f:
            results.append({k: f[k] for k in f.files})
    return results


@pytest.fixture(scope="module")
def local_results():
    return _runs(LocalMesh(WORLD, "cpu"), *_graph())


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_process_group_mesh_matches_local_mesh(gloo_results, local_results,
                                               exchange, name):
    key = f"{exchange}-{name}"
    want = local_results[key]
    assert len(want) == 1 + len(ROOTS)
    for rank, got in enumerate(gloo_results):
        for i, res in enumerate(want):
            prefix = f"{key}.{i}/"
            assert json.loads(str(got[prefix + "meta"])) == [
                res.supersteps, res.messages, res.comm], (rank, i)
            for view in ("state", "raw_state"):
                have = {k.split("/")[2]: v for k, v in got.items()
                        if k.startswith(prefix + view + "/")}
                ref = getattr(res, view)
                assert set(have) == set(ref)
                for k in ref:
                    assert have[k].dtype == ref[k].dtype, (rank, view, k)
                    np.testing.assert_array_equal(have[k], ref[k],
                                                  err_msg=f"{rank} {view}.{k}")
