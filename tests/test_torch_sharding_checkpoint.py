"""Checkpoints, the Trainer and the launcher on a mesh, in 4 gloo rank
processes that import no JAX (tests/_shard_reference.py).

* ``Trainer(mesh=)`` on ("data", "model") = (2, 2) trains qwen3-4b's
  reduced config for 2 steps, saving each step: every process writes the
  leaves it owns into its own ``shard_{rank:05d}.npz`` and process 0
  commits. Its losses are the unsharded Trainer's (bf16 params: at the
  reference's bf16 tolerance, 0.05).
* The checkpoint restores bit for bit onto a (4,) ("data",) mesh, with
  no mesh, and in the JAX package (``repro.train.checkpoint.restore``),
  and a Trainer on the (4,) mesh resumes from it.
* ``allreduce_int8(axis="data")`` sums over the data axis of the mesh.
* ``launch/train.py --production-mesh`` in a world of 4 exits with the
  production mesh's error; ``launch/mesh.py`` imports without touching a
  device or a process group.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _shard_reference as R
from _train_reference import BF16_ATOL
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JOPT
from repro import configs as JC
from repro_torch import configs as TC
from repro_torch.data.pipeline import DataConfig
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT

ARCH = "qwen3-4b"
STEPS = 2

_RANKS = r"""
import _shard_reference as R
from repro_torch import configs as TC, sharding as SH
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import checkpoint as CK, compress as CP
from repro_torch.train import loop as TLOOP, optimizer as TOPT

cfg = TC.get({arch!r}, reduced=True)
dc = DataConfig(vocab=cfg.vocab, global_batch=R.TRAIN_B, seq_len=R.TRAIN_S)
oc = TOPT.AdamWConfig(**R.OPT)
tc = TLOOP.TrainConfig(steps={steps}, ckpt_every=1, ckpt_dir={ckpt!r},
                       log_every=1)
trainer = TLOOP.Trainer(cfg, dc, oc, tc, mesh=MESH)
res = trainer.run()
out = {{"losses": np.asarray(res["losses"])}}
for k, a in R.flat(res["params"]).items():
    assert SH.is_dtensor(a)
    out["trained/" + k] = a.full_tensor().float().numpy()

# onto a (4,) mesh, and with no mesh
mesh4 = make_local_mesh(("data",), device="cpu")
t4 = TLOOP.Trainer(cfg, dc, oc, TLOOP.TrainConfig(
    steps={steps} + 1, ckpt_every=100, ckpt_dir={ckpt!r}, log_every=1),
    mesh=mesh4)
on4, meta = CK.restore_latest({ckpt!r}, t4._template(),
                              shardings=t4._shardings())
plain, _ = CK.restore_latest({ckpt!r}, t4._template(), device="cpu")
assert meta["step"] == {steps} - 1 and meta["num_processes"] == 4
sharded = 0
for (k, a), (_, b) in zip(CK._paths(on4), CK._paths(plain)):
    if SH.is_dtensor(a):
        sharded += a.placements[0].is_shard()
        a = a.full_tensor()
    assert a.dtype == b.dtype and torch.equal(a.cpu(), b), k
    out["plain/" + k] = b.float().numpy()
assert sharded > 0
res4 = t4.run()
out["resumed"] = np.asarray(res4["losses"])

# int8 all-reduce over the data axis: each rank's value drawn from its
# rank, quantized with a generator seeded by its rank
def value(r):
    return torch.from_numpy(np.random.default_rng(r).standard_normal(
        300).astype(np.float32))
got = CP.allreduce_int8(value(RANK)[None], MESH, torch.Generator().manual_seed(
    RANK), axis="data")[0]
me = MESH.get_coordinate()
peers = [d * 2 + me[1] for d in range(2)]
want = 0
for r in peers:
    q, s, n = CP.quantize_int8(value(r), torch.Generator().manual_seed(r))
    want = want + CP.dequantize_int8(q, s, n, (300,), torch.float32)
out["int8"] = np.asarray(float((got - want).abs().max()))
np.savez({out!r}.format(rank=RANK), **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_ckpt")
    ckpt = tmp / "ckpt"
    body = _RANKS.format(arch=ARCH, steps=STEPS, ckpt=str(ckpt),
                         out=str(tmp / "rank{rank}.npz"))
    R.finish(R.start(rank_body=body, tmp=tmp), timeout=600)
    return ckpt, [R.load(tmp / f"rank{r}.npz") for r in range(R.WORLD)]


def test_sharded_trainer_matches_the_unsharded_one(ranks):
    _, got = ranks
    cfg = TC.get(ARCH, reduced=True)
    dc = DataConfig(vocab=cfg.vocab, global_batch=R.TRAIN_B,
                    seq_len=R.TRAIN_S)
    res = TLOOP.Trainer(cfg, dc, TOPT.AdamWConfig(**R.OPT),
                        TLOOP.TrainConfig(steps=STEPS, log_every=1),
                        device="cpu").run()
    want = np.asarray(res["losses"])
    for g in got:
        np.testing.assert_array_equal(g["losses"][:, 0], want[:, 0])
        np.testing.assert_allclose(g["losses"][:, 1], want[:, 1],
                                   atol=BF16_ATOL)
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])


def test_checkpoint_files_are_per_process(ranks):
    ckpt, _ = ranks
    step = ckpt / f"step_{STEPS - 1:08d}"
    meta = json.loads((step / "meta.json").read_text())
    keys = []
    for r in range(R.WORLD):
        with np.load(step / f"shard_{r:05d}.npz") as z:
            keys += z.files
    assert len(keys) == len(set(keys)) and sorted(keys) == meta["keys"]
    # the last save: the resumed Trainer's, on the (4,) mesh
    assert (ckpt / "LATEST").read_text() == f"step_{STEPS:08d}"


def test_sharded_checkpoint_restores_bit_for_bit(ranks):
    ckpt, got = ranks
    for g in got:
        trained = {k[8:]: v for k, v in g.items() if k.startswith("trained/")}
        assert trained
        for k, v in trained.items():     # the saved params, re-cut
            np.testing.assert_array_equal(g["plain/params//" + k], v)
        for k in g:
            if k.startswith("plain/"):
                np.testing.assert_array_equal(g[k], got[0][k])


def test_sharded_checkpoint_restores_in_the_jax_package(ranks):
    ckpt, got = ranks
    cfg = JC.get(ARCH, reduced=True)
    params = JL.abstract_params(JLM.lm_spec(cfg))
    template = {"params": params, "opt": JOPT.AdamWState(
        m=params, v=params, count=np.zeros((), np.int32))}
    tree, meta = JCKPT.restore(str(ckpt / f"step_{STEPS - 1:08d}"),
                               template)
    flat = {}
    for path, leaf in __import__("jax").tree_util.tree_flatten_with_path(
            tree)[0]:
        key = "//".join(str(getattr(p, "key", getattr(p, "name", p)))
                        for p in path)
        flat[key] = np.asarray(leaf, np.float32)
    plain = {k[6:]: v for k, v in got[0].items() if k.startswith("plain/")}
    assert len(flat) == len(plain)
    for k, v in plain.items():
        jk = k.replace("//.m//", "//m//").replace("//.v//", "//v//")
        jk = jk.replace("//.count", "//count")
        np.testing.assert_array_equal(flat[jk], v, err_msg=k)


def test_trainer_resumes_on_another_mesh(ranks):
    _, got = ranks
    for g in got:
        steps = g["resumed"][:, 0]
        assert steps.tolist() == [STEPS]    # resumed after the last save
        assert np.isfinite(g["resumed"][:, 1]).all()


def test_int8_allreduce_over_a_mesh_axis(ranks):
    _, got = ranks
    for g in got:
        assert float(g["int8"]) <= 1e-5


_LAUNCH = ("from repro_torch.launch.train import main; main()")


def test_launcher_needs_the_production_world(tmp_path):
    env = {**os.environ, "PYTHONPATH": R.SRC, "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(R.WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LAUNCH, "--arch", ARCH, "--device",
             "cpu", "--production-mesh", "--init-method",
             f"file://{tmp_path}/store"],
            env={**env, "WORLD_SIZE": str(R.WORLD), "RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 2, err[-2000:]
        assert "needs 256 ranks" in err and "has 4" in err, err[-2000:]


def test_mesh_module_touches_nothing_at_import():
    code = ("import sys, torch; import repro_torch.launch.mesh as M; "
            "import torch.distributed as d; "
            "assert not d.is_initialized(); "
            "assert not torch.cuda.is_initialized(); "
            "assert 'jax' not in sys.modules; "
            "print(sorted(M.PRODUCTION[True][1]))")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={**os.environ, "PYTHONPATH": R.SRC},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    from repro_torch.launch import mesh as M
    with pytest.raises(RuntimeError, match="256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
