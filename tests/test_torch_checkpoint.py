"""The port's checkpoints (``repro_torch.train.checkpoint``) in the JAX
package's on-disk format: each package restores the other's checkpoints
bit for bit (bf16 params, float32 moments, the int32 count), both write
the same keys, ``restore_latest`` walks past incomplete directories, and
``Checkpointer`` keeps the last three.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.train import checkpoint as JCKPT
from repro.train import optimizer as JOPT
from repro_torch import configs as TC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.train import checkpoint as TCKPT
from repro_torch.train import optimizer as TOPT

torch.set_num_threads(1)

ARCH = "qwen3-4b"


def _jax_state(seed=0):
    """The reference's bf16 params and an AdamW state whose moments and
    count are not zero (one update from random gradients)."""
    cfg = JC.get(ARCH, reduced=True)
    p = JL.init_params(jax.random.PRNGKey(seed), JLM.lm_spec(cfg))
    g = JL.init_params(jax.random.PRNGKey(seed + 1), JLM.lm_spec(cfg))
    p, s = JOPT.adamw_update(g, JOPT.adamw_init(p), p, JOPT.AdamWConfig(),
                             jax.numpy.int32(3))
    return {"params": p, "opt": s}


def _port_template():
    cfg = TC.get(ARCH, reduced=True)
    params = TL.abstract_params(TLM.lm_spec(cfg))
    return {"params": params, "opt": TOPT.adamw_init(params)}


def _bits(a):
    """A leaf's raw bytes (numpy or tensor, bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_leaves(tree):
    return [tree["params"], tree["opt"].m, tree["opt"].v]


def _assert_same(port_tree, jax_tree):
    jax_tree = jax.tree.map(np.asarray, jax_tree)
    for got, want in zip(_port_leaves(port_tree),
                         [jax_tree["params"], jax_tree["opt"].m,
                          jax_tree["opt"].v]):
        g, w = TL.leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert _bits(a).dtype == _bits(b).dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert port_tree["opt"].count.dtype == torch.int32
    assert int(port_tree["opt"].count) == int(jax_tree["opt"].count) == 1


def test_jax_checkpoint_restores_bit_for_bit(tmp_path):
    tree = _jax_state()
    JCKPT.save(str(tmp_path), 7, tree, extra={"arch": ARCH})
    got, meta = TCKPT.restore_latest(str(tmp_path), _port_template(),
                                     device="cpu")
    assert meta["step"] == 7 and meta["arch"] == ARCH
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"].m["embed"].dtype == torch.float32
    _assert_same(got, tree)


def test_port_checkpoint_restores_bit_for_bit_in_jax(tmp_path):
    tree = _jax_state(seed=3)
    cfg = TC.get(ARCH, reduced=True)
    host = jax.tree.map(np.asarray, tree)
    port = {"params": lm_params_from_numpy(cfg, host["params"],
                                           device="cpu"),
            "opt": adamw_state_from_numpy(cfg, host["opt"], device="cpu")}
    TCKPT.save(str(tmp_path), 4, port, extra={"arch": ARCH})
    got, meta = JCKPT.restore_latest(str(tmp_path), tree)
    assert meta["step"] == 4 and meta["num_processes"] == 1
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))
    # and back into the port
    again, _ = TCKPT.restore(os.path.join(tmp_path, "step_00000004"),
                             _port_template(), device="cpu")
    _assert_same(again, tree)


def test_both_packages_write_the_same_keys(tmp_path):
    tree = _jax_state()
    cfg = TC.get(ARCH, reduced=True)
    host = jax.tree.map(np.asarray, tree)
    port = {"params": lm_params_from_numpy(cfg, host["params"],
                                           device="cpu"),
            "opt": adamw_state_from_numpy(cfg, host["opt"], device="cpu")}
    JCKPT.save(str(tmp_path / "jax"), 1, tree)
    TCKPT.save(str(tmp_path / "port"), 1, port)
    metas, names = [], []
    for side in ("jax", "port"):
        d = tmp_path / side / "step_00000001"
        with open(d / "meta.json") as f:
            metas.append(json.load(f))
        with np.load(d / "shard_00000.npz") as z:
            names.append(list(z.files))
    assert metas[0] == metas[1]
    assert names[0] == names[1]      # the same keys, in the same order
    keys = metas[0]["keys"]
    for key in ("opt//.count", "opt//.m//embed",
                "params//stage//0//mlp//w_down@@bfloat16"):
        assert key in keys


def test_restore_latest_walks_past_incomplete(tmp_path):
    cfg = TC.get(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = TL.init_params(TLM.lm_spec(cfg), generator=gen)
    tree = {"params": params, "opt": TOPT.adamw_init(params)}
    TCKPT.save(str(tmp_path), 3, tree)
    TCKPT.save(str(tmp_path), 5, tree)
    os.remove(tmp_path / "step_00000005" / "meta.json")   # crashed commit
    os.makedirs(tmp_path / "step_00000009.tmp")          # crashed write
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000009")
    got, meta = TCKPT.restore_latest(str(tmp_path), _port_template(),
                                     device="cpu")
    assert meta["step"] == 3
    for a, b in zip(TL.leaves(got["params"]), TL.leaves(params)):
        assert torch.equal(a, b)
    assert TCKPT.restore_latest(str(tmp_path / "none"),
                                _port_template()) == (None, None)


def test_restore_refuses_another_model(tmp_path):
    """A checkpoint of another config is not restored into this one."""
    TCKPT.save(str(tmp_path), 1, {"params": {"embed": torch.zeros(3, 4)}})
    with pytest.raises(ValueError, match="shape"):
        TCKPT.restore(str(tmp_path / "step_00000001"),
                      {"params": {"embed": torch.zeros(5, 4)}},
                      device="cpu")
    assert TCKPT.restore_latest(
        str(tmp_path), {"params": {"embed": torch.zeros(5, 4)}},
        device="cpu") == (None, None)


def test_checkpointer_keeps_three(tmp_path):
    """The last three are kept, and each holds the values of its step
    though the tensor is updated in place while the writer runs."""
    ck = TCKPT.Checkpointer(str(tmp_path))
    x = torch.zeros(1 << 20)
    for step in range(5):
        x.fill_(float(step))
        ck.save_async(step, {"x": x})
    x.fill_(-1.0)
    ck.wait()
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003", "step_00000004"]
    for step in (2, 3, 4):
        got, meta = TCKPT.restore(str(tmp_path / f"step_{step:08d}"),
                                  {"x": x}, device="cpu")
        assert meta["step"] == step
        assert torch.equal(got["x"], torch.full_like(x, float(step)))
