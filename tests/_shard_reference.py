"""Running the JAX package's sharded LM path and the port's side by side,
shared by tests/test_torch_sharding_*.py. Imports no JAX: the rank
processes import this module.

Both sides start from the same numbers: params drawn with numpy from a
seed over the port's spec tree (``numpy_params``; the reference's spec
tree has the same keys, shapes and initializers), the serving prompt of
``tests/_lm_reference.py`` and the training batch of
``tests/_train_reference.py``.

* the reference: one subprocess with 4 forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set before
  JAX starts) on a ``("data", "model") = (2, 2)`` mesh, its params and
  inputs placed by ``repro.sharding``;
* the port: 4 gloo rank processes meeting through a ``file://`` store
  under the test's temporary directory, each with a (2, 2)
  ``DeviceMesh``; they import no JAX (each asserts it).

``start`` takes another mesh (shape, axis names) for both sides: as many
forced devices and rank processes as it has ranks.

``start`` launches either side or both at once (the serving test runs
the reference first: the port's decode steps start from its caches);
``finish`` waits for them to a deadline and kills any process not done
by then.
"""
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
MESH = ((2, 2), ("data", "model"))
# the serving run of tests/_lm_reference.py
B, T, STEPS, MAX_LEN = 2, 12, 6, 32
START = 1           # the enc-dec decoder's first token
# the training run of tests/_train_reference.py
TRAIN_B, TRAIN_S, TRAIN_STEP = 4, 16, 1
OPT = dict(lr_peak=1e-3, warmup_steps=3, total_steps=30)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def numpy_params(spec_tree, seed: int = 0):
    """float32 params for a spec tree of ``PSpec`` leaves, drawn in sorted
    key order: normal with std 1/sqrt(fan_in) (the second-to-last dim
    unless given), std 1 for ``embed``, zeros and ones."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in _leaves(spec_tree):
        if s.init == "zeros":
            a = np.zeros(s.shape, np.float32)
        elif s.init == "ones":
            a = np.ones(s.shape, np.float32)
        else:
            a = rng.standard_normal(s.shape, dtype=np.float32)
            if s.init != "embed":
                fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2
                                      else s.shape[-1])
                a *= np.float32(1.0 / math.sqrt(max(1, fan_in)))
        flat[path] = a
    return unflat(flat)


def unflat(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def flat(tree):
    """Nested dicts -> {"a//b": leaf}, in sorted key order."""
    return {"//".join(p): a for p, a in _leaves(tree)}


def param_spec(cfg):
    """The port's spec tree of ``cfg``'s trained params: the enc-dec tree
    for an encoder-decoder, else the decoder-only one."""
    from repro_torch.models import encdec as TED
    from repro_torch.models import lm as TLM
    if cfg.family == "encdec":
        return TED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
    return TLM.lm_spec(cfg)


def serve_inputs(cfg):
    """tests/_lm_reference.py's prompt (B, T + 1) and VLM prefix."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab, (B, T + 1)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return tokens, prefix


def frames(cfg):
    """The enc-dec's stub encoder input (B, T, d_model), float32."""
    return np.random.default_rng(4).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def serve_start(cfg):
    """The first decode position: after the prompt and any prefix."""
    return T + (cfg.prefix_len if cfg.family == "vlm" else 0)


def train_batch(cfg):
    """tests/_train_reference.py's float32 batch (SyntheticTokens' batch
    0 and the family's stub embeddings)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    b = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=TRAIN_B,
                                   seq_len=TRAIN_S)).batch(0)
    rng = np.random.default_rng(5)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (TRAIN_B, cfg.prefix_len, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((TRAIN_B, TRAIN_S, cfg.d_model),
                                          dtype=np.float32)
    return b


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

RANK_PRELUDE = r"""
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(sys.argv[1])
dist.init_process_group("gloo", init_method={init!r}, world_size={world},
                        rank=RANK)
from torch.distributed.device_mesh import init_device_mesh
MESH = init_device_mesh("cpu", {shape!r}, mesh_dim_names={names!r})
"""

RANK_EPILOGUE = r"""
dist.destroy_process_group()
assert "jax" not in sys.modules and "repro" not in sys.modules
print("RANK-OK")
"""

JAX_PRELUDE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import compat_make_mesh
MESH = compat_make_mesh({shape!r}, {names!r})
"""


def world(mesh=MESH) -> int:
    """The ranks of a mesh (shape, names)."""
    return math.prod(mesh[0])


def rank_script(body: str, tmp, mesh=MESH) -> str:
    fmt = dict(src=SRC, tests=HERE, init=f"file://{tmp}/store",
               world=world(mesh), shape=mesh[0], names=mesh[1])
    return (RANK_PRELUDE.format(**fmt) + body + RANK_EPILOGUE)


def jax_script(body: str, mesh=MESH) -> str:
    return JAX_PRELUDE.format(src=SRC, tests=HERE, world=world(mesh),
                              shape=mesh[0], names=mesh[1]) + body


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
            "PYTHONWARNINGS": "ignore"}


def start(jax_body=None, rank_body=None, tmp=None, mesh=MESH):
    """Start the JAX subprocess (``jax_body``) and the rank processes
    (``rank_body``, with ``tmp`` for their store) on ``mesh`` (shape,
    axis names; (2, 2) unless given); returns the processes."""
    procs = []
    if jax_body is not None:
        procs.append(("jax", subprocess.Popen(
            [sys.executable, "-c", jax_script(jax_body, mesh)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env())))
    if rank_body is not None:
        script = rank_script(rank_body, tmp, mesh)
        for r in range(world(mesh)):
            procs.append((f"rank{r}", subprocess.Popen(
                [sys.executable, "-c", script, str(r)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env())))
    return procs


def finish(procs, timeout: float):
    """Wait for every process (killing all of them at the deadline);
    assert each exited 0 and said so. Returns the wall seconds."""
    t0 = time.monotonic()
    deadline = t0 + timeout
    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (name, p), (stdout, stderr) in zip(procs, outs):
        ok = "JAX-OK" if name == "jax" else "RANK-OK"
        assert p.returncode == 0 and ok in stdout, (name, stderr[-4000:])
    return time.monotonic() - t0


def load(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
