"""The JAX package's serving run on the reduced configs, shared by
tests/test_torch_serve.py and tests/test_torch_generate.py: prefill, the
placed cache, then STEPS greedy decode steps at the positions of the
reference's own consistency test (T + prefix_len on), cached per (arch,
dtype) within a test process."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JS
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL

# every arch through the decoder-only serving path (an enc-dec config is
# its decoder stack there, in the reference too)
ARCHS = list(TC.ARCH_IDS)
F32 = dict(rtol=1e-4, atol=1e-4)
ULP = dict(rtol=2 ** -7, atol=1e-6)   # one bf16 ulp
# tests/test_models.py's prefill/decode tolerance for bf16 logits
BF16 = dict(rtol=0.1, atol=0.75)
# xlstm-350m: 16 layers of exponentially gated recurrence amplify
# rounding. In float32 the reference's own jitted and eager logits differ
# by 1.4e-4, and the port lies 2.2e-4 from the jitted run (0.05 % of the
# logits beyond 1e-4): its float32 logits are held at atol 5e-4. In bf16
# the jitted reference (XLA keeps bf16 chains in float32 inside a fusion)
# lies up to 5.9 from its own eager run, 12.6 % of the logits outside
# tests/test_models.py's tolerance; the port rounds op by op as the eager
# run does, so its bf16 reference is the eager one (jax.disable_jit).
EAGER_BF16 = ("xlstm-350m",)
F32_XLSTM = dict(rtol=1e-4, atol=5e-4)
B, T, STEPS = 2, 12, 6
MAX_LEN = 32

_REFS = {}


def _to_np(tree):
    """Host numpy leaves, each in its dtype (bfloat16 stays bfloat16)."""
    return jax.tree.map(np.asarray, tree)


def f32_tol(arch):
    return F32_XLSTM if arch in EAGER_BF16 else F32


def bf16_cache_tol(arch):
    """A bf16 cache leaf of a float32 run: one bf16 ulp; for EAGER_BF16,
    or its float32 tolerance where a near-zero float32 value lies farther
    than an ulp of it."""
    if arch in EAGER_BF16:
        return dict(ULP, atol=F32_XLSTM["atol"])
    return ULP


def jax_mode(arch, dtype):
    """How JAX runs the reference for (arch, dtype): eagerly for the
    bf16 runs of EAGER_BF16, else compiled."""
    if dtype == "bf16" and arch in EAGER_BF16:
        return jax.disable_jit()
    return contextlib.nullcontext()


def inputs(cfg):
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab, (B, T + 1)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return tokens, prefix


def start(cfg):
    """The first decode position: after the prompt and any prefix."""
    return T + (cfg.prefix_len if cfg.family == "vlm" else 0)


def reference(arch, dtype):
    """JAX's run for ``arch`` with params in ``dtype`` ("f32" or
    "bf16"): a dict of numpy arrays (params, tokens, prefix, prefill
    logits and cache, placed cache, the cache after one step, each step's
    logits, the greedy tokens)."""
    key = (arch, dtype)
    if key not in _REFS:
        with jax_mode(arch, dtype):
            _REFS[key] = _run(arch, dtype)
    return _REFS[key]


def _run(arch, dtype):
    cfg = JC.get(arch, reduced=True)
    params = JL.init_params(jax.random.PRNGKey(0), JLM.lm_spec(cfg))
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tokens, prefix = inputs(cfg)
    jprefix = None if prefix is None else jnp.asarray(
        prefix, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    prefill, decode, init_cache = JS.make_serve_fns(cfg, None, batch=B,
                                                    max_len=MAX_LEN)
    logits, pre = prefill(params, tokens[:, :T], jprefix)
    cache = JS.place_prefill_cache(cfg, pre, init_cache(), T)
    ref = {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "prefix": prefix, "pre_logits": np.asarray(logits),
           "pre_cache": _to_np(pre), "placed": _to_np(cache)}
    step_logits, toks = [], []
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    pos = start(cfg)
    for i in range(STEPS):
        toks.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, jnp.int32(pos + i))
        if i == 0:
            ref["after_one"] = _to_np(cache)
        step_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks.append(np.asarray(tok))
    ref["step_logits"] = step_logits
    ref["greedy"] = np.concatenate(toks, axis=1)
    return ref


def port(arch, ref):
    """The port's reduced config, JAX's params converted onto the CPU,
    and the prefix as a tensor of the params' dtype."""
    cfg = TC.get(arch, reduced=True)
    params = lm_params_from_numpy(cfg, ref["params"], device="cpu")
    prefix = ref["prefix"]
    if prefix is not None:
        prefix = torch.from_numpy(prefix).to(params["embed"].dtype)
    return cfg, params, prefix


def _dtype(a):
    return torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32


def torch_tree(tree):
    """numpy leaves as tensors of their dtype (float32 or bfloat16)."""
    return TL.tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(_dtype(a)), tree)


def assert_tree(got, want, *, f32=F32, bf16=ULP):
    """Every leaf of ``got`` has ``want``'s shape and dtype and agrees
    with it: float32 leaves to ``f32``, bfloat16 ones to ``bf16``."""
    flat_g, flat_w = [], []
    TL.tree_map(lambda g, w: (flat_g.append(g), flat_w.append(w)), got,
                want)
    assert flat_g
    for g, w in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape
        assert g.dtype == _dtype(w)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32),
            **(bf16 if g.dtype == torch.bfloat16 else f32))


def margin_tol(logits):
    """JAX's top-1 margin and the tolerance at its top-1 logit."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0], BF16["atol"] + BF16["rtol"] * np.abs(
        top2[..., 1])
