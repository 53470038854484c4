"""The JAX package's serving run on the reduced dense configs, shared by
tests/test_torch_serve.py and tests/test_torch_generate.py: prefill, the
placed cache, then STEPS greedy decode steps at the positions of the
reference's own consistency test (T + prefix_len on), cached per (arch,
dtype) within a test process."""
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

DENSE = list(TC.DENSE_IDS)
F32 = dict(rtol=1e-4, atol=1e-4)
ULP = dict(rtol=2 ** -7, atol=1e-6)   # one bf16 ulp
# tests/test_models.py's prefill/decode tolerance for bf16 logits
BF16 = dict(rtol=0.1, atol=0.75)
B, T, STEPS = 2, 12, 6
MAX_LEN = 32

_REFS = {}


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


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
    if key in _REFS:
        return _REFS[key]
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
    _REFS[key] = ref
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


def torch_tree(tree, dtype=torch.bfloat16):
    return TL.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                       tree)


def assert_tree(got, want, **tol):
    flat_g, flat_w = [], []
    TL.tree_map(lambda g, w: (flat_g.append(g), flat_w.append(w)), got,
                want)
    assert flat_g
    for g, w in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, **tol)


def margin_tol(logits):
    """JAX's top-1 margin and the tolerance at its top-1 logit."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0], BF16["atol"] + BF16["rtol"] * np.abs(
        top2[..., 1])
