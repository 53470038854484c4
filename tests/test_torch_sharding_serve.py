"""The port's sharded serving path against the JAX package's, both on a
("data", "model") = (2, 2) mesh (tests/_shard_reference.py): for all ten
reduced configs, float32 params placed by the sharding rules, the
prompt sharded over "data", the cache placed by ``cache_axes`` (batch
over "data", the KV sequence over "model"), then prefill and 6 greedy
decode steps through ``make_serve_fns(cfg, mesh)`` on each side.

Held: the prefill logits at rtol = atol = 1e-4 (xlstm-350m at its
F32_XLSTM, as its unsharded tests) and the placed cache (bf16 leaves at
one bf16 ulp, float32 states at the logits' tolerance); then each of the
6 decode steps from the reference's cache and token before it: its
logits at the same tolerance and the cache it leaves at one ulp (as
``tests/_lm_reference.py:bf16_cache_tol``); xlstm-350m's steps at
``STEP_TOL``, where the reference's own mesh and one-device runs of a
step (both computed here) disagree by more than its F32_XLSTM. The
caches are bf16 buffers even in a float32 run: the two sides sum in
other orders on the mesh, so a value that lies near a bf16 rounding
boundary can round to the neighbouring bf16 on one side, and a step run
from such a cache moves the logits by up to 6e-3 (gemma3-27b). The
greedy tokens of each side's own free-running decode must be equal, and
``greedy_generate(mesh=)``'s too. The reference runs in one subprocess
with 4 forced host devices, then the port in 4 gloo rank processes that
import no JAX. Every rank must hold the same gathered values.
"""
import pytest

import _shard_reference as R
import numpy as np
import torch

from _lm_reference import F32, F32_XLSTM, bf16_cache_tol
from repro_torch import configs as TC
from repro_torch.models import lm as TLM

ARCHS = list(TC.ARCH_IDS)
ENCDEC = "seamless-m4t-medium"
F32_TOL = {"xlstm-350m": F32_XLSTM}
# xlstm-350m's decode steps on the mesh: each mLSTM step rounds its conv
# input to bf16 inside the step, and a float32 sum taken in another order
# can round one value to the neighbouring bf16, which 16 gated layers
# carry to the logits. The reference's own mesh and one-device runs of
# the same step lie up to 1.37e-2 apart (step 4), the port up to 3.93e-2
# from the reference's mesh run (step 5) and its float32 states up to
# 4.7e-3; every other config lies within 2.1e-5. Held at twice the
# port's reading.
STEP_TOL = {"xlstm-350m": dict(rtol=1e-4, atol=8e-2)}

_JAX = r"""
from repro import configs as JC, sharding as JSH
from repro.models import encdec as JED, layers as JL, lm as JLM
from repro.serve import engine as JS
from repro_torch import configs as TC
from repro_torch.models import lm as TLM
import _shard_reference as R
ENCDEC = {encdec!r}

def put(x, logical):
    spec = JSH.logical_to_spec(MESH, logical, x.shape)
    return jax.device_put(x, NamedSharding(MESH, spec))

out = {{}}
for arch in {archs!r}:
    cfg = JC.get(arch, reduced=True)
    spec = JLM.lm_spec(cfg)
    params = jax.tree.map(jnp.asarray, R.numpy_params(
        TLM.lm_spec(TC.get(arch, reduced=True))))
    one = params                      # the one-device run's
    _, decode_one, _ = JS.make_serve_fns(cfg, None, batch=R.B,
                                         max_len=R.MAX_LEN)
    params = jax.device_put(params, JSH.param_sharding_rules(
        MESH, JL.abstract_params(spec), JL.axes_tree(spec)))
    tokens, prefix = R.serve_inputs(cfg)
    if prefix is not None:
        prefix = put(jnp.asarray(prefix), ("batch", None, None))
    prefill, decode, init_cache = JS.make_serve_fns(
        cfg, MESH, batch=R.B, max_len=R.MAX_LEN)
    logits, pre = prefill(params, put(jnp.asarray(tokens[:, :R.T]),
                                      ("batch", None)), prefix)
    cache = JS.place_prefill_cache(cfg, pre, init_cache(), R.T)
    cache = jax.device_put(cache, JSH.param_sharding_rules(
        MESH, JLM.abstract_cache(cfg, R.B, R.MAX_LEN),
        JLM.cache_axes(cfg, R.B, R.MAX_LEN)))
    out[arch + "/prefill"] = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks, pos = [tok], R.serve_start(cfg)
    for i in range(R.STEPS):
        for k, a in R.flat(cache).items():
            out[f"{{arch}}/cache{{i}}/{{k}}"] = np.asarray(a, np.float32)
        host = jax.tree.map(jnp.asarray, jax.device_get(cache))
        out[f"{{arch}}/one{{i}}"] = np.asarray(
            decode_one(one, host, tok, jnp.int32(pos + i))[0], np.float32)
        logits, cache = decode(params, cache, put(tok, ("batch", None)),
                               jnp.int32(pos + i))
        out[f"{{arch}}/step{{i}}"] = np.asarray(logits, np.float32)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(tok)
    for k, a in R.flat(cache).items():
        out[f"{{arch}}/cache{{R.STEPS}}/{{k}}"] = np.asarray(a, np.float32)
    out[arch + "/greedy"] = np.concatenate([np.asarray(t) for t in toks], 1)

# the encoder-decoder's own serving path: encode, the cross cache, decode
cfg = JC.get(ENCDEC, reduced=True)
spec = JED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
params = jax.device_put(jax.tree.map(jnp.asarray, R.numpy_params(
    R.param_spec(TC.get(ENCDEC, reduced=True)))), JSH.param_sharding_rules(
        MESH, JL.abstract_params(spec), JL.axes_tree(spec)))
frames = put(jnp.asarray(R.frames(cfg)), ("batch", None, None))
enc = jax.jit(lambda p, f: JED.encode(p, f, cfg, MESH))(params, frames)
out["encdec/enc"] = np.asarray(enc, np.float32)
args = (cfg, cfg.n_dec, R.B, R.MAX_LEN, R.T)
cache = JED.fill_cross_cache(params, enc, JED.init_encdec_cache(*args), cfg)
cache = jax.device_put(cache, JSH.param_sharding_rules(
    MESH, JED.abstract_encdec_cache(*args), JED.encdec_cache_axes(*args)))
step = jax.jit(lambda p, c, t, i: JED.encdec_decode_step(p, c, t, i, cfg,
                                                         MESH))
tok = jnp.full((R.B, 1), R.START, jnp.int32)
toks = [tok]
for i in range(R.STEPS):
    for k, a in cache.items():
        out[f"encdec/cache{{i}}/{{k}}"] = np.asarray(a, np.float32)
    logits, cache = step(params, cache, put(tok, ("batch", None)),
                         jnp.int32(i))
    out[f"encdec/step{{i}}"] = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks.append(tok)
for k, a in cache.items():
    out[f"encdec/cache{{R.STEPS}}/{{k}}"] = np.asarray(a, np.float32)
out["encdec/greedy"] = np.concatenate([np.asarray(t) for t in toks], 1)
np.savez({out!r}, **out)
print("JAX-OK")
"""

_RANKS = r"""
import _shard_reference as R
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as SE

want = R.load({jax!r})
out = {{}}
for arch in {archs!r}:
    cfg = TC.get(arch, reduced=True)
    params = lm_params_from_numpy(cfg, R.numpy_params(TLM.lm_spec(cfg)),
                                  mesh=MESH)
    assert all(SE.SH.is_dtensor(t) for t in TLM.L.leaves(params))
    tokens, prefix = R.serve_inputs(cfg)
    if prefix is not None:
        prefix = torch.from_numpy(prefix)
    prefill, decode, init_cache = SE.make_serve_fns(
        cfg, MESH, batch=R.B, max_len=R.MAX_LEN)
    # free-running: its own prefill, cache and greedy tokens
    logits, pre = prefill(params, tokens[:, :R.T], prefix)
    cache = SE.place_prefill_cache(cfg, pre, init_cache(), R.T)
    out[arch + "/prefill"] = logits.full_tensor().numpy()
    for k, a in R.flat(cache).items():
        out[f"{{arch}}/cache0/{{k}}"] = a.full_tensor().float().numpy()
    tok = SE.greedy_token(logits)
    toks, pos = [tok], R.serve_start(cfg)
    for i in range(R.STEPS):
        logits, cache = decode(params, cache, tok, torch.tensor([pos + i]))
        tok = SE.greedy_token(logits)
        toks.append(tok)
    out[arch + "/greedy"] = torch.cat(toks, 1).numpy()
    if arch in ("qwen3-4b", "deepseek-moe-16b"):
        # the end-to-end entry point (no prefix: it starts where this
        # loop does)
        out[arch + "/generate"] = SE.greedy_generate(
            cfg, params, tokens[:, :R.T], num_new=R.STEPS + 1, mesh=MESH)
    # each step from the reference's cache and token before it
    for i in range(R.STEPS):
        cache = init_cache()
        for k, buf in R.flat(cache).items():
            SE.SH.paste(buf, torch.from_numpy(
                want[f"{{arch}}/cache{{i}}/{{k}}"]).to(buf.dtype))
        tok = torch.from_numpy(want[arch + "/greedy"][:, i:i + 1])
        logits, cache = decode(params, cache, tok, torch.tensor([pos + i]))
        out[f"{{arch}}/step{{i}}"] = logits.full_tensor().numpy()
        for k, a in R.flat(cache).items():
            out[f"{{arch}}/cache{{i + 1}}/{{k}}"] = (
                a.full_tensor().float().numpy())

# the encoder-decoder: encode and the cross cache on its own, each decode
# step from the reference's cache and token before it
from repro_torch.models import encdec as TED
cfg = TC.get({encdec!r}, reduced=True)
params = lm_params_from_numpy(cfg, R.numpy_params(R.param_spec(cfg)),
                              mesh=MESH)
args = (cfg, cfg.n_dec, R.B, R.MAX_LEN, R.T)

def encdec_cache():
    c = TED.init_encdec_cache(*args, device="cpu")
    return SE.SH.place_tree(MESH, c, SE.SH.param_sharding_rules(
        MESH, c, TED.encdec_cache_axes(*args)))

with torch.no_grad():
    enc = TED.encode(params, torch.from_numpy(R.frames(cfg)), cfg, MESH)
    out["encdec/enc"] = enc.full_tensor().numpy()
    cache = TED.fill_cross_cache(params, enc, encdec_cache(), cfg)
    for k, a in cache.items():
        out["encdec/cache0/" + k] = a.full_tensor().float().numpy()
    for i in range(R.STEPS):
        cache = encdec_cache()
        for k, buf in cache.items():
            SE.SH.paste(buf, torch.from_numpy(
                want[f"encdec/cache{{i}}/{{k}}"]).to(buf.dtype))
        tok = torch.from_numpy(want["encdec/greedy"][:, i:i + 1]).long()
        logits, cache = TED.encdec_decode_step(params, cache, tok,
                                               torch.tensor([i]), cfg, MESH)
        out[f"encdec/step{{i}}"] = logits.full_tensor().numpy()
        for k, a in cache.items():
            out[f"encdec/cache{{i + 1}}/{{k}}"] = (
                a.full_tensor().float().numpy())
np.savez({out!r}.format(rank=RANK), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_serve")
    wall = R.finish(R.start(_JAX.format(archs=ARCHS, encdec=ENCDEC,
                                        out=str(tmp / "jax.npz"))), 600)
    wall += R.finish(R.start(rank_body=_RANKS.format(
        archs=ARCHS, encdec=ENCDEC, jax=str(tmp / "jax.npz"),
        out=str(tmp / "rank{rank}.npz")), tmp=tmp), 600)
    print(f"sharded serving, reference then port: {wall:.1f} s")
    return (R.load(tmp / "jax.npz"),
            [R.load(tmp / f"rank{r}.npz") for r in range(R.WORLD)])


def _dtypes(arch):
    """Cache leaf -> its buffer dtype."""
    cfg = TC.get(arch, reduced=True)
    return {k: a.dtype for k, a in R.flat(
        TLM.abstract_cache(cfg, R.B, R.MAX_LEN)).items()}


def _cache_tol(arch, dtype, step):
    """A cache leaf after ``step`` decode steps: bf16 buffers at one bf16
    ulp (``bf16_cache_tol``), float32 states at the logits' tolerance;
    after a step of an arch in ``STEP_TOL``, its atol too."""
    tol = (bf16_cache_tol(arch) if dtype == torch.bfloat16
           else F32_TOL.get(arch, F32))
    if step and arch in STEP_TOL:
        tol = dict(tol, atol=STEP_TOL[arch]["atol"])
    return tol


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_jax_sharded(runs, arch):
    want, ranks = runs
    tol = F32_TOL.get(arch, F32)
    step_tol = STEP_TOL.get(arch, tol)
    dtypes = _dtypes(arch)
    own = max(np.abs(want[f"{arch}/one{i}"] - want[f"{arch}/step{i}"]).max()
              for i in range(R.STEPS))
    if arch in STEP_TOL:    # the reference's own runs differ that much
        assert own > tol["atol"], own
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[arch + "/prefill"],
                                   want[arch + "/prefill"], **tol,
                                   err_msg=f"rank {rank} prefill")
        for i in range(R.STEPS + 1):
            for k, dt in dtypes.items():
                key = f"{arch}/cache{i}/{k}"
                np.testing.assert_allclose(
                    got[key], want[key], **_cache_tol(arch, dt, i),
                    err_msg=f"rank {rank} {key}")
            if i < R.STEPS:
                key = f"{arch}/step{i}"
                np.testing.assert_allclose(got[key], want[key], **step_tol,
                                           err_msg=f"rank {rank} {key}")
        np.testing.assert_array_equal(got[arch + "/greedy"],
                                      want[arch + "/greedy"])
        if arch + "/generate" in got:
            np.testing.assert_array_equal(got[arch + "/generate"],
                                          want[arch + "/greedy"])


def test_sharded_encdec_serving_matches_jax_sharded(runs):
    """seamless-m4t-medium's own serving path on the mesh: ``encode``,
    ``fill_cross_cache`` into a cache placed by ``encdec_cache_axes`` and
    ``encdec_decode_step``, each step from the reference's cache and
    token before it."""
    want, ranks = runs
    cfg = TC.get(ENCDEC, reduced=True)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["encdec/enc"], want["encdec/enc"],
                                   **F32, err_msg=f"rank {rank} encode")
        for i in range(R.STEPS + 1):
            for k in ("self_k", "self_v", "cross_k", "cross_v"):
                key = f"encdec/cache{i}/{k}"
                np.testing.assert_allclose(
                    got[key], want[key], **bf16_cache_tol(ENCDEC),
                    err_msg=f"rank {rank} {key}")
            if i < R.STEPS:
                key = f"encdec/step{i}"
                np.testing.assert_allclose(got[key], want[key], **F32,
                                           err_msg=f"rank {rank} {key}")
        assert got[f"encdec/step{R.STEPS - 1}"].shape[-1] == cfg.vocab_padded
