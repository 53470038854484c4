"""The port's sharded LM path on meshes whose "model" axis does not divide
the head count, against the JAX package's (tests/_shard_reference.py
with the mesh as a parameter: 8 forced host devices for the reference, 8
gloo rank processes for the port).

* (2, 4): the reduced qwen3-4b (4 query heads, 2 kv heads: the kv heads
  are replicated over "model") serves (prefill, then 6 decode steps,
  each from the reference's cache and token before it) and takes one
  float32 train step.
* (1, 8): the same for the reduced xlstm-350m (2 heads: its mLSTM and
  sLSTM recurrences run whole heads on every "model" rank), and serving
  for deepseek-v2-236b (MLA, 4 heads) and seamless-m4t-medium (the
  enc-dec's own path: encode, the cross cache, decode).

Held at the (2, 2) files' tolerances: the logits and float32 states at
rtol = atol = 1e-4 (xlstm-350m at F32_XLSTM, its decode steps at
STEP_TOL), bf16 cache leaves at one ulp, the greedy tokens equal; the
train step as tests/test_torch_sharding_train.py holds it (xlstm-350m's
gradients at its float32 training tolerance, ``f32_tol``).

Then the full configs' forward on the production (16, 16) mesh: a fake
256-rank group in this process (``launch.mesh.dryrun_world``), params as
``meta`` DTensors placed by the rules, every config.
"""
import numpy as np
import pytest
import torch

import _shard_reference as R
import _train_reference as TR
from _lm_reference import F32, bf16_cache_tol
from repro_torch import configs as TC
from repro_torch.models import lm as TLM
from test_torch_sharding_serve import F32_TOL, STEP_TOL

MESHES = {
    "2x4": (((2, 4), ("data", "model")),
            dict(serve=["qwen3-4b"], train=["qwen3-4b"], encdec=False)),
    "1x8": (((1, 8), ("data", "model")),
            dict(serve=["xlstm-350m", "deepseek-v2-236b"],
                 train=["xlstm-350m"], encdec=True)),
}
ENCDEC = "seamless-m4t-medium"
NAMES = ("grads", "new_params", "m", "v")

_JAX = r"""
import _train_reference as TR
from repro import configs as JC, sharding as JSH
from repro.models import encdec as JED, layers as JL, lm as JLM
from repro.serve import engine as JS
from repro.train import loop as JLOOP, optimizer as JOPT
from repro_torch import configs as TC
from repro_torch.models import lm as TLM
import _shard_reference as R

def put(x, logical):
    spec = JSH.logical_to_spec(MESH, logical, x.shape)
    return jax.device_put(x, NamedSharding(MESH, spec))

def placed(spec, arch):
    shard = JSH.param_sharding_rules(MESH, JL.abstract_params(spec),
                                     JL.axes_tree(spec))
    return jax.device_put(jax.tree.map(jnp.asarray, R.numpy_params(
        R.param_spec(TC.get(arch, reduced=True)))), shard), shard

out = {{}}
for arch in {serve!r}:
    cfg = JC.get(arch, reduced=True)
    params, _ = placed(JLM.lm_spec(cfg), arch)
    tokens, prefix = R.serve_inputs(cfg)
    prefill, decode, init_cache = JS.make_serve_fns(
        cfg, MESH, batch=R.B, max_len=R.MAX_LEN)
    logits, pre = prefill(params, put(jnp.asarray(tokens[:, :R.T]),
                                      ("batch", None)), None)
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
        logits, cache = decode(params, cache, put(tok, ("batch", None)),
                               jnp.int32(pos + i))
        out[f"{{arch}}/step{{i}}"] = np.asarray(logits, np.float32)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(tok)
    for k, a in R.flat(cache).items():
        out[f"{{arch}}/cache{{R.STEPS}}/{{k}}"] = np.asarray(a, np.float32)
    out[arch + "/greedy"] = np.concatenate([np.asarray(t) for t in toks], 1)

if {encdec!r}:
    cfg = JC.get({encdec_arch!r}, reduced=True)
    params, _ = placed(JED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec),
                       {encdec_arch!r})
    frames = put(jnp.asarray(R.frames(cfg)), ("batch", None, None))
    enc = jax.jit(lambda p, f: JED.encode(p, f, cfg, MESH))(params, frames)
    out["encdec/enc"] = np.asarray(enc, np.float32)
    args = (cfg, cfg.n_dec, R.B, R.MAX_LEN, R.T)
    cache = JED.fill_cross_cache(params, enc, JED.init_encdec_cache(*args),
                                 cfg)
    cache = jax.device_put(cache, JSH.param_sharding_rules(
        MESH, JED.abstract_encdec_cache(*args), JED.encdec_cache_axes(*args)))
    step = jax.jit(lambda p, c, t, i: JED.encdec_decode_step(p, c, t, i,
                                                             cfg, MESH))
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

oc = JOPT.AdamWConfig(**R.OPT)
with TR.exact_float32():
    for arch in {train!r}:
        cfg = JC.get(arch, reduced=True)
        params, shard = placed(JLM.lm_spec(cfg), arch)
        state = JOPT.adamw_init(params)
        state = JOPT.AdamWState(m=jax.device_put(state.m, shard),
                                v=jax.device_put(state.v, shard),
                                count=state.count)
        batch = {{k: put(jnp.asarray(v), ("batch",) + (None,) * (v.ndim - 1))
                  for k, v in R.train_batch(TC.get(arch, reduced=True)).items()}}
        loss_fn = JLOOP.make_loss(cfg, MESH)

        def train_step(params, state, batch, step):
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            clipped, gnorm = JOPT.clip_by_global_norm(grads, oc.clip_norm)
            new_p, new_s = JOPT.adamw_update(clipped, state, params, oc, step)
            return loss, grads, gnorm, new_p, new_s

        loss, grads, gnorm, new_p, new_s = jax.jit(train_step)(
            params, state, batch, jnp.int32(R.TRAIN_STEP))
        out[arch + "/loss"] = np.asarray(loss)
        out[arch + "/grad_norm"] = np.asarray(gnorm)
        for name, tree in (("grads", grads), ("new_params", new_p),
                           ("m", new_s.m), ("v", new_s.v)):
            for k, a in R.flat(tree).items():
                out[f"{{arch}}/{{name}}/{{k}}"] = np.asarray(a, np.float32)
np.savez({out!r}, **out)
print("JAX-OK")
"""

_RANKS = r"""
import _shard_reference as R
from repro_torch import configs as TC
from repro_torch import sharding as SH
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import encdec as TED, layers as TL, lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.serve import engine as SE
from repro_torch.train import loop as TLOOP, optimizer as TOPT

want = R.load({jax!r})
out = {{}}

def host(t):
    # a copy: a block that is the whole tensor is the buffer itself, and
    # decode writes the buffers in place
    return t.full_tensor().float().numpy().copy()

def full(tree, prefix):
    for k, a in R.flat(tree).items():
        assert SH.is_dtensor(a), (prefix, k)
        out[prefix + k] = host(a)

for arch in {serve!r}:
    cfg = TC.get(arch, reduced=True)
    params = lm_params_from_numpy(cfg, R.numpy_params(TLM.lm_spec(cfg)),
                                  mesh=MESH)
    tokens, _ = R.serve_inputs(cfg)
    prefill, decode, init_cache = SE.make_serve_fns(
        cfg, MESH, batch=R.B, max_len=R.MAX_LEN)
    logits, pre = prefill(params, tokens[:, :R.T], None)
    cache = SE.place_prefill_cache(cfg, pre, init_cache(), R.T)
    out[arch + "/prefill"] = host(logits)
    for k, a in R.flat(cache).items():
        out[f"{{arch}}/cache0/{{k}}"] = host(a)
    tok = SE.greedy_token(logits)
    toks, pos = [tok], R.serve_start(cfg)
    for i in range(R.STEPS):
        logits, cache = decode(params, cache, tok, torch.tensor([pos + i]))
        tok = SE.greedy_token(logits)
        toks.append(tok)
    out[arch + "/greedy"] = torch.cat(toks, 1).numpy()
    for i in range(R.STEPS):
        cache = init_cache()
        for k, buf in R.flat(cache).items():
            SH.paste(buf, torch.from_numpy(
                want[f"{{arch}}/cache{{i}}/{{k}}"]).to(buf.dtype))
        tok = torch.from_numpy(want[arch + "/greedy"][:, i:i + 1])
        logits, cache = decode(params, cache, tok, torch.tensor([pos + i]))
        out[f"{{arch}}/step{{i}}"] = host(logits)
        for k, a in R.flat(cache).items():
            out[f"{{arch}}/cache{{i + 1}}/{{k}}"] = host(a)

if {encdec!r}:
    cfg = TC.get({encdec_arch!r}, reduced=True)
    params = lm_params_from_numpy(cfg, R.numpy_params(R.param_spec(cfg)),
                                  mesh=MESH)
    args = (cfg, cfg.n_dec, R.B, R.MAX_LEN, R.T)

    def encdec_cache():
        c = TED.init_encdec_cache(*args, device="cpu")
        return SH.place_tree(MESH, c, SH.param_sharding_rules(
            MESH, c, TED.encdec_cache_axes(*args)))

    with torch.no_grad():
        enc = TED.encode(params, torch.from_numpy(R.frames(cfg)), cfg, MESH)
        out["encdec/enc"] = host(enc)
        cache = TED.fill_cross_cache(params, enc, encdec_cache(), cfg)
        for k, a in cache.items():
            out["encdec/cache0/" + k] = host(a)
        for i in range(R.STEPS):
            cache = encdec_cache()
            for k, buf in cache.items():
                SH.paste(buf, torch.from_numpy(
                    want[f"encdec/cache{{i}}/{{k}}"]).to(buf.dtype))
            tok = torch.from_numpy(want["encdec/greedy"][:, i:i + 1]).long()
            logits, cache = TED.encdec_decode_step(
                params, cache, tok, torch.tensor([i]), cfg, MESH)
            out[f"encdec/step{{i}}"] = host(logits)
            for k, a in cache.items():
                out[f"encdec/cache{{i + 1}}/{{k}}"] = host(a)

# tests/_train_reference.py's exact_float32: the cast as the identity
TL.grad_cast_bf16 = TMOE.grad_cast_bf16 = lambda x: x
oc = TOPT.AdamWConfig(**R.OPT)
for arch in {train!r}:
    cfg = TC.get(arch, reduced=True)
    params = lm_params_from_numpy(cfg, R.numpy_params(R.param_spec(cfg)),
                                  mesh=MESH)
    state = TOPT.adamw_init(params)
    batch = R.train_batch(cfg)
    loss, grads = TLOOP.value_and_grad(
        TLOOP.make_loss(cfg, MESH), params,
        TLOOP.batch_on(batch, "cpu", MESH), MESH)
    full(grads, arch + "/grads/")
    params, state, mt = TLOOP.make_train_step(cfg, oc, MESH)(
        params, state, batch, R.TRAIN_STEP)
    out[arch + "/loss"] = np.asarray([float(loss), float(mt["loss"])])
    out[arch + "/grad_norm"] = np.asarray(float(mt["grad_norm"]))
    full(params, arch + "/new_params/")
    full(state.m, arch + "/m/")
    full(state.v, arch + "/v/")
np.savez({out!r}.format(rank=RANK), **out)
"""


def _run(tmp, name):
    mesh, what = MESHES[name]
    fmt = dict(what, jax=str(tmp / "jax.npz"), encdec_arch=ENCDEC)
    wall = R.finish(R.start(_JAX.format(out=fmt["jax"], **fmt), mesh=mesh),
                    600)
    wall += R.finish(R.start(rank_body=_RANKS.format(
        out=str(tmp / "rank{rank}.npz"), **fmt), tmp=tmp, mesh=mesh), 600)
    print(f"{name}: reference then port, {wall:.1f} s")
    return (R.load(tmp / "jax.npz"),
            [R.load(tmp / f"rank{r}.npz") for r in range(R.world(mesh))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(tmp_path_factory.mktemp(f"wide{name}"), name)
        return cache[name]
    return get


def _cache_tol(arch, dtype, step):
    tol = (bf16_cache_tol(arch) if dtype == torch.bfloat16
           else F32_TOL.get(arch, F32))
    if step and arch in STEP_TOL:
        tol = dict(tol, atol=STEP_TOL[arch]["atol"])
    return tol


SERVE_CASES = [(m, a) for m, (_, w) in MESHES.items() for a in w["serve"]]
TRAIN_CASES = [(m, a) for m, (_, w) in MESHES.items() for a in w["train"]]


@pytest.mark.parametrize("mesh,arch", SERVE_CASES)
def test_wide_mesh_serving_matches_jax(runs, mesh, arch):
    want, ranks = runs(mesh)
    tol = F32_TOL.get(arch, F32)
    step_tol = STEP_TOL.get(arch, tol)
    cfg = TC.get(arch, reduced=True)
    dtypes = {k: a.dtype for k, a in R.flat(
        TLM.abstract_cache(cfg, R.B, R.MAX_LEN)).items()}
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


def test_wide_mesh_encdec_serving_matches_jax(runs):
    """seamless-m4t-medium (4 heads) on (1, 8): encode, the cross cache
    placed by ``encdec_cache_axes`` and each decode step from the
    reference's cache and token before it."""
    want, ranks = runs("1x8")
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


def _tree(d, prefix):
    return R.unflat({tuple(k[len(prefix):].split("//")): v
                     for k, v in d.items() if k.startswith(prefix)})


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
def test_wide_mesh_train_step_matches_jax(runs, mesh, arch):
    want, ranks = runs(mesh)
    tol = TR.f32_tol(arch)
    for rank, got in enumerate(ranks):
        for loss in got[arch + "/loss"]:    # value_and_grad, the step
            np.testing.assert_allclose(loss, want[arch + "/loss"], **tol)
        np.testing.assert_allclose(got[arch + "/grad_norm"],
                                   want[arch + "/grad_norm"], **tol)
        trees = {n: (_tree(got, f"{arch}/{n}/"), _tree(want, f"{arch}/{n}/"))
                 for n in NAMES}
        for n in ("grads", "m", "v"):
            TR.assert_close_tree(*trees[n], **tol)
        TR.assert_params_after_first_step(*trees["new_params"],
                                          trees["grads"][1], tol)


@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_full_config_forward_on_the_production_mesh(arch):
    """The full config's ``lm_forward`` (an enc-dec: ``encode`` then
    ``decode_train``) on a fake 256-rank (16, 16) group, params as
    ``meta`` DTensors placed by the rules (kv heads 8 and xLSTM heads 4
    are replicated over "model"): finite shapes, logits batch x vocab
    sharded."""
    from repro_torch import sharding as SH
    from repro_torch.launch.dryrun import _abstract_params
    from repro_torch.launch.mesh import dryrun_world, make_production_mesh
    from repro_torch.models import encdec as TED
    cfg = TC.get(arch)
    B, S = 16, 16
    with dryrun_world(256), torch.no_grad():
        mesh = make_production_mesh(device="cpu")
        params, _ = _abstract_params(cfg, mesh)
        tokens = torch.empty((B, S), dtype=torch.long, device="meta")
        if cfg.family == "encdec":
            frames = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                                 device="meta")
            enc = TED.encode(params, frames, cfg, mesh)
            logits = TED.decode_train(params, enc, tokens, cfg, mesh=mesh)
        else:
            prefix = (torch.empty((B, cfg.prefix_len, cfg.d_model),
                                  dtype=torch.bfloat16, device="meta")
                      if cfg.family == "vlm" else None)
            logits = TLM.lm_forward(params, tokens, cfg, mesh=mesh,
                                    prefix_embeds=prefix)
        n = S + (cfg.prefix_len if cfg.family == "vlm" else 0)
        assert tuple(logits.shape) == (B, n, cfg.vocab_padded)
        assert logits.to_local().device.type == "meta"
        want = SH.placements(mesh, SH.logical_to_spec(
            mesh, ("batch", None, "vocab"), tuple(logits.shape)))
        assert list(logits.placements) == want
