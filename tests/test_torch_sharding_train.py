"""The port's sharded training step and expert-parallel MoE against the
JAX package's, both on a ("data", "model") = (2, 2) mesh
(tests/_shard_reference.py).

* One train step of qwen3-4b, deepseek-moe-16b, deepseek-v2-236b (MLA +
  MoE) and seamless-m4t-medium (the encoder-decoder, ``encdec_forward``)
  from the same float32 params, zero AdamW state and batch:
  params and moments placed by the rules, the batch sharded over "data",
  ``grad_cast_bf16`` the identity on both sides (the reference's float32
  step raises otherwise; tests/_train_reference.py). Held at
  rtol = atol = 1e-4: the loss, the grad norm, every gradient leaf and
  both moments; the updated params by AdamW's first-step rule
  (``assert_params_after_first_step``). qwen3-4b also with
  ``microbatch=2`` (chunks constrained to (None, "batch")).
* The MoE layer at a batch where capacity binds: with two data shards
  each shard keeps its own first ``capacity`` pairs per expert, so the
  kept (token, expert) pairs at dp = 2 differ from dp = 1's. The port's
  expert-parallel layer equals the reference's ``shard_map`` one, and
  differs from the port's own one-device layer on exactly the tokens
  whose kept pairs differ.
"""
import numpy as np
import pytest
import torch

import _shard_reference as R
import _train_reference as TR
from _lm_reference import F32
from repro_torch import configs as TC
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE

ARCHS = ["qwen3-4b", "deepseek-moe-16b", "deepseek-v2-236b",
         "seamless-m4t-medium"]
MB_ARCH = "qwen3-4b"
# the MoE layer: deepseek-moe-16b's reduced widths, a batch where
# capacity binds (128 tokens a data shard, 8 experts, top-2)
MOE_ARCH, MOE_B, MOE_S = "deepseek-moe-16b", 4, 64
NAMES = ("grads", "new_params", "m", "v")

_JAX = r"""
import _train_reference as TR
from repro import configs as JC, sharding as JSH
from repro.models import encdec as JED, layers as JL, lm as JLM, moe as JMOE
from repro.train import loop as JLOOP, optimizer as JOPT
from repro_torch import configs as TC
from repro_torch.models import lm as TLM, moe as TMOE
import _shard_reference as R

def put(x, logical):
    spec = JSH.logical_to_spec(MESH, logical, x.shape)
    return jax.device_put(x, NamedSharding(MESH, spec))

oc = JOPT.AdamWConfig(**R.OPT)
out = {{}}
with TR.exact_float32():
    for arch in {archs!r}:
        cfg = JC.get(arch, reduced=True)
        spec = (JED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
                if cfg.family == "encdec" else JLM.lm_spec(cfg))
        shard = JSH.param_sharding_rules(MESH, JL.abstract_params(spec),
                                         JL.axes_tree(spec))
        params = jax.device_put(jax.tree.map(jnp.asarray, R.numpy_params(
            R.param_spec(TC.get(arch, reduced=True)))), shard)
        state = JOPT.adamw_init(params)
        state = JOPT.AdamWState(m=jax.device_put(state.m, shard),
                                v=jax.device_put(state.v, shard),
                                count=state.count)
        batch = {{k: put(jnp.asarray(v), ("batch",) + (None,) * (v.ndim - 1))
                  for k, v in R.train_batch(TC.get(arch, reduced=True)).items()}}
        loss_fn = JLOOP.make_loss(cfg, MESH)

        def step(params, state, batch, step):
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            clipped, gnorm = JOPT.clip_by_global_norm(grads, oc.clip_norm)
            new_p, new_s = JOPT.adamw_update(clipped, state, params, oc, step)
            return loss, grads, gnorm, new_p, new_s

        loss, grads, gnorm, new_p, new_s = jax.jit(step)(
            params, state, batch, jnp.int32(R.TRAIN_STEP))
        out[arch + "/loss"] = np.asarray(loss)
        out[arch + "/grad_norm"] = np.asarray(gnorm)
        for name, tree in (("grads", grads), ("new_params", new_p),
                           ("m", new_s.m), ("v", new_s.v)):
            for k, a in R.flat(tree).items():
                out[f"{{arch}}/{{name}}/{{k}}"] = np.asarray(a, np.float32)
        if arch == {mb_arch!r}:
            p2, s2, mt = jax.jit(JLOOP.make_train_step(
                cfg, oc, MESH, microbatch=2))(params, state, batch,
                                               jnp.int32(R.TRAIN_STEP))
            out[arch + "/mb/loss"] = np.asarray(mt["loss"])
            out[arch + "/mb/grad_norm"] = np.asarray(mt["grad_norm"])
            for k, a in R.flat(p2).items():
                out[f"{{arch}}/mb/new_params/{{k}}"] = np.asarray(a, np.float32)
    # the MoE layer alone
    cfg = TC.get({moe_arch!r}, reduced=True)
    mo = cfg.moe
    p = jax.tree.map(jnp.asarray, R.numpy_params(TMOE.moe_spec(
        cfg.d_model, mo.d_ff_expert, mo.n_routed, mo.n_shared), seed=7))
    x = np.random.default_rng(8).standard_normal(
        ({moe_b}, {moe_s}, cfg.d_model)).astype(np.float32)
    cap = TLM._moe_capacity(cfg, {moe_b} * {moe_s} // 2)
    y = jax.jit(lambda p, x: JMOE.moe_apply(
        p, x, topk=mo.topk, n_routed=mo.n_routed, capacity=cap,
        renormalize=mo.renormalize, mesh=MESH))(
            p, put(jnp.asarray(x), ("batch", None, None)))
    out["moe/y"] = np.asarray(y, np.float32)
np.savez({out!r}, **out)
print("JAX-OK")
"""

_RANKS = r"""
import _shard_reference as R
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL, lm as TLM, moe as TMOE
from repro_torch.train import loop as TLOOP, optimizer as TOPT
from repro_torch import sharding as SH

# tests/_train_reference.py's exact_float32: the cast as the identity
TL.grad_cast_bf16 = TMOE.grad_cast_bf16 = lambda x: x
oc = TOPT.AdamWConfig(**R.OPT)
out = {{}}

def full(tree, prefix):
    for k, a in R.flat(tree).items():
        assert SH.is_dtensor(a), (prefix, k)
        out[prefix + k] = a.full_tensor().float().numpy()

for arch in {archs!r}:
    cfg = TC.get(arch, reduced=True)
    np_params = R.numpy_params(R.param_spec(cfg))
    params = lm_params_from_numpy(cfg, np_params, mesh=MESH)
    state = TOPT.adamw_init(params)
    batch = R.train_batch(cfg)
    loss, grads = TLOOP.value_and_grad(
        TLOOP.make_loss(cfg, MESH), params,
        TLOOP.batch_on(batch, "cpu", MESH), MESH)
    full(grads, arch + "/grads/")
    params, state, mt = TLOOP.make_train_step(cfg, oc, MESH)(
        params, state, batch, R.TRAIN_STEP)
    assert int(state.count) == 1
    out[arch + "/loss"] = np.asarray([float(loss), float(mt["loss"])])
    out[arch + "/grad_norm"] = np.asarray(float(mt["grad_norm"]))
    full(params, arch + "/new_params/")
    full(state.m, arch + "/m/")
    full(state.v, arch + "/v/")
    if arch == {mb_arch!r}:
        params = lm_params_from_numpy(cfg, np_params, mesh=MESH)
        p2, s2, m2 = TLOOP.make_train_step(cfg, oc, MESH, microbatch=2)(
            params, TOPT.adamw_init(params), batch, R.TRAIN_STEP)
        out[arch + "/mb/loss"] = np.asarray(float(m2["loss"]))
        out[arch + "/mb/grad_norm"] = np.asarray(float(m2["grad_norm"]))
        full(p2, arch + "/mb/new_params/")
# the MoE layer alone, expert-parallel
cfg = TC.get({moe_arch!r}, reduced=True)
mo = cfg.moe
spec = TMOE.moe_spec(cfg.d_model, mo.d_ff_expert, mo.n_routed, mo.n_shared)
p = SH.place_tree(MESH, TL.tree_map(torch.from_numpy, R.numpy_params(
    spec, seed=7)), SH.param_sharding_rules(MESH, spec, TL.axes_tree(spec)))
x = np.random.default_rng(8).standard_normal(
    ({moe_b}, {moe_s}, cfg.d_model)).astype(np.float32)
cap = TLM._moe_capacity(cfg, {moe_b} * {moe_s} // 2)
with SH.on_mesh(MESH):
    y = TMOE.moe_apply(p, SH.constrain(torch.from_numpy(x), MESH,
                                       ("batch", None, None)),
                       topk=mo.topk, n_routed=mo.n_routed, capacity=cap,
                       renormalize=mo.renormalize, mesh=MESH)
out["moe/y"] = y.full_tensor().detach().numpy()
# on a mesh without "model" ((4,) "data"): the whole batch on every rank
from repro_torch.launch.mesh import make_local_mesh
mesh4 = make_local_mesh(("data",), device="cpu")
p4 = SH.place_tree(mesh4, TL.tree_map(torch.from_numpy, R.numpy_params(
    spec, seed=7)), SH.param_sharding_rules(mesh4, spec, TL.axes_tree(spec)))
with SH.on_mesh(mesh4):
    y4 = TMOE.moe_apply(p4, SH.constrain(torch.from_numpy(x), mesh4,
                                         ("batch", None, None)),
                        topk=mo.topk, n_routed=mo.n_routed, capacity=cap,
                        renormalize=mo.renormalize, mesh=mesh4)
out["moe/y_data_only"] = y4.full_tensor().detach().numpy()
np.savez({out!r}.format(rank=RANK), **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_train")
    fmt = dict(archs=ARCHS, mb_arch=MB_ARCH, moe_arch=MOE_ARCH,
               moe_b=MOE_B, moe_s=MOE_S)
    procs = R.start(_JAX.format(out=str(tmp / "jax.npz"), **fmt),
                    _RANKS.format(out=str(tmp / "rank{rank}.npz"), **fmt),
                    tmp)
    wall = R.finish(procs, timeout=600)
    print(f"sharded training, both sides: {wall:.1f} s")
    return (R.load(tmp / "jax.npz"),
            [R.load(tmp / f"rank{r}.npz") for r in range(R.WORLD)])


def _tree(d, prefix):
    return R.unflat({tuple(k[len(prefix):].split("//")): v
                     for k, v in d.items() if k.startswith(prefix)})


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax_sharded(runs, arch):
    want, ranks = runs
    for rank, got in enumerate(ranks):
        for loss in got[arch + "/loss"]:    # value_and_grad, the step
            np.testing.assert_allclose(loss, want[arch + "/loss"], **F32)
        np.testing.assert_allclose(got[arch + "/grad_norm"],
                                   want[arch + "/grad_norm"], **F32)
        trees = {n: (_tree(got, f"{arch}/{n}/"), _tree(want, f"{arch}/{n}/"))
                 for n in NAMES}
        for n in ("grads", "m", "v"):
            TR.assert_close_tree(*trees[n], **F32)
        TR.assert_params_after_first_step(*trees["new_params"],
                                          trees["grads"][1], F32)


def test_sharded_microbatch_step_matches_jax_sharded(runs):
    want, ranks = runs
    arch = MB_ARCH
    for got in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[f"{arch}/mb/{k}"],
                                       want[f"{arch}/mb/{k}"], **F32)
        TR.assert_params_after_first_step(
            _tree(got, f"{arch}/mb/new_params/"),
            _tree(want, f"{arch}/mb/new_params/"),
            _tree(want, f"{arch}/grads/"), F32)


def _kept(idx, capacity, dp):
    """The (token, expert) pairs the dispatch keeps when the T tokens are
    cut into ``dp`` shards: in each shard, each expert's first
    ``capacity`` pairs in token-major order."""
    T, k = idx.shape
    per, kept = T // dp, set()
    for s in range(dp):
        count = {}
        for pos, e in enumerate(idx[s * per:(s + 1) * per].reshape(-1)):
            if count.get(e, 0) < capacity:
                kept.add((s * per + pos // k, int(e)))
            count[e] = count.get(e, 0) + 1
    return kept


def test_expert_parallel_moe_keeps_per_data_shard_pairs(runs):
    want, ranks = runs
    cfg = TC.get(MOE_ARCH, reduced=True)
    mo = cfg.moe
    spec = TMOE.moe_spec(cfg.d_model, mo.d_ff_expert, mo.n_routed,
                         mo.n_shared)
    p = TLM.L.tree_map(torch.from_numpy, R.numpy_params(spec, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (MOE_B, MOE_S, cfg.d_model)).astype(np.float32))
    T = MOE_B * MOE_S
    cap1, cap2 = TLM._moe_capacity(cfg, T), TLM._moe_capacity(cfg, T // 2)
    with torch.no_grad():
        y1 = TMOE.moe_apply(p, x, topk=mo.topk, n_routed=mo.n_routed,
                            capacity=cap1, renormalize=mo.renormalize)
        _, idx = TMOE.route(x.reshape(T, -1), p["router"], topk=mo.topk,
                            renormalize=mo.renormalize)
    kept1 = _kept(idx.numpy(), cap1, 1)
    kept2 = _kept(idx.numpy(), cap2, 2)
    pairs = {(t, int(e)) for t in range(T) for e in idx[t].tolist()}
    assert kept2 < pairs and kept1 != kept2   # capacity binds at dp = 2
    moved = {t for t, _ in kept1 ^ kept2}
    for got in ranks:
        np.testing.assert_allclose(got["moe/y"], want["moe/y"], **F32)
        diff = np.abs(got["moe/y"] - y1.numpy()).reshape(T, -1).max(-1)
        assert set(np.nonzero(diff > 1e-4)[0].tolist()) == moved


def test_moe_on_a_mesh_without_model_dispatches_globally(runs):
    """With no "model" axis the routed layer is the reference's global
    dispatch (every rank the whole batch): the port's one-device layer at
    the same capacity."""
    _, ranks = runs
    cfg = TC.get(MOE_ARCH, reduced=True)
    mo = cfg.moe
    spec = TMOE.moe_spec(cfg.d_model, mo.d_ff_expert, mo.n_routed,
                         mo.n_shared)
    p = TLM.L.tree_map(torch.from_numpy, R.numpy_params(spec, seed=7))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (MOE_B, MOE_S, cfg.d_model)).astype(np.float32))
    cap = TLM._moe_capacity(cfg, MOE_B * MOE_S // 2)
    with torch.no_grad():
        want = TMOE.moe_apply(p, x, topk=mo.topk, n_routed=mo.n_routed,
                              capacity=cap, renormalize=mo.renormalize)
    for got in ranks:
        np.testing.assert_allclose(got["moe/y_data_only"], want.numpy(),
                                   rtol=1e-6, atol=1e-6)
