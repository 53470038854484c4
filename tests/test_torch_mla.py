"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's, in float32 on the same numpy inputs and
params: ``mla_full`` (output and latent cache) and the absorbed
``mla_decode`` (output and both cache buffers) agree to
``rtol = atol = 1e-5``; and on the port alone, absorbed decode at
position T equals ``mla_full``'s output at T (the two forms are the same
attention) to ``1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import mla as JM
from repro_torch.models import layers as TL
from repro_torch.models import mla as TM

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
D, H = 32, 4
DIMS = dict(qk_nope=16, qk_rope=8, kv_lora=16, v_dim=12)
B, S, SMAX = 2, 13, 20


def _params(seed=0):
    spec = JM.mla_spec(D, H, q_lora=24, **DIMS)
    p = JL.init_params(jax.random.PRNGKey(seed), spec)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(n=S, seed=1):
    return np.random.default_rng(seed).standard_normal((B, n, D)).astype(
        np.float32)


@pytest.mark.parametrize("chunks", [(4, 8), (512, 1024)])
def test_mla_full_matches_jax(chunks):
    p, x = _params(), _x()
    q_chunk, kv_chunk = chunks
    want, (wckv, wkpe) = JM.mla_full(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, **DIMS)
    got, (ckv, kpe) = TM.mla_full(TL.tree_map(_t, p), _t(x),
                                  q_chunk=q_chunk, kv_chunk=kv_chunk, **DIMS)
    assert tuple(got.shape) == (B, S, D)
    assert tuple(ckv.shape) == (B, S, DIMS["kv_lora"])
    assert tuple(kpe.shape) == (B, S, DIMS["qk_rope"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(wckv), **F32)
    np.testing.assert_allclose(kpe.numpy(), np.asarray(wkpe), **F32)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(cache_dtype):
    p = _params()
    rng = np.random.default_rng(2)
    ckv = rng.standard_normal((B, SMAX, DIMS["kv_lora"])).astype(np.float32)
    kpe = rng.standard_normal((B, SMAX, DIMS["qk_rope"])).astype(np.float32)
    x = _x(1, seed=3)
    pos = 9
    jd = jnp.float32 if cache_dtype == "float32" else jnp.bfloat16
    td = getattr(torch, cache_dtype)
    want, wckv, wkpe = JM.mla_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(ckv, jd), jnp.asarray(kpe, jd), jnp.int32(pos), **DIMS)
    tckv, tkpe = _t(ckv).to(td), _t(kpe).to(td)
    got, gckv, gkpe = TM.mla_decode(TL.tree_map(_t, p), _t(x), tckv, tkpe,
                                    torch.tensor([pos]), **DIMS)
    assert gckv is tckv and gkpe is tkpe          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gckv.float().numpy(),
                               np.asarray(wckv, np.float32), **F32)
    np.testing.assert_allclose(gkpe.float().numpy(),
                               np.asarray(wkpe, np.float32), **F32)


def test_absorbed_decode_equals_mla_full():
    """Decode at T from mla_full's cache of positions < T equals
    mla_full's output at T."""
    p = TL.tree_map(_t, _params(seed=4))
    x = _t(_x(S + 1, seed=5))
    full, _ = TM.mla_full(p, x, q_chunk=8, kv_chunk=8, **DIMS)
    _, (ckv, kpe) = TM.mla_full(p, x[:, :S], q_chunk=8, kv_chunk=8, **DIMS)
    cache_ckv = torch.zeros(B, SMAX, DIMS["kv_lora"])
    cache_kpe = torch.zeros(B, SMAX, DIMS["qk_rope"])
    cache_ckv[:, :S] = ckv
    cache_kpe[:, :S] = kpe
    step, _, _ = TM.mla_decode(p, x[:, S:], cache_ckv, cache_kpe, S, **DIMS)
    torch.testing.assert_close(step[:, 0], full[:, S], **F32)


def test_mla_spec_equals_the_reference():
    def rows(spec):
        return [(path, tuple(s.shape), s.axes, s.init, s.fan_in)
                for path, s in TL._leaves(spec)]
    for stack in (None, 3):
        assert (rows(TM.mla_spec(D, H, q_lora=24, stack=stack, **DIMS))
                == rows(JM.mla_spec(D, H, q_lora=24, stack=stack, **DIMS)))
