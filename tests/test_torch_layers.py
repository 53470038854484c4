"""The port's LM layer library (``repro_torch.models.layers``) against the
JAX package's (``repro.models.layers``) on the same inputs.

Inputs are made with numpy from a seed and handed to both; everything
runs in float32, where the two must agree to ``rtol = atol = 1e-5``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

# The tensors here are small: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(torch_out, jax_out, **tol):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(plus_one):
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 3, 5, 64, scale=3.0), _rand(rng, 64)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(s),
                      plus_one=plus_one),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), plus_one=plus_one))


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap):
    x = _rand(np.random.default_rng(1), 4, 100, scale=50.0)
    _close(TL.softcap(torch.from_numpy(x), cap),
           JL.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("base", [10_000.0, 1_000_000.0])
def test_rope(base):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 37, 4, 16)
    pos = rng.integers(0, 4096, (2, 37)).astype(np.int32)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), base=base),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), base=base))


def test_rope_bf16_rounds_like_the_reference():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 9, 2, 16)
    pos = np.arange(9, dtype=np.int32)
    got = TL.rope(torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(pos))
    want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp: the two libraries' cos/sin may differ in the last
    # float32 bit before the cast
    _close(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu2", False), ("relu", False),
                                       ("gelu", False)])
def test_mlp_apply(act, gated):
    rng = np.random.default_rng(4)
    spec = JL.mlp_spec(32, 48, gated=gated)
    p = {k: _rand(rng, *s.shape, scale=0.2) for k, s in spec.items()}
    x = _rand(rng, 2, 7, 32)
    _close(TL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), act=act),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act=act))


@pytest.mark.parametrize("scale", [False, True])
def test_embed_apply(scale):
    rng = np.random.default_rng(5)
    table = _rand(rng, 50, 24)
    tok = rng.integers(0, 50, (3, 6)).astype(np.int32)
    _close(TL.embed_apply(torch.from_numpy(table),
                          torch.from_numpy(tok).long(), scale=scale),
           JL.embed_apply(jnp.asarray(table), jnp.asarray(tok), scale=scale))


def test_embed_scale_rounds_to_the_dtype_first():
    """gemma3's sqrt(5376) = 73.32 becomes 73.5 in bf16 before the
    product."""
    table = torch.ones(2, 5376, dtype=torch.bfloat16)
    out = TL.embed_apply(table, torch.tensor([[1]]), scale=True)
    assert out.dtype == torch.bfloat16
    assert float(out[0, 0, 0]) == 73.5
    want = JL.embed_apply(jnp.ones((2, 5376), jnp.bfloat16),
                          jnp.asarray([[1]]), scale=True)
    assert float(want[0, 0, 0]) == 73.5


@pytest.mark.parametrize("transpose,cap", [(True, None), (False, None),
                                           (True, 30.0)])
def test_logits_apply(transpose, cap):
    rng = np.random.default_rng(6)
    w = _rand(rng, *((40, 16) if transpose else (16, 40)))
    x = _rand(rng, 2, 3, 16, scale=3.0)
    _close(TL.logits_apply(torch.from_numpy(w), torch.from_numpy(x),
                           transpose=transpose, cap=cap),
           JL.logits_apply(jnp.asarray(w), jnp.asarray(x),
                           transpose=transpose, cap=cap))


def test_dense_contracts_the_last_axis():
    rng = np.random.default_rng(7)
    x, w = _rand(rng, 2, 5, 12), _rand(rng, 12, 3, 4)
    _close(TL.dense(torch.from_numpy(x), torch.from_numpy(w)),
           JL.dense(jnp.asarray(x), jnp.asarray(w)))


# (B, Sq, H, Hkv, hd, q_chunk, kv_chunk, causal, window, skip, cap)
ATTN_CASES = {
    "causal": (2, 37, 4, 2, 8, 16, 8, True, None, False, None),
    "windowed": (2, 37, 4, 2, 8, 16, 8, True, 8, False, None),
    "band_skip": (2, 70, 4, 2, 8, 16, 8, True, 12, True, None),
    "causal_skip": (2, 70, 4, 2, 8, 16, 8, True, None, True, None),
    "ragged_chunks": (1, 45, 2, 2, 8, 32, 32, True, None, False, None),
    "gqa_one_kv_head": (2, 21, 6, 1, 8, 8, 16, True, None, False, None),
    "not_causal": (2, 19, 4, 4, 8, 8, 8, False, None, False, None),
    "softcap": (2, 23, 4, 2, 8, 8, 8, True, None, False, 5.0),
    "window_wider_than_seq": (1, 30, 4, 2, 8, 16, 8, True, 64, True, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention(case):
    B, S, H, Hkv, hd, qc, kc, causal, window, skip, cap = ATTN_CASES[case]
    rng = np.random.default_rng(8)
    q, k, v = (_rand(rng, B, S, h, hd) for h in (H, Hkv, Hkv))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              skip_masked_blocks=skip, logit_cap=cap)
    _close(TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw))


def test_blockwise_attention_q_positions():
    """Queries at absolute positions past the start (a suffix of the kv
    sequence) see the kv prefix."""
    rng = np.random.default_rng(9)
    q = _rand(rng, 2, 5, 4, 8)
    k, v = _rand(rng, 2, 20, 2, 8), _rand(rng, 2, 20, 2, 8)
    qpos = np.arange(15, 20, dtype=np.int32)
    kw = dict(q_chunk=4, kv_chunk=8, window=9)
    _close(TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                  q_positions=torch.from_numpy(qpos), **kw),
           JL.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                  q_positions=jnp.asarray(qpos), **kw))


def _attn_params(rng, d, H, Hkv, hd, *, qkv_bias=False, qk_norm=False):
    spec = JL.attn_spec(d, H, Hkv, hd, qkv_bias=qkv_bias, qk_norm=qk_norm)
    return {k: _rand(rng, *s.shape, scale=1 / math.sqrt(d)) + (
        1.0 if k.endswith("norm") else 0.0) for k, s in spec.items()}


@pytest.mark.parametrize("qk_norm,qkv_bias,window", [
    (True, False, None), (False, True, None), (True, False, 6)])
def test_gqa_full(qk_norm, qkv_bias, window):
    rng = np.random.default_rng(10)
    p = _attn_params(rng, 32, 4, 2, 8, qkv_bias=qkv_bias, qk_norm=qk_norm)
    x = _rand(rng, 2, 19, 32)
    kw = dict(qk_norm=qk_norm, window=window, q_chunk=8, kv_chunk=8)
    got, (gk, gv) = TL.gqa_full({k: torch.from_numpy(a) for k, a in
                                 p.items()}, torch.from_numpy(x), **kw)
    want, (wk, wv) = JL.gqa_full({k: jnp.asarray(a) for k, a in p.items()},
                                 jnp.asarray(x), **kw)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_decode(window):
    """One token against a cache filled to ``pos``: scores over the whole
    Smax, masked; the new k/v written at ``pos``."""
    rng = np.random.default_rng(11)
    B, Smax, H, Hkv, hd, d, pos = 2, 16, 4, 2, 8, 32, 9
    p = _attn_params(rng, d, H, Hkv, hd, qk_norm=True)
    x = _rand(rng, B, 1, d)
    ck, cv = _rand(rng, B, Smax, Hkv, hd), _rand(rng, B, Smax, Hkv, hd)
    kw = dict(qk_norm=True, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = TL.gqa_decode({k: torch.from_numpy(a) for k, a in
                                 p.items()}, torch.from_numpy(x), tk, tv,
                                pos, **kw)
    want, wk, wv = JL.gqa_decode({k: jnp.asarray(a) for k, a in p.items()},
                                 jnp.asarray(x), jnp.asarray(ck),
                                 jnp.asarray(cv), jnp.int32(pos), **kw)
    assert gk is tk and gv is tv          # written in place
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)
    untouched = np.arange(Smax) != pos
    np.testing.assert_array_equal(gk.numpy()[:, untouched], ck[:, untouched])


def test_masked_cache_update_in_place():
    rng = np.random.default_rng(12)
    cache, new = _rand(rng, 2, 7, 3), _rand(rng, 2, 1, 3)
    t = torch.from_numpy(cache.copy())
    out = TL.masked_cache_update(t, torch.from_numpy(new), 4)
    assert out is t
    _close(out, JL.masked_cache_update(jnp.asarray(cache), jnp.asarray(new),
                                       4))
    with pytest.raises(ValueError):
        TL.masked_cache_update(t, torch.zeros(2, 2, 3), 1)


def test_init_params_follows_the_std_rule():
    spec = {"w": TL.PSpec((256, 64), "a,b", fan_in=256),
            "stacked": TL.PSpec((3, 128, 64), "s,a,b"),
            "e": TL.PSpec((512, 16), "v,.", init="embed"),
            "z": TL.PSpec((8,), ".", init="zeros"),
            "o": TL.PSpec((8,), ".", init="ones")}
    gen = torch.Generator().manual_seed(0)
    p = TL.init_params(spec, generator=gen, device="cpu")
    assert p["w"].dtype == torch.bfloat16
    for name, std in (("w", 1 / 16), ("stacked", 1 / math.sqrt(128)),
                      ("e", 1.0)):
        assert abs(float(p[name].float().std()) / std - 1) < 0.05, name
    assert torch.all(p["z"] == 0) and torch.all(p["o"] == 1)
    again = TL.init_params(spec, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert TL.param_count(spec) == 256 * 64 + 3 * 128 * 64 + 512 * 16 + 16
    meta = TL.abstract_params(spec)
    assert meta["stacked"].device.type == "meta"
    assert TL.axes_tree(spec)["e"] == "v,."


def test_grad_cast_bf16_casts_the_cotangent():
    x = torch.randn(4, dtype=torch.float32, requires_grad=True)
    y = TL.grad_cast_bf16(x)
    g = torch.randn(4)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(y, x)
    # the cotangent went through bf16
    assert torch.equal(gx, g.to(torch.bfloat16).float())
    with torch.no_grad():
        assert TL.grad_cast_bf16(x) is x
    jx = jnp.asarray(g.numpy())
    jg = jax.grad(lambda a: jnp.vdot(JL.grad_cast_bf16(a), jx))(
        jnp.zeros(4, jnp.float32))
    assert jg.dtype == jnp.bfloat16
