"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's on seamless-m4t-medium's reduced config, with JAX's params
(the ``enc``/``dec``/``cross`` tree) converted through
``convert.lm_params_from_numpy``.

Cast to float32 on both sides: ``encode``, ``encdec_forward``, the cross
KV of ``fill_cross_cache`` and every logit of a decode teacher-forced
from position 0 (the reference serves enc-dec with no decoder prefill;
tests/test_models.py::test_encdec_decode_consistency) agree to
``rtol = atol = 1e-4``; the bf16 cache buffers to one bf16 ulp. In bf16,
the serving dtype, the teacher-forced logits agree to the reference's own
tolerance (``atol = 0.75, rtol = 0.1``, top-1 >= 0.5), and on the port
alone decode at T equals ``encdec_forward`` at T within it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
F32 = dict(rtol=1e-4, atol=1e-4)
ULP = dict(rtol=2 ** -7, atol=1e-6)
BF16 = dict(rtol=0.1, atol=0.75)
B, T, ENC = 2, 10, 12
MAX_LEN = T + 8

_RUNS = {}


def _cfgs():
    return JC.get(ARCH, reduced=True), TC.get(ARCH, reduced=True)


def _spec_rows(spec):
    return [(path, tuple(s.shape), s.axes, s.init, s.fan_in)
            for path, s in TL._leaves(spec)]


def run(dtype):
    """JAX's run in ``dtype`` ("f32" or "bf16"): params, frames, tokens,
    the encoder output, the full forward, the cross KV, and each
    teacher-forced step's logits and self KV (numpy, cached)."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    cfg, _ = _cfgs()
    p = JL.init_params(jax.random.PRNGKey(0),
                       JE.encdec_spec(cfg, cfg.n_enc, cfg.n_dec))
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    if dtype == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, cfg.vocab, (B, T + 1)).astype(np.int32)
    frames = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    jf = jnp.asarray(frames, jd)
    enc = JE.encode(p, jf, cfg)
    full = JE.encdec_forward(p, jf, tokens, cfg)
    cache = JE.init_encdec_cache(cfg, cfg.n_dec, B, MAX_LEN, ENC)
    cache = JE.fill_cross_cache(p, enc, cache, cfg)
    out = {"params": jax.tree.map(np.asarray, p), "tokens": tokens,
           "frames": frames, "enc": np.asarray(enc, np.float32),
           "full": np.asarray(full, np.float32),
           "cross_k": np.asarray(cache["cross_k"], np.float32),
           "cross_v": np.asarray(cache["cross_v"], np.float32)}
    steps = []
    for t in range(T + 1):
        lg, cache = JE.encdec_decode_step(
            p, cache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t), cfg)
        steps.append(np.asarray(lg, np.float32))
    out["steps"] = steps
    out["self_k"] = np.asarray(cache["self_k"], np.float32)
    out["self_v"] = np.asarray(cache["self_v"], np.float32)
    _RUNS[dtype] = out
    return out


def port(ref):
    _, cfg = _cfgs()
    params = lm_params_from_numpy(cfg, ref["params"], device="cpu")
    frames = torch.from_numpy(ref["frames"]).to(params["embed"].dtype)
    return cfg, params, frames


def _decode(cfg, params, enc, tokens):
    cache = TE.init_encdec_cache(cfg, cfg.n_dec, B, MAX_LEN, ENC,
                                 device="cpu")
    assert TE.fill_cross_cache(params, enc, cache, cfg) is cache
    steps = []
    for t in range(T + 1):
        lg, out = TE.encdec_decode_step(
            params, cache, torch.from_numpy(tokens[:, t:t + 1]).long(), t,
            cfg)
        assert out is cache
        steps.append(lg)
    return cache, steps


@pytest.mark.parametrize("stack", [False, True])
def test_encdec_spec_equals_the_reference(stack):
    jcfg, tcfg = _cfgs() if stack else (JC.get(ARCH), TC.get(ARCH))
    assert (_spec_rows(TE.encdec_spec(tcfg, tcfg.n_enc, tcfg.n_dec))
            == _spec_rows(JE.encdec_spec(jcfg, jcfg.n_enc, jcfg.n_dec)))


def test_encode_forward_and_cross_cache_f32():
    ref = run("f32")
    cfg, params, frames = port(ref)
    assert set(params) == {"embed", "enc", "enc_norm", "dec", "final_norm"}
    enc = TE.encode(params, frames, cfg)
    np.testing.assert_allclose(enc.numpy(), ref["enc"], **F32)
    full = TE.encdec_forward(params, frames,
                             torch.from_numpy(ref["tokens"]).long(), cfg)
    assert full.dtype == torch.float32
    assert tuple(full.shape) == (B, T + 1, cfg.vocab_padded)
    np.testing.assert_allclose(full.numpy(), ref["full"], **F32)
    assert bool(torch.all(full[..., cfg.vocab:] == -1e9))
    last = TE.decode_train(params, enc,
                           torch.from_numpy(ref["tokens"]).long(), cfg,
                           last_only=True)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
    cache = TE.init_encdec_cache(cfg, cfg.n_dec, B, MAX_LEN, ENC,
                                 device="cpu")
    TE.fill_cross_cache(params, enc, cache, cfg)
    for name in ("cross_k", "cross_v"):
        assert cache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(cache[name].float().numpy(), ref[name],
                                   **ULP)


def test_teacher_forced_decode_f32(record_property):
    ref = run("f32")
    cfg, params, frames = port(ref)
    enc = torch.from_numpy(np.array(ref["enc"]))
    cache, steps = _decode(cfg, params, enc, ref["tokens"])
    record_property("max_abs_diff", max(
        float(np.abs(g.numpy() - w).max()) for g, w in zip(steps,
                                                            ref["steps"])))
    for g, w in zip(steps, ref["steps"]):
        np.testing.assert_allclose(g.numpy(), w, **F32)
    for name in ("self_k", "self_v"):
        np.testing.assert_allclose(cache[name].float().numpy(), ref[name],
                                   **ULP)


def test_teacher_forced_decode_bf16():
    ref = run("bf16")
    cfg, params, frames = port(ref)
    assert params["embed"].dtype == torch.bfloat16
    enc = TE.encode(params, frames, cfg)
    _, steps = _decode(cfg, params, enc, ref["tokens"])
    for g, w in zip(steps, ref["steps"]):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **BF16)
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.5
    # the reference's consistency check on the port: decode at T against
    # the full forward at T
    full = TE.encdec_forward(params, frames,
                             torch.from_numpy(ref["tokens"]).long(), cfg)
    a, b = full[:, -1].numpy(), steps[-1][:, -1].numpy()
    np.testing.assert_allclose(b, a, **BF16)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5


def test_abstract_cache_and_params_checks():
    _, cfg = _cfgs()
    meta = TE.abstract_encdec_cache(cfg, cfg.n_dec, B, MAX_LEN, ENC)
    real = TE.init_encdec_cache(cfg, cfg.n_dec, B, MAX_LEN, ENC,
                                device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in real.items()}
    assert all(v.device.type == "meta" for v in meta.values())
    ref = run("f32")
    bad = dict(ref["params"], dec=dict(ref["params"]["dec"]))
    del bad["dec"]["cross"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, bad, device="cpu")
