"""The port's decoder-only LM and configs (``repro_torch.models.lm``,
``repro_torch.configs``) against the JAX package's.

Configs equal field for field; specs leaf for leaf (keys, shapes, axes,
init); ``num_params`` on the full configs (a spec walk, no allocation);
the serving caches leaf for leaf (shapes, dtypes, the -inf stabilizers).
``lm_forward`` runs every reduced config (an enc-dec config as its
decoder stack, as the reference's ``lm_forward`` does) on JAX's params,
converted through ``convert.lm_params_from_numpy``: cast to float32 on
both sides they agree to ``rtol = atol = 1e-4`` (atol 5e-4 for
xlstm-350m, whose bf16 reference runs eagerly: tests/_lm_reference.py);
in bf16, the serving dtype, to the reference's own prefill/decode
tolerance (``atol = 0.75, rtol = 0.1``, top-1 agreement >= 0.5;
tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_reference import f32_tol, jax_mode
from repro import configs as JC
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import configs as TC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

torch.set_num_threads(1)

ARCHS = list(TC.ARCH_IDS)
BF16 = dict(rtol=0.1, atol=0.75)


def _jax_params(cfg, dtype=None):
    p = JL.init_params(jax.random.PRNGKey(0), JLM.lm_spec(cfg))
    if dtype is not None:
        p = jax.tree.map(lambda a: a.astype(dtype), p)
    return p


def _inputs(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return tokens, prefix


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _spec_rows(spec):
    return [(path, tuple(s.shape), s.axes, s.init, s.fan_in,
             _dtype_name(s.dtype)) for path, s in _spec_leaves(spec)]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_configs_equal_the_reference(arch, reduced):
    assert (dataclasses.asdict(TC.get(arch, reduced=reduced))
            == dataclasses.asdict(JC.get(arch, reduced=reduced)))
    t = TC.get(arch, reduced=reduced)
    j = JC.get(arch, reduced=reduced)
    assert (t.n_layers, t.vocab_padded) == (j.n_layers, j.vocab_padded)


def test_config_registry():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert set(TC.all_configs()) == set(JC.all_configs())
    assert all(TC.get(a).name == a for a in TC.ARCH_IDS)


@pytest.mark.parametrize("arch", list(TC.ARCH_IDS))
def test_input_specs(arch):
    from repro.configs import common as JCC
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    for name in TC.SHAPES:
        assert (TC.shape_applicable(tcfg, TC.SHAPES[name])
                == JCC.shape_applicable(jcfg, JCC.SHAPES[name]))
        got = TC.input_specs(tcfg, TC.SHAPES[name])
        want = JCC.input_specs(jcfg, JCC.SHAPES[name])
        assert set(got) == set(want), name
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert _dtype_name(t.dtype) == _dtype_name(want[k].dtype), (
                name, k)


def test_family_id_lists():
    assert TC.DENSE_IDS == ("qwen3-4b", "qwen2-72b", "gemma3-27b",
                            "minitron-4b", "internvl2-76b")
    assert TC.MOE_IDS == ("deepseek-moe-16b", "deepseek-v2-236b")
    assert TC.MLA_IDS == ("deepseek-v2-236b",)
    assert TC.RECURRENT_IDS == ("xlstm-350m", "recurrentgemma-9b")
    assert TC.ENCDEC_IDS == ("seamless-m4t-medium",)
    assert set(TC.DENSE_IDS + TC.MOE_IDS + TC.RECURRENT_IDS
               + TC.ENCDEC_IDS) == set(TC.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_the_reference(arch):
    """Leaf for leaf: shapes, dtypes and values (zeros, and -inf for the
    float32 m stabilizers)."""
    t = TLM.init_cache(TC.get(arch, reduced=True), 2, 16, device="cpu")
    j = JLM.init_cache(JC.get(arch, reduced=True), 2, 16)
    got = list(_spec_leaves(t))
    want = list(_spec_leaves(j))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert _dtype_name(g.dtype) == _dtype_name(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    meta = TLM.abstract_cache(TC.get(arch, reduced=True), 2, 16)
    assert [tuple(m.shape) for _, m in _spec_leaves(meta)] == [
        w.shape for _, w in want]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_spec_equals_the_reference(arch, reduced):
    t = TLM.lm_spec(TC.get(arch, reduced=reduced))
    j = JLM.lm_spec(JC.get(arch, reduced=reduced))
    assert _spec_rows(t) == _spec_rows(j)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_full(arch):
    assert (TLM.num_params(TC.get(arch))
            == JLM.num_params(JC.get(arch)))


def test_qwen3_4b_size_on_meta():
    cfg = TC.get("qwen3-4b")
    assert TLM.num_params(cfg) == 4_022_468_096
    meta = TL.abstract_params(TLM.lm_spec(cfg))
    leaves = [t for _, t in _spec_leaves(meta)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) \
        == 8_044_936_192
    cache = TLM.abstract_cache(cfg, 8, 576)
    k = cache["stage"]["0"]["k"]
    assert k.device.type == "meta" and tuple(k.shape) == (36, 8, 576, 8, 128)
    assert k.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_f32(arch, record_property):
    jcfg, tcfg = JC.get(arch, reduced=True), TC.get(arch, reduced=True)
    pj = _jax_params(jcfg, jnp.float32)
    pt = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, pj),
                              device="cpu")
    tokens, prefix = _inputs(jcfg)
    want = JLM.lm_forward(pj, tokens, jcfg, prefix_embeds=None if prefix
                          is None else jnp.asarray(prefix))
    got = TLM.lm_forward(pt, torch.from_numpy(tokens).long(), tcfg,
                         prefix_embeds=None if prefix is None
                         else torch.from_numpy(prefix))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape)
    record_property("max_abs_diff",
                    float(np.abs(got.numpy() - np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **f32_tol(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_bf16(arch, record_property):
    jcfg, tcfg = JC.get(arch, reduced=True), TC.get(arch, reduced=True)
    pj = _jax_params(jcfg)
    pt = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, pj),
                              device="cpu")
    assert pt["embed"].dtype == torch.bfloat16
    tokens, prefix = _inputs(jcfg)
    with jax_mode(arch, "bf16"):
        want = np.asarray(JLM.lm_forward(
            pj, tokens, jcfg, prefix_embeds=None if prefix is None
            else jnp.asarray(prefix, jnp.bfloat16)), np.float32)
    got = TLM.lm_forward(pt, torch.from_numpy(tokens).long(), tcfg,
                         prefix_embeds=None if prefix is None
                         else torch.from_numpy(prefix).to(torch.bfloat16))
    got = got.numpy()
    record_property("max_abs_diff", float(np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, **BF16)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5
    assert np.isfinite(got).all()


def test_lm_forward_last_only_is_the_tail_of_the_full_forward():
    cfg = TC.get("gemma3-27b", reduced=True)
    p = TL.init_params(TLM.lm_spec(cfg),
                       generator=torch.Generator().manual_seed(0))
    p = TL.tree_map(lambda a: a.float(), p)
    tokens = torch.randint(1, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    full = TLM.lm_forward(p, tokens, cfg)
    last, cache = TLM.lm_forward(p, tokens, cfg, last_only=True,
                                 return_cache=True)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
    assert tuple(cache["stage"]["0"]["k"].shape) == (
        cfg.repeats, 2, 20, cfg.n_kv, cfg.head_dim)
    assert tuple(cache["tail"]["1"]["v"].shape) == (2, 20, cfg.n_kv,
                                                    cfg.head_dim)


def test_padded_vocab_is_masked():
    cfg = dataclasses.replace(TC.get("qwen3-4b", reduced=True),
                              vocab=500, vocab_pad_to=64)
    assert cfg.vocab_padded == 512
    p = TL.init_params(TLM.lm_spec(cfg),
                       generator=torch.Generator().manual_seed(0))
    logits = TLM.lm_forward(p, torch.ones(1, 3, dtype=torch.long), cfg)
    assert logits.shape[-1] == 512
    assert torch.all(logits[..., 500:] == -1e9)
    assert torch.all(logits[..., :500] > -1e8)


def test_language_model_module_holds_the_tree():
    cfg = TC.get("qwen2-72b", reduced=True)
    model = TLM.LanguageModel(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    rows = sorted(n for n, _ in model.named_parameters())
    assert "weights.stage.0.attn.bq" in rows
    assert sum(p.numel() for p in model.parameters()) == TLM.num_params(cfg)
    assert not any(p.requires_grad for p in model.parameters())
    tree = model.params
    assert [(path, tuple(t.shape)) for path, t in _spec_leaves(tree)] == [
        (path, s.shape) for path, s in _spec_leaves(TLM.lm_spec(cfg))]
    tokens = torch.randint(1, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        torch.testing.assert_close(model(tokens),
                                   TLM.lm_forward(tree, tokens, cfg))
    with pytest.raises(ValueError):
        TLM.LanguageModel(cfg)


def test_lm_params_from_numpy_checks_keys_shapes_and_dtypes():
    cfg = TC.get("minitron-4b", reduced=True)
    tree = jax.tree.map(np.asarray, _jax_params(JC.get("minitron-4b",
                                                       reduced=True)))
    pt = lm_params_from_numpy(cfg, tree, device="cpu")
    # bf16 bits pass through unchanged
    np.testing.assert_array_equal(
        pt["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, final_norm=np.zeros(cfg.d_model, np.int32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lm_params_from_numpy(cfg, bad, device="cpu")
