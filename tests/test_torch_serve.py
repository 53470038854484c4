"""The port's serving path (``repro_torch.serve.engine`` over
``repro_torch.models.lm``) against the JAX package's on every reduced
config in float32, with JAX's params cast to float32 and converted
through ``convert.lm_params_from_numpy``.

The prefill caches and logits agree to ``rtol = atol = 1e-4`` (atol 5e-4
for xlstm-350m: tests/_lm_reference.py says why);
``place_prefill_cache`` and one ``lm_decode_step`` from the same placed
cache agree to that tolerance in the logits and float32 states (recurrent
``h``/``C``/``n``/``m``/``c``, replaced outright) and to one bf16 ulp in
the bf16 buffers (k/v, MLA latents, conv inputs: a float32 value a few
ulps off may round to the neighbouring bf16 value). The bf16 run is
tests/test_torch_generate.py's.
"""
import numpy as np
import pytest
import torch

from _lm_reference import (ARCHS, B, BF16, MAX_LEN, T, assert_tree,
                           bf16_cache_tol, f32_tol, port, reference, start,
                           torch_tree)
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_caches_f32(arch):
    ref = reference(arch, "f32")
    cfg, params, prefix = port(arch, ref)
    prefill, _, init_cache = TS.make_serve_fns(cfg, batch=B, max_len=MAX_LEN,
                                               device="cpu")
    logits, pre = prefill(params, ref["tokens"][:, :T], prefix)
    f32 = f32_tol(arch)
    np.testing.assert_allclose(logits.numpy(), ref["pre_logits"], **f32)
    bf16 = bf16_cache_tol(arch)
    assert_tree(pre, ref["pre_cache"], f32=f32, bf16=bf16)
    for entry in pre["stage"].values():
        if "k" in entry:
            assert tuple(entry["k"].shape) == (cfg.repeats, B, start(cfg),
                                               cfg.n_kv, cfg.head_dim)
    buffers = init_cache()
    placed = TS.place_prefill_cache(cfg, pre, buffers, T)
    same = []
    TL.tree_map(lambda a, b: same.append(a is b), placed, buffers)
    assert all(same)                      # written into the buffers
    assert_tree(placed, ref["placed"], f32=f32, bf16=bf16)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_step_f32(arch, record_property):
    """From JAX's placed cache: the logits and the cache after one step."""
    ref = reference(arch, "f32")
    cfg, params, _ = port(arch, ref)
    _, decode, _ = TS.make_serve_fns(cfg, batch=B, max_len=MAX_LEN,
                                     device="cpu")
    cache = torch_tree(ref["placed"])
    tok = torch.from_numpy(ref["greedy"][:, :1]).long()
    logits, out = decode(params, cache, tok, start(cfg))
    assert out is cache                   # written in place
    record_property("max_abs_diff", float(np.abs(
        logits.numpy() - ref["step_logits"][0]).max()))
    f32 = f32_tol(arch)
    np.testing.assert_allclose(logits.numpy(), ref["step_logits"][0], **f32)
    assert_tree(out, ref["after_one"], f32=f32, bf16=bf16_cache_tol(arch))


def test_prefill_decode_consistency_on_the_port():
    """The reference's own check on the port alone (bf16): decode at
    position T from the prefill cache equals the full forward at T."""
    cfg = TC.get("gemma3-27b", reduced=True)
    p = TL.init_params(TLM.lm_spec(cfg),
                       generator=torch.Generator().manual_seed(4))
    tokens = np.random.default_rng(5).integers(1, cfg.vocab, (B, 21))
    full = TLM.lm_forward(p, torch.from_numpy(tokens), cfg, last_only=True)
    prefill, decode, init_cache = TS.make_serve_fns(cfg, batch=B,
                                                    max_len=24, device="cpu")
    _, pre = prefill(p, tokens[:, :20])
    cache = TS.place_prefill_cache(cfg, pre, init_cache(), 20)
    lg, _ = decode(p, cache, tokens[:, 20:], 20)
    a, b = full[:, -1].numpy(), lg[:, -1].numpy()
    np.testing.assert_allclose(a, b, **BF16)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.5
