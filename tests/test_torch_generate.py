"""The port's serving path in bf16, the serving dtype, against the JAX
package's on every reduced config (JAX's params converted through
``convert.lm_params_from_numpy``): prefill, then decode steps
teacher-forced on JAX's greedy tokens, every step's logits within the
reference's own tolerance (``atol = 0.75, rtol = 0.1``, top-1 >= 0.5;
tests/test_models.py), and the port's token equal to JAX's wherever
JAX's top-1 margin exceeds that tolerance; ``greedy_generate`` free
running. The float32 run is tests/test_torch_serve.py's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_reference import (ARCHS, B, BF16, MAX_LEN, STEPS, T, margin_tol,
                           port, reference, start)
from repro import configs as JC
from repro.serve import engine as JS
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_bf16(arch, record_property):
    ref = reference(arch, "bf16")
    cfg, params, prefix = port(arch, ref)
    prefill, decode, init_cache = TS.make_serve_fns(
        cfg, batch=B, max_len=MAX_LEN, device="cpu")
    logits, pre = prefill(params, ref["tokens"][:, :T], prefix)
    got = logits.numpy()
    cache = TS.place_prefill_cache(cfg, pre, init_cache(), T)
    greedy = ref["greedy"]
    steps = [(got, ref["pre_logits"])]
    for i in range(STEPS):
        logits, cache = decode(params, cache, greedy[:, i:i + 1],
                               start(cfg) + i)
        steps.append((logits.numpy(), ref["step_logits"][i]))
    record_property("max_abs_diff", max(float(np.abs(g - w).max())
                                        for g, w in steps))
    for i, (g, w) in enumerate(steps):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **BF16)
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= 0.5
        margin, tol = margin_tol(w[:, -1])
        sure = margin > tol
        np.testing.assert_array_equal(g[:, -1].argmax(-1)[sure],
                                      greedy[:, i][sure])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_bf16(arch):
    """Free-running greedy tokens equal JAX's up to the first step where a
    row's JAX margin is within the tolerance (after it, both are right)."""
    ref = reference(arch, "bf16")
    cfg, params, prefix = port(arch, ref)
    out = TS.greedy_generate(cfg, params, ref["tokens"][:, :T],
                             num_new=STEPS + 1, prefix=prefix, device="cpu")
    assert out.shape == (B, STEPS + 1) and out.dtype == np.int32
    want = ref["greedy"]
    for b in range(B):
        for i, w in enumerate([ref["pre_logits"]] + ref["step_logits"]):
            margin, tol = margin_tol(w[b, -1])
            if margin <= tol:
                break
            assert out[b, i] == want[b, i], (b, i)


def test_reference_tokens_are_jax_greedy_generate():
    """The reference run's tokens are what the JAX package's own
    greedy_generate gives (without a prefix the two decode alike)."""
    ref = reference("qwen3-4b", "bf16")
    jgreedy = JS.greedy_generate(JC.get("qwen3-4b", reduced=True),
                                 ref["params"], ref["tokens"][:, :T],
                                 num_new=STEPS + 1)
    np.testing.assert_array_equal(jgreedy, ref["greedy"])


def test_vlm_greedy_decodes_after_the_prefix():
    """With a prefix, the reference's greedy_generate starts decoding at
    position S (over the prefix's cache entries) and sizes its buffers
    without the prefix (ROADMAP §3); its consistency test decodes at
    S + prefix_len, and so does the port."""
    arch = "internvl2-76b"
    ref = reference(arch, "bf16")
    jcfg = JC.get(arch, reduced=True)
    jgreedy = JS.greedy_generate(
        jcfg, ref["params"], ref["tokens"][:, :T], num_new=STEPS + 1,
        prefix=jnp.asarray(ref["prefix"], jnp.bfloat16))
    assert not np.array_equal(jgreedy, ref["greedy"])
    cfg, params, prefix = port(arch, ref)
    out = TS.greedy_generate(cfg, params, ref["tokens"][:, :T],
                             num_new=STEPS + 1, prefix=prefix, device="cpu")
    assert out[:, 0].tolist() == ref["greedy"][:, 0].tolist()
    # a prefix longer than the reference's default buffer
    big = dataclasses.replace(cfg, prefix_len=3 * T)
    p = TL.init_params(TLM.lm_spec(big),
                       generator=torch.Generator().manual_seed(0))
    long_prefix = torch.zeros(B, 3 * T, cfg.d_model, dtype=torch.bfloat16)
    out = TS.greedy_generate(big, p, ref["tokens"][:, :T], num_new=3,
                             prefix=long_prefix, device="cpu")
    assert out.shape == (B, 3)
