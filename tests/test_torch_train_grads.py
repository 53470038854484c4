"""Gradients of the port's layers against the JAX package's, where the
backward is delicate, in float32 on the same numpy inputs, params and
cotangents.

* ``grad_cast_bf16``: the reference's backward hands a bf16 cotangent on
  (for a float32 primal too); the port's rounds it to the same bf16
  values and torch keeps it in the primal's dtype (ROADMAP §3).
* ``blockwise_attention``: rows and blocks the mask hides entirely
  (padding to the chunks, causal blocks, sliding windows, both skip
  bands, a cross attention whose keys are padded) give finite gradients,
  equal to JAX's, zero for padded positions.
* MoE at capacities 1, 3 and T*k: dropped (token, expert) pairs and the
  sentinel row pass no gradient; every gradient finite and equal.
* RG-LRU's associative-scan tree and the mLSTM/sLSTM exponential gates
  from their -inf stabilizers at S = 12 and 70 (past the reference's
  64-step chunks).

Every gradient is compared at ``rtol = atol = 1e-4`` (float32), after
checking that it is finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_reference import exact_float32
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_grads(fn, args, cot):
    """Gradients of sum(fn(*args) * cot) w.r.t. every leaf of ``args``
    (numpy float32 arrays or dicts of them), each checked finite."""
    live = [TL.tree_map(lambda a: _t(a).requires_grad_(), a) for a in args]
    (fn(*live) * _t(cot)).sum().backward()
    for t in (t for a in live for t in TL.leaves(a)):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    return [TL.tree_map(lambda t: t.grad.numpy(), a) for a in live]


def _jax_grads(fn, args, cot):
    _, vjp = jax.vjp(jax.jit(fn), *jax.tree.map(jnp.asarray, args))
    return jax.tree.map(np.asarray, vjp(jnp.asarray(cot)))


def _assert_trees(got, want):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            for k in w:
                _assert_trees([g[k]], [w[k]])
        else:
            np.testing.assert_allclose(g, w, **F32)


def test_grad_cast_rounds_the_cotangent_as_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    cot = rng.standard_normal(64).astype(np.float32) * 1.7
    _, vjp = jax.vjp(JL.grad_cast_bf16, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    assert want.dtype == jnp.bfloat16     # a float32 primal, a bf16 cotangent
    xt = _t(x).requires_grad_()
    (TL.grad_cast_bf16(xt) * _t(cot)).sum().backward()
    assert xt.grad.dtype == torch.float32
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(want, np.float32))
    assert not np.array_equal(xt.grad.numpy(), cot)   # it did round
    xb = _t(x).to(torch.bfloat16).requires_grad_()
    (TL.grad_cast_bf16(xb) * _t(cot)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16


# (Sq, Skv, causal, window, skip, q_chunk, kv_chunk)
ATTN = {
    "causal-padded": (40, 40, True, None, False, 16, 16),
    "causal-skip": (40, 40, True, None, True, 16, 8),
    "window": (40, 40, True, 8, False, 8, 8),
    "window-skip": (40, 40, True, 8, True, 8, 8),
    "cross-padded": (12, 20, False, None, False, 8, 16),
}


@pytest.mark.parametrize("case", list(ATTN))
def test_blockwise_attention_grads(case):
    Sq, Skv, causal, window, skip, qc, kc = ATTN[case]
    B, H, Hkv, hd = 2, 4, 2, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    cot = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              skip_masked_blocks=skip)
    want = _jax_grads(lambda *a: JL.blockwise_attention(*a, **kw),
                      (q, k, v), cot)
    got = _port_grads(lambda *a: TL.blockwise_attention(*a, **kw),
                      (q, k, v), cot)
    _assert_trees(got, want)


T, D, FF, E, K = 40, 16, 24, 8, 3


@pytest.mark.parametrize("capacity", [1, 3, T * K])
def test_moe_grads_through_dropped_pairs(capacity):
    """At capacity 1 almost every pair is dropped into the sentinel row;
    at T*k none is."""
    p = JL.init_params(jax.random.PRNGKey(0), JM.moe_spec(D, FF, E, 1))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(topk=K, n_routed=E, capacity=capacity, renormalize=True)
    with exact_float32():
        want = _jax_grads(lambda pp, xx: JM.moe_apply(pp, xx, **kw),
                          (p, x), cot)
        got = _port_grads(lambda pp, xx: TM.moe_apply(pp, xx, **kw),
                          (p, x), cot)
    _assert_trees(got, want)


B_R, D_R, H_R = 2, 32, 2
SCANS = {
    "rglru": (lambda: JR.rglru_spec(D_R, lru_width=24),
              lambda p, x: JR.rglru_scan(p, x)[0],
              lambda p, x: TR.rglru_scan(p, x)[0]),
    "mlstm": (lambda: JS.mlstm_spec(D_R, H_R),
              lambda p, x: JS.mlstm_scan(p, x, n_heads=H_R)[0],
              lambda p, x: TS.mlstm_scan(p, x, n_heads=H_R)[0]),
    "slstm": (lambda: JS.slstm_spec(D_R, H_R),
              lambda p, x: JS.slstm_scan(p, x, n_heads=H_R)[0],
              lambda p, x: TS.slstm_scan(p, x, n_heads=H_R)[0]),
}


@pytest.mark.parametrize("S", [12, 70])
@pytest.mark.parametrize("name", list(SCANS))
def test_recurrent_scan_grads(name, S):
    spec, jscan, tscan = SCANS[name]
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     JL.init_params(jax.random.PRNGKey(0), spec()))
    rng = np.random.default_rng(3)
    if name == "rglru":     # gates away from their zero init
        for k in ("b_a", "b_i", "lam"):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32)
    x = rng.standard_normal((B_R, S, D_R)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want = _jax_grads(jscan, (p, x), cot)
    got = _port_grads(tscan, (p, x), cot)
    _assert_trees(got, want)
