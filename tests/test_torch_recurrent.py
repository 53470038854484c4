"""The port's recurrent mixers (``repro_torch.models.rglru`` and the mLSTM
and sLSTM of ``repro_torch.models.ssm``) against the JAX package's, in
float32 on the same numpy inputs and params.

Each ``*_scan`` (prefill) at S = 12 and S = 70 (not a multiple of the
reference's 64-step chunks, so its padded timesteps are crossed): output
and final state agree to ``rtol = atol = 1e-5``. The RG-LRU's scan folds
in ``jax.lax.associative_scan``'s tree; mLSTM and sLSTM step one timestep
at a time, as the reference's scan does, with the matrix products of
each step in their own order: ``1e-5`` holds for both. Each ``*_step``
(decode) from JAX's prefill state: output and state to ``1e-5``, the conv
buffer (bf16 in every model dtype) exactly. On the port alone, a scan
over S then one step equals the scan over S + 1 at its last position.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
B, D, H = 2, 32, 2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(S, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


# (name, spec, scan, step, torch scan, torch step) per mixer
MIXERS = {
    "rglru": (lambda: JR.rglru_spec(D, lru_width=24),
              lambda p, x: JR.rglru_scan(p, x),
              lambda p, x, s: JR.rglru_step(p, x, s),
              lambda p, x: TR.rglru_scan(p, x),
              lambda p, x, s: TR.rglru_step(p, x, s)),
    "mlstm": (lambda: JS.mlstm_spec(D, H),
              lambda p, x: JS.mlstm_scan(p, x, n_heads=H),
              lambda p, x, s: JS.mlstm_step(p, x, s, n_heads=H),
              lambda p, x: TS.mlstm_scan(p, x, n_heads=H),
              lambda p, x, s: TS.mlstm_step(p, x, s, n_heads=H)),
    "slstm": (lambda: JS.slstm_spec(D, H),
              lambda p, x: JS.slstm_scan(p, x, n_heads=H),
              lambda p, x, s: JS.slstm_step(p, x, s, n_heads=H),
              lambda p, x: TS.slstm_scan(p, x, n_heads=H),
              lambda p, x, s: TS.slstm_step(p, x, s, n_heads=H)),
}


def _params(name, seed=0):
    p = JL.init_params(jax.random.PRNGKey(seed), MIXERS[name][0]())
    p = _np(p)
    if name == "rglru":
        # gates away from their zero init, so the recurrence moves
        rng = np.random.default_rng(seed)
        for k in ("b_a", "b_i", "lam"):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32)
    return p


def _assert_state(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("S", [12, 70])
@pytest.mark.parametrize("name", list(MIXERS))
def test_scan_matches_jax(name, S):
    _, jscan, _, tscan, _ = MIXERS[name]
    p, x = _params(name), _x(S)
    want, wstate = jscan(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, state = tscan(TL.tree_map(_t, p), _t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _assert_state(state, wstate, **F32)
    if "conv" in state:
        assert state["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            state["conv"].float().numpy(),
            np.asarray(wstate["conv"], np.float32))


@pytest.mark.parametrize("S", [12, 70])
@pytest.mark.parametrize("name", list(MIXERS))
def test_step_from_the_prefill_state_matches_jax(name, S):
    _, jscan, jstep, _, tstep = MIXERS[name]
    p, x = _params(name), _x(S + 1, seed=2)
    jp = jax.tree.map(jnp.asarray, p)
    _, jstate = jscan(jp, jnp.asarray(x[:, :S]))
    want, wnew = jstep(jp, jnp.asarray(x[:, S:]), jstate)
    state = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jstate.items()}
    got, new = tstep(TL.tree_map(_t, p), _t(x[:, S:]), state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _assert_state(new, wnew, **F32)
    for k, v in new.items():
        assert v.dtype == (torch.bfloat16 if k == "conv" else torch.float32)


@pytest.mark.parametrize("name", list(MIXERS))
def test_scan_then_step_equals_the_longer_scan(name):
    _, _, _, tscan, tstep = MIXERS[name]
    p = TL.tree_map(_t, _params(name, seed=3))
    x = _t(_x(13, seed=4))
    full, _ = tscan(p, x)
    _, state = tscan(p, x[:, :12])
    step, _ = tstep(p, x[:, 12:], state)
    # the step's conv reads bf16-rounded inputs (the reference's buffer),
    # the longer scan float32 ones: 2e-2 for the mixers with a conv
    tol = F32 if name == "slstm" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(step[:, 0], full[:, 12], **tol)


def test_initial_states():
    """m starts at -inf; the conv buffers are bf16; the rest zero."""
    m = TS.mlstm_init_state(2, D, H)
    assert m["m"].shape == (2, H) and bool(torch.all(m["m"] == -math.inf))
    assert m["conv"].dtype == torch.bfloat16
    assert tuple(m["C"].shape) == (2, H, D, D)   # dh = 2 D / H
    s = TS.slstm_init_state(2, D)
    assert bool(torch.all(s["m"] == -math.inf))
    assert all(bool(torch.all(s[k] == 0)) for k in ("c", "n", "h"))
    r = TR.rglru_init_state(2, 24)
    assert r["conv"].dtype == torch.bfloat16 and r["h"].dtype == torch.float32
    j = JS.mlstm_init_state(2, D, H)
    for k in m:
        assert tuple(m[k].shape) == j[k].shape


@pytest.mark.parametrize("S", [1, 2, 5])
def test_associative_scan_is_the_sequential_recurrence(S):
    g = torch.Generator().manual_seed(S)
    a = torch.rand(3, S, 4, generator=g)
    b = torch.randn(3, S, 4, generator=g)
    _, h = TR._associative_scan((a, b))
    want, prev = [], torch.zeros(3, 4)
    for t in range(S):
        prev = a[:, t] * prev + b[:, t]
        want.append(prev)
    torch.testing.assert_close(h, torch.stack(want, 1), **F32)
