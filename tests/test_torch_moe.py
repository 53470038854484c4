"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the JAX package's on the same numpy inputs and params.

``_dispatch_compute`` at capacities 1, 3 and T*k, with and without
``renormalize``: the router's expert indices equal ``jax.lax.top_k``'s,
the kept (token, expert) pairs are exact (each expert alone, through the
reference's own ``e_start``/``e_local`` share, gives a non-zero row for
exactly the tokens it kept), the per-expert shares add up to the whole
layer, and the float32 outputs agree to ``rtol = atol = 1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
T, D, FF, E, K = 40, 16, 24, 8, 3


def _params(n_shared=0, seed=0):
    p = JL.init_params(jax.random.PRNGKey(seed), JM.moe_spec(D, FF, E,
                                                            n_shared))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _x(seed=1, n=T):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_dispatch(x, p, *, capacity, renormalize, e_start=0, e_local=E):
    sl = slice(e_start, e_start + e_local)
    return np.asarray(JM._dispatch_compute(
        jnp.asarray(x), jnp.asarray(p["router"]),
        jnp.asarray(p["we_gate"][sl]), jnp.asarray(p["we_up"][sl]),
        jnp.asarray(p["we_down"][sl]), topk=K,
        capacity=capacity, n_routed=E, e_start=e_start, e_local=e_local,
        renormalize=renormalize))


def _port_dispatch(x, p, *, capacity, renormalize, e_start=0, e_local=E):
    sl = slice(e_start, e_start + e_local)
    return TM._dispatch_compute(
        _t(x), _t(p["router"]), _t(p["we_gate"][sl]), _t(p["we_up"][sl]),
        _t(p["we_down"][sl]), topk=K, capacity=capacity, n_routed=E,
        e_start=e_start, e_local=e_local, renormalize=renormalize).numpy()


@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("capacity", [1, 3, T * K])
def test_dispatch_compute_matches_jax(capacity, renormalize):
    p, x = _params(), _x()
    want = _jax_dispatch(x, p, capacity=capacity, renormalize=renormalize)
    got = _port_dispatch(x, p, capacity=capacity, renormalize=renormalize)
    np.testing.assert_allclose(got, want, **F32)

    # the router's choices: jax.lax.top_k over the reference's softmax
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    jgate, jidx = jax.lax.top_k(probs, K)
    tgate, tidx = TM.route(_t(x), _t(p["router"]), topk=K,
                           renormalize=False)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), **F32)

    # kept pairs, expert by expert: each expert's share is non-zero on
    # exactly the tokens it kept, in JAX and in the port alike
    kept_j, kept_t = np.zeros((T, E), bool), np.zeros((T, E), bool)
    total = np.zeros_like(want)
    for e in range(E):
        yj = _jax_dispatch(x, p, capacity=capacity, renormalize=renormalize,
                           e_start=e, e_local=1)
        yt = _port_dispatch(x, p, capacity=capacity,
                            renormalize=renormalize, e_start=e, e_local=1)
        kept_j[:, e] = np.abs(yj).max(-1) > 0
        kept_t[:, e] = np.abs(yt).max(-1) > 0
        np.testing.assert_allclose(yt, yj, **F32)
        total += yt
    np.testing.assert_array_equal(kept_t, kept_j)
    # the shares add up to the whole layer
    np.testing.assert_allclose(total, got, **F32)
    # kept = each expert's first `capacity` choosers in token order
    chosen = np.zeros((T, E), bool)
    chosen[np.arange(T)[:, None], np.asarray(jidx)] = True
    want_kept = chosen & (np.cumsum(chosen, axis=0) <= capacity)
    np.testing.assert_array_equal(kept_t, want_kept)
    assert kept_t.sum() == min(T * K, np.minimum(
        chosen.sum(0), capacity).sum())


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: the lower index first, as jax.lax.top_k."""
    router = torch.zeros(D, E)
    x = torch.ones(2, D)
    _, idx = TM.route(x, router, topk=K, renormalize=True)
    assert idx.tolist() == [[0, 1, 2], [0, 1, 2]]
    jidx = jax.lax.top_k(jnp.full((2, E), 1.0 / E), K)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_apply_matches_jax(n_shared):
    p = _params(n_shared)
    x = np.random.default_rng(2).standard_normal((2, 10, D)).astype(
        np.float32)
    want = np.asarray(JM.moe_apply(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), topk=K, n_routed=E,
                                   capacity=8, renormalize=False))
    got = TM.moe_apply(TL.tree_map(_t, p), _t(x), topk=K, n_routed=E,
                       capacity=8, renormalize=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10, D)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _rows(spec):
    return [(path, tuple(s.shape), s.axes, s.init, s.fan_in,
             _dtype_name(s.dtype)) for path, s in TL._leaves(spec)]


@pytest.mark.parametrize("stack", [None, 3])
def test_moe_spec_equals_the_reference(stack):
    assert (_rows(TM.moe_spec(D, FF, E, 2, stack=stack))
            == _rows(JM.moe_spec(D, FF, E, 2, stack=stack)))


def test_moe_routing_is_sparse_and_complete():
    """The reference's test on the port: with capacity T*k every token
    reaches exactly topk routed experts, and the output is finite."""
    Tn, d, En, k = 64, 16, 8, 2
    p = TL.init_params(TM.moe_spec(d, 32, En, 0),
                       generator=torch.Generator().manual_seed(0))
    x2 = torch.randn(Tn, d, generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    y = TM._dispatch_compute(x2, p["router"], p["we_gate"], p["we_up"],
                             p["we_down"], topk=k, capacity=Tn * k,
                             n_routed=En, e_start=0, e_local=En,
                             renormalize=True)
    assert tuple(y.shape) == (Tn, d) and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y.float()).all())
    reached = torch.zeros(Tn, dtype=torch.long)
    for e in range(En):
        ye = TM._dispatch_compute(
            x2, p["router"], p["we_gate"][e:e + 1], p["we_up"][e:e + 1],
            p["we_down"][e:e + 1], topk=k, capacity=Tn * k, n_routed=En,
            e_start=e, e_local=1, renormalize=True)
        reached += (ye.float().abs().amax(-1) > 0).long()
    assert reached.tolist() == [k] * Tn
