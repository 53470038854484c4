"""Real-Gated Linear Recurrent Unit blocks (Griffin / RecurrentGemma,
arXiv:2402.19427), in PyTorch (the port of ``repro.models.rglru``).

Temporal-mixing block: a gated branch and a (causal conv -> RG-LRU)
branch, multiplied elementwise, then a down-projection. Recurrence:

    r_t = sigmoid(W_a x_t + b_a)                (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                (input gate)
    a_t = exp(c * softplus(Lambda) * (-r_t))    (0 < a_t < 1, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill runs the linear recurrence as the reference's
``jax.lax.associative_scan`` does: the same recursive odd/even tree of
float32 folds (``_associative_scan``), about 2 log2(S) steps over the
whole sequence. The conv buffer is bf16 whatever the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .layers import PSpec, dense, rmsnorm
from .ssm import CONV_W, _causal_conv, _conv_step, _conv_tail

__all__ = ["rglru_spec", "rglru_scan", "rglru_step", "rglru_init_state"]

C_FACTOR = 8.0


def rglru_spec(d_model: int, *, lru_width: Optional[int] = None,
               stack: Optional[int] = None) -> Dict[str, PSpec]:
    dr = lru_width or d_model
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    return {
        "norm": PSpec(st + (d_model,), pre + ".", init="ones"),
        "w_gate": PSpec(st + (d_model, dr), pre + "fsdp,model",
                        fan_in=d_model),
        "w_x": PSpec(st + (d_model, dr), pre + "fsdp,model", fan_in=d_model),
        "conv": PSpec(st + (CONV_W, dr), pre + ".,model", fan_in=CONV_W),
        "w_a": PSpec(st + (dr, dr), pre + "model,.", fan_in=dr),
        "b_a": PSpec(st + (dr,), pre + ".", init="zeros"),
        "w_i": PSpec(st + (dr, dr), pre + "model,.", fan_in=dr),
        "b_i": PSpec(st + (dr,), pre + ".", init="zeros"),
        "lam": PSpec(st + (dr,), pre + ".", init="ones",
                     dtype=torch.float32),
        "w_down": PSpec(st + (dr, d_model), pre + "model,fsdp", fan_in=dr),
    }


def rglru_init_state(batch: int, dr: int, *, device=None):
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_W - 1, dr),
                                dtype=torch.bfloat16, device=device)}


def _lru_gates(p, u):
    uf = u.float()
    r = torch.sigmoid(dense(uf, p["w_a"].float()) + p["b_a"])
    i = torch.sigmoid(dense(uf, p["w_i"].float()) + p["b_i"])
    lam = p["lam"]
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-C_FACTOR * softplus * r)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * (i * uf)


def _fold(left, right):
    """Compose h -> a_l h + b_l, then h -> a_r h + b_r."""
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 1 (len(a) is len(b) or
    one more)."""
    n = a.shape[1] + b.shape[1]
    out = a.new_empty((a.shape[0], n) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(elems):
    """Inclusive scan of ``_fold`` over axis 1 of the pair ``elems``, by
    ``jax.lax.associative_scan``'s recursion: fold adjacent pairs, scan
    the half, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _fold(tuple(e[:, 0:-1:2] for e in elems),
                    tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _fold(tuple(e[:, :-1] for e in odd),
                     tuple(e[:, 2::2] for e in elems))
    else:
        even = _fold(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def rglru_scan(p, x):
    """Prefill. x: (B, S, D) -> (the residual branch's output (B, S, D),
    the state: ``h`` after the last timestep, float32, and the conv
    buffer, bf16)."""
    xn = rmsnorm(x, p["norm"])
    gate = F.gelu(dense(xn, p["w_gate"]).float(), approximate="tanh")
    ux = dense(xn, p["w_x"])
    u = _causal_conv(ux, p["conv"])
    a, bx = _lru_gates(p, u)  # (B, S, dr) each, float32
    _, h = _associative_scan((a, bx))
    y = (gate * h).to(x.dtype)
    state = {"h": h[:, -1].float(), "conv": _conv_tail(ux)}
    return dense(y, p["w_down"]), state


def rglru_step(p, x_t, state):
    """x_t: (B, 1, D); state: {"h": (B, dr) float32, "conv": (B, 3, dr)
    bf16}. Returns (out (B, 1, D), the new state)."""
    xn = rmsnorm(x_t[:, 0], p["norm"])
    gate = F.gelu(dense(xn, p["w_gate"]).float(), approximate="tanh")
    ux = dense(xn, p["w_x"])
    u, conv_buf = _conv_step(state["conv"], ux.to(state["conv"].dtype),
                             p["conv"])
    a, bx = _lru_gates(p, u)
    h = a * state["h"] + bx
    y = (gate * h).to(x_t.dtype)
    out = dense(y, p["w_down"])[:, None, :]
    return out, {"h": h, "conv": conv_buf}
