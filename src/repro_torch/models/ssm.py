"""xLSTM blocks (arXiv:2405.04517), in PyTorch (the port of
``repro.models.ssm``): mLSTM (matrix memory) and sLSTM (scalar memory
with exponential gating), with the paper's stabilized gating (the ``m``
state, which starts at -inf), and the depthwise causal conv they share
with the RG-LRU block.

Prefill runs the recurrence one timestep at a time, eagerly, over the S
real timesteps. The reference cuts the time axis into chunks of 64 and
pads it, for the memory of its backward pass; a padded timestep leaves
its state unchanged and its output is sliced off, so looping over the
real timesteps alone gives the same values. Decode advances the state
one step. The conv buffer holds the last ``CONV_W - 1`` inputs of the
conv in bf16, as the reference's does, whatever the model's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import sharding as SH
from .layers import PSpec, dense, rmsnorm

__all__ = [
    "CONV_W", "mlstm_spec", "mlstm_scan", "mlstm_step", "mlstm_init_state",
    "slstm_spec", "slstm_scan", "slstm_step", "slstm_init_state",
]

CONV_W = 4


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C), w: (CONV_W, C); the products
    and their sum in the dtype of ``x`` and ``w`` (promoted)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    pads = F.pad(x.to(dt), (0, 0, CONV_W - 1, 0))
    w = w.to(dt)
    S = x.shape[1]
    out = pads[:, 0:S, :] * w[0]
    for i in range(1, CONV_W):
        out = out + pads[:, i:i + S, :] * w[i]
    return out


def _conv_step(buf, x_t, w):
    """buf: (B, CONV_W-1, C) previous inputs; x_t: (B, C). Returns (the
    conv's output (B, C), the new buffer)."""
    full = torch.cat([buf, x_t[:, None, :]], dim=1)        # (B, CONV_W, C)
    dt = torch.promote_types(full.dtype, w.dtype)
    out = torch.einsum("bwc,wc->bc", full.to(dt), w.to(dt))
    return out, full[:, 1:, :]


def _conv_tail(x):
    """The last CONV_W-1 conv inputs of x (B, S, C), zero-padded in front
    when S < CONV_W-1, in bf16: the decode buffer after a prefill."""
    S = x.shape[1]
    return F.pad(x, (0, 0, CONV_W - 1, 0))[:, S:S + CONV_W - 1].to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(d_model: int, n_heads: int, *, proj_factor: float = 2.0,
               stack: Optional[int] = None) -> Dict[str, PSpec]:
    di = int(d_model * proj_factor)
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    return {
        "norm": PSpec(st + (d_model,), pre + ".", init="ones"),
        "w_up": PSpec(st + (d_model, di), pre + "fsdp,model",
                      fan_in=d_model),
        "w_z": PSpec(st + (d_model, di), pre + "fsdp,model", fan_in=d_model),
        "conv": PSpec(st + (CONV_W, di), pre + ".,model", init="normal",
                      fan_in=CONV_W),
        "w_q": PSpec(st + (di, di), pre + "model,.", fan_in=di),
        "w_k": PSpec(st + (di, di), pre + "model,.", fan_in=di),
        "w_v": PSpec(st + (di, di), pre + "model,.", fan_in=di),
        "w_i": PSpec(st + (d_model, n_heads), pre + "fsdp,.",
                     fan_in=d_model),
        "w_f": PSpec(st + (d_model, n_heads), pre + "fsdp,.",
                     fan_in=d_model),
        "out_norm": PSpec(st + (di,), pre + ".", init="ones"),
        "w_down": PSpec(st + (di, d_model), pre + "model,fsdp", fan_in=di),
    }


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     proj_factor: float = 2.0, dtype=torch.float32,
                     *, device=None):
    di = int(d_model * proj_factor)
    dh = di // n_heads
    return {
        "C": torch.zeros((batch, n_heads, dh, dh), dtype=dtype,
                         device=device),
        "n": torch.zeros((batch, n_heads, dh), dtype=dtype, device=device),
        "m": torch.full((batch, n_heads), -math.inf, dtype=dtype,
                        device=device),
        "conv": torch.zeros((batch, CONV_W - 1, di), dtype=torch.bfloat16,
                            device=device),
    }


def _mlstm_cell(state, q, k, v, i_t, f_t):
    """One recurrent step. q/k/v: (B,H,dh); i_t/f_t: (B,H)
    pre-activations. Stabilized exponential gating (paper eq. 19-27)."""
    C, n, m = state
    dh = q.shape[-1]
    k = k / math.sqrt(dh)
    i_t = i_t.float()
    log_f = F.logsigmoid(f_t.float())
    m_new = torch.maximum(log_f + m, i_t)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    i_g = torch.exp(i_t - m_safe)
    f_g = torch.exp(log_f + torch.where(torch.isfinite(m), m, -math.inf)
                    - m_safe)
    f_g = torch.where(torch.isfinite(m)[..., None, None],
                      f_g[..., None, None], 0.0)
    kf, vf, qf = k.float(), v.float(), q.float()
    C_new = f_g * C + i_g[..., None, None] * (vf[..., :, None]
                                              * kf[..., None, :])
    n_new = f_g[..., :, 0] * n + i_g[..., None] * kf
    h_num = torch.einsum("bhvk,bhk->bhv", C_new, qf)
    h_den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n_new, qf)),
                        min=1.0)
    h = h_num / h_den[..., None]
    return (C_new, n_new, m_new), h


def _mlstm_steps(carry, q, k, v, i_pre, f_pre):
    """The recurrence over the S timesteps of q/k/v (B, S, H, dh) and
    i/f (B, S, H) from ``carry`` (C, n, m): (h (B, S, H * dh) float32,
    the last carry). The inputs are cut into timesteps by one ``unbind``
    each, whose backward stacks the timesteps' gradients once (an index
    per timestep would add S zero-filled copies of the whole input). On
    a mesh (DTensor q) the loop is a region of plain tensors
    (``_mlstm_steps_split``)."""
    if SH.is_dtensor(q):
        return _mlstm_steps_split(carry, q, k, v, i_pre, f_pre)
    hs = []
    for step in zip(*(a.unbind(1) for a in (q, k, v, i_pre, f_pre))):
        carry, h = _mlstm_cell(carry, *step)
        hs.append(h)
    return torch.stack(hs, dim=1).flatten(2), carry


def _head_region(mesh, batch: int, n_heads: int):
    """The spec of the (batch, heads) axes of a recurrence's region:
    the batch over the batch axes and the heads over "model", each
    where it divides; and a function that gives a tensor's local block
    with those two axes at ``dims`` (a plain tensor is whole on every
    rank: a fresh state), its other axes whole."""
    bh = SH.logical_to_spec(mesh, ("batch", "heads"), (batch, n_heads))

    def spec(ndim, dims):
        out = [None] * ndim
        out[dims[0]], out[dims[1]] = bh
        return tuple(out)

    def local(t, dims):
        sp = spec(t.ndim, dims)
        if not SH.is_dtensor(t):
            t = SH.place(mesh, t, (None,) * t.ndim)
        return SH.local_region(t, sp, SH.placements(mesh, sp))
    return bh, spec, local


def _mlstm_steps_split(carry, q, k, v, i_pre, f_pre):
    """``_mlstm_steps`` on a mesh: each rank runs the recurrence on its
    block of the batch and of the heads (the heads over "model" where
    they divide, else all of them on each of its ranks), since it mixes
    no two rows and no two heads; each block's gradients are its own.
    The heads are merged inside the region, so no DTensor view splits a
    gradient back into heads the "model" axis does not divide."""
    mesh = q.device_mesh
    B, S, H, dh = q.shape
    _, spec, local = _head_region(mesh, B, H)
    h, (C, n, m) = _mlstm_steps(
        tuple(local(t, (0, 1)) for t in carry),
        *(local(t, (0, 2)) for t in (q, k, v, i_pre, f_pre)))

    def whole(t, dims, shape):
        return SH.from_region(t, mesh, SH.placements(
            mesh, spec(len(shape), dims)), shape)
    return (whole(h, (0, 2), (B, S, H * dh)),
            (whole(C, (0, 1), (B, H, dh, dh)), whole(n, (0, 1), (B, H, dh)),
             whole(m, (0, 1), (B, H))))


def _mlstm_gates(p, xn, up):
    c = F.silu(_causal_conv(up, p["conv"]).float()).to(up.dtype)
    q = dense(c, p["w_q"])
    k = dense(c, p["w_k"])
    v = dense(up, p["w_v"])
    i_pre = dense(xn, p["w_i"])
    f_pre = dense(xn, p["w_f"])
    return q, k, v, i_pre, f_pre


def mlstm_scan(p, x, *, n_heads: int):
    """Prefill. x: (B, S, D) -> (the residual branch's output (B, S, D),
    the state after the last timestep)."""
    B, S, D = x.shape
    xn = rmsnorm(x, p["norm"])
    up = dense(xn, p["w_up"])
    z = dense(xn, p["w_z"])
    di = up.shape[-1]
    dh = di // n_heads
    q, k, v, i_pre, f_pre = _mlstm_gates(p, xn, up)
    q, k, v = (a.reshape(B, S, n_heads, dh) for a in (q, k, v))

    dev = x.device
    carry = (torch.zeros((B, n_heads, dh, dh), device=dev),
             torch.zeros((B, n_heads, dh), device=dev),
             torch.full((B, n_heads), -math.inf, device=dev))
    h, carry = _mlstm_steps(carry, q, k, v, i_pre, f_pre)
    h = h.to(x.dtype)
    h = rmsnorm(h, p["out_norm"])
    h = h * F.silu(z.float()).to(x.dtype)
    Cf, nf, mf = carry
    state = {"C": Cf, "n": nf, "m": mf, "conv": _conv_tail(up)}
    return dense(h, p["w_down"]), state


def mlstm_step(p, x_t, state, *, n_heads: int):
    """Single-token decode. x_t: (B, 1, D); state from
    ``mlstm_init_state``. Returns (out (B, 1, D), the new state)."""
    B = x_t.shape[0]
    xn = rmsnorm(x_t[:, 0], p["norm"])
    up = dense(xn, p["w_up"])
    z = dense(xn, p["w_z"])
    di = up.shape[-1]
    dh = di // n_heads
    c, conv_buf = _conv_step(state["conv"], up.to(state["conv"].dtype),
                             p["conv"])
    c = F.silu(c.float()).to(up.dtype)
    q = dense(c, p["w_q"]).reshape(B, 1, n_heads, dh)
    k = dense(c, p["w_k"]).reshape(B, 1, n_heads, dh)
    v = dense(up, p["w_v"]).reshape(B, 1, n_heads, dh)
    i_pre = dense(xn, p["w_i"])[:, None]
    f_pre = dense(xn, p["w_f"])[:, None]
    h, (C, n, m) = _mlstm_steps((state["C"], state["n"], state["m"]),
                                q, k, v, i_pre, f_pre)
    h = h.reshape(B, di).to(x_t.dtype)
    h = rmsnorm(h, p["out_norm"])
    h = h * F.silu(z.float()).to(x_t.dtype)
    out = dense(h, p["w_down"])[:, None, :]
    return out, {"C": C, "n": n, "m": m, "conv": conv_buf}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(d_model: int, n_heads: int, *, ff_factor: float = 4.0 / 3.0,
               stack: Optional[int] = None) -> Dict[str, PSpec]:
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    dff = int(d_model * ff_factor)
    return {
        "norm": PSpec(st + (d_model,), pre + ".", init="ones"),
        "w_gates": PSpec(st + (d_model, 4 * d_model), pre + "fsdp,model",
                         fan_in=d_model),
        "r_gates": PSpec(st + (n_heads, d_model // n_heads,
                               4 * (d_model // n_heads)),
                         pre + ".,.,.", fan_in=d_model),
        "out_norm": PSpec(st + (d_model,), pre + ".", init="ones"),
        "ffn_norm": PSpec(st + (d_model,), pre + ".", init="ones"),
        "w_ff_gate": PSpec(st + (d_model, dff), pre + "fsdp,model",
                           fan_in=d_model),
        "w_ff_up": PSpec(st + (d_model, dff), pre + "fsdp,model",
                         fan_in=d_model),
        "w_ff_down": PSpec(st + (dff, d_model), pre + "model,fsdp",
                           fan_in=dff),
    }


def slstm_init_state(batch: int, d_model: int, dtype=torch.float32, *,
                     device=None):
    def z():
        return torch.zeros((batch, d_model), dtype=dtype, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, d_model), -math.inf, dtype=dtype,
                            device=device)}


def _slstm_cell(p, state, gx, n_heads: int):
    """gx: (B, 4D) input gate pre-activations. Head-blocked recurrence."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B, D = c.shape
    dh = D // n_heads
    hr = h.reshape(B, n_heads, dh).float()
    rec = torch.einsum("bhk,hkg->bhg", hr, p["r_gates"].float())
    g = gx.float().reshape(B, n_heads, 4 * dh) + rec
    zi, ii, fi, oi = (a.reshape(B, D) for a in torch.split(g, dh, dim=-1))
    zt = torch.tanh(zi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m, ii)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    i_g = torch.exp(ii - m_safe)
    f_g = torch.where(torch.isfinite(m), torch.exp(log_f + m - m_safe), 0.0)
    c_new = f_g * c + i_g * zt
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_steps(p, state, gx, n_heads: int):
    """The recurrence over the S timesteps of gx (B, S, 4D) from
    ``state``: (h (B, S, D) float32, the last state). On a mesh (DTensor
    gx) the loop is a region of plain tensors (``_slstm_steps_split``)."""
    if SH.is_dtensor(gx):
        return _slstm_steps_split(p, state, gx, n_heads)
    hs = []
    for g in gx.unbind(1):
        state = _slstm_cell(p, state, g, n_heads)
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def _slstm_steps_split(p, state, gx, n_heads: int):
    """``_slstm_steps`` on a mesh: each rank runs the recurrence on its
    block of the batch and of the heads (over "model" where they divide,
    else all of them on each of its ranks), the gates and the state in
    whole heads, since it mixes no two rows and no two heads. The
    recurrent weights' local gradient is a part of the sum over the batch
    axes that split the rows."""
    mesh = gx.device_mesh
    B, S, D = gx.shape[0], gx.shape[1], gx.shape[2] // 4
    bh, spec, local = _head_region(mesh, B, n_heads)
    rspec = (bh[1], None, None)
    r = SH.local_region(p["r_gates"], rspec, SH.placements(
        mesh, rspec, SH.axes_of(bh[0])))
    split = SH.axis_size(mesh, bh[1]) if bh[1] else 1
    h, state = _slstm_steps({"r_gates": r},
                            {k: local(t, (0, 1)) for k, t in state.items()},
                            local(gx, (0, 2)), n_heads // split)
    pl = SH.placements(mesh, bh)
    return (SH.from_region(h, mesh, SH.placements(mesh, spec(3, (0, 2))),
                           (B, S, D)),
            {k: SH.from_region(t, mesh, pl, (B, D))
             for k, t in state.items()})


def _slstm_ffn(p, x, h):
    """The block's post-FFN (ff factor 4/3, gated) around the inner
    residual ``x + h``; returns ``h`` plus its output."""
    y = x + h
    yn = rmsnorm(y, p["ffn_norm"])
    ff = (F.silu(dense(yn, p["w_ff_gate"]).float()).to(x.dtype)
          * dense(yn, p["w_ff_up"]))
    return h + dense(ff, p["w_ff_down"])


def slstm_scan(p, x, *, n_heads: int):
    """Prefill. x: (B, S, D) -> (the residual branch's output, the state
    after the last timestep)."""
    B, S, D = x.shape
    xn = rmsnorm(x, p["norm"])
    gx = dense(xn, p["w_gates"])  # (B, S, 4D)
    state = slstm_init_state(B, D, device=x.device)
    h, state = _slstm_steps(p, state, gx, n_heads)
    h = h.to(x.dtype)
    h = rmsnorm(h, p["out_norm"])
    return _slstm_ffn(p, x, h), state


def slstm_step(p, x_t, state, *, n_heads: int):
    """Single-token decode. x_t: (B, 1, D). Returns (out (B, 1, D), the
    new state)."""
    xn = rmsnorm(x_t[:, 0], p["norm"])
    gx = dense(xn, p["w_gates"])
    h, state = _slstm_steps(p, state, gx[:, None], n_heads)
    h = rmsnorm(h[:, 0].to(x_t.dtype), p["out_norm"])
    return _slstm_ffn(p, x_t[:, 0], h)[:, None, :], state
