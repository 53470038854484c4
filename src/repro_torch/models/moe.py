"""Fine-grained Mixture-of-Experts (DeepSeek-MoE / DeepSeek-V2 style), in
PyTorch (the port of ``repro.models.moe``): ``n_shared`` always-on
experts plus ``n_routed`` experts with top-k routing.

Dispatch is the reference's receiver-side scatter on one device: the
(token, expert) pairs are sorted by expert (a stable sort, so within an
expert they keep token order), each expert's first ``capacity`` pairs
fill its row of an ``(e_local + 1, capacity, d)`` buffer and the rest are
dropped. The extra last row is a sentinel that absorbs every dropped or
foreign slot; it is never read. The expert products over the buffers are
batched matmuls.

On a mesh with a "model" axis the routed experts run expert-parallel, as
the reference's ``shard_map`` branch: the experts are split over "model"
(``e_local = n_routed // em`` a rank), the tokens over ("pod", "data")
and replicated over "model"; each rank dispatches its data shard's
tokens to its own experts (``e_start = rank * e_local``) on plain local
tensors, and a sum over "model" (a ``Partial`` DTensor made Replicate: an
all-reduce whose backward hands each rank the whole cotangent) combines
them. Capacity is per data shard (``lm._apply_ffn``). On a mesh without
"model" the routed layer runs on the whole batch on every rank, as the
reference's global dispatch does there.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import sharding as SH
from .layers import PSpec, grad_cast_bf16, mlp_apply, mlp_spec

__all__ = ["moe_spec", "moe_apply", "route"]


def moe_spec(d_model: int, d_ff_expert: int, n_routed: int, n_shared: int,
             *, stack: Optional[int] = None) -> Dict[str, PSpec]:
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    s = {
        "router": PSpec(st + (d_model, n_routed), pre + ".,.",
                        dtype=torch.float32, fan_in=d_model),
        "we_gate": PSpec(st + (n_routed, d_model, d_ff_expert),
                         pre + "expert,fsdp,.", fan_in=d_model),
        "we_up": PSpec(st + (n_routed, d_model, d_ff_expert),
                       pre + "expert,fsdp,.", fan_in=d_model),
        "we_down": PSpec(st + (n_routed, d_ff_expert, d_model),
                         pre + "expert,.,fsdp", fan_in=d_ff_expert),
    }
    if n_shared:
        s["shared"] = mlp_spec(d_model, d_ff_expert * n_shared, gated=True,
                               stack=stack)
    return s


def _expert_ffn(wg, wu, wd, buf):
    """buf: (E, C, d) -> (E, C, d). Gated SiLU experts; SiLU in float32,
    cast back before the product with ``up``."""
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, wd)


def route(x2, p_router, *, topk: int, renormalize: bool):
    """The router's choices for tokens ``x2`` (T, d): float32 softmax over
    every expert, then the ``topk`` largest, the lower expert index first
    on ties (``jax.lax.top_k``'s order: a stable descending sort, which
    ``torch.topk`` does not promise). Returns (gates (T, k) float32,
    experts (T, k) int64)."""
    logits = x2.float() @ p_router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = vals[:, :topk], idx[:, :topk]
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, idx


def _dispatch_compute(x2, p_router, wg, wu, wd, *, topk: int, capacity: int,
                      n_routed: int, e_start: int, e_local: int,
                      renormalize: bool):
    """Receiver-side scatter for the ``e_local`` experts held here, from
    global expert ``e_start`` on (all of them on one card). x2: (T, d);
    wg/wu/wd hold only these experts. Returns their part of the output,
    (T, d)."""
    T, d = x2.shape
    dev = x2.device
    gate_vals, idx = route(x2, p_router, topk=topk, renormalize=renormalize)

    # the (token, expert) pairs these experts own; others go to the
    # sentinel row e_local
    e_loc = idx - e_start
    mine = (e_loc >= 0) & (e_loc < e_local)
    flat_e = torch.where(mine, e_loc, e_local).reshape(-1)     # (T*k,)
    slot_tok = torch.arange(T * topk, device=dev) // topk

    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = slot_tok[order]
    start_of_e = torch.searchsorted(
        e_sorted, torch.arange(e_local + 1, device=dev))
    pos = torch.arange(T * topk, device=dev) - start_of_e[
        torch.clamp(e_sorted, max=e_local)]
    ok = (e_sorted < e_local) & (pos < capacity)

    buf = x2.new_zeros((e_local + 1, capacity, d))
    tgt_e = torch.where(ok, e_sorted, e_local)
    tgt_p = torch.where(ok, pos, 0)
    # dropped slots all write zeros into the sentinel row's slot 0
    buf[tgt_e, tgt_p] = torch.where(ok[:, None], x2[tok_sorted], 0.0)

    out_buf = _expert_ffn(wg, wu, wd, buf[:-1])

    flat = torch.clamp(tgt_e * capacity + tgt_p, max=e_local * capacity - 1)
    y_sorted = torch.where(ok[:, None], out_buf.reshape(-1, d)[flat], 0.0)
    y_slots = x2.new_zeros((T * topk, d))
    y_slots[order] = y_sorted
    gates = gate_vals.reshape(T * topk).to(x2.dtype)
    return (y_slots * gates[:, None]).reshape(T, topk, d).sum(dim=1)


def _expert_parallel(p, x2, mesh, **kw):
    """The routed experts of ``x2`` (T, d), a DTensor, on ``mesh``: the
    reference's ``shard_map`` over "model" (in_specs tokens
    P(batch_axes, None), router P(None, None), experts P("model", None,
    None); out_specs P(batch_axes, None)) as a region of plain tensors
    between DTensor redistributes. The gradient placements say what each
    rank's local gradient is: over the batch axes a part of the sum of
    the params' gradients (its tokens); over "model" a part of the sum of
    the tokens' and the router's (its experts)."""
    names = mesh.mesh_dim_names
    batch = SH.batch_axes(mesh)
    n_routed = kw.pop("n_routed")
    em = SH.axis_size(mesh, "model")
    if n_routed % em:
        raise ValueError(f"{n_routed} experts do not split over a "
                         f"'model' axis of {em}")
    e_local = n_routed // em
    tok = (batch or None, None)
    experts = ("model", None, None)
    xl = SH.local_region(x2, tok, SH.placements(mesh, tok, ("model",)))
    router = SH.local_region(p["router"], (None, None),
                             SH.placements(mesh, (None, None), names))
    ws = [SH.local_region(p[k], experts, SH.placements(mesh, experts, batch))
          for k in ("we_gate", "we_up", "we_down")]
    me = mesh.get_local_rank("model")
    y = _dispatch_compute(xl, router, *ws, n_routed=n_routed,
                          e_start=me * e_local, e_local=e_local, **kw)
    y = SH.from_region(y, mesh, SH.placements(mesh, tok, ("model",)),
                       x2.shape)
    return y.redistribute(mesh, SH.placements(mesh, tok))   # the psum


def _replicated(p, x2, mesh, **kw):
    """The routed experts of ``x2`` on a mesh without "model": the whole
    batch on every rank (each computes the same, so every gradient is
    the whole one)."""
    rep = SH.placements(mesh, (None,) * 2)
    xl = x2.redistribute(mesh, rep).to_local()
    ws = [p[k].redistribute(mesh, rep).to_local()
          for k in ("router", "we_gate", "we_up", "we_down")]
    y = _dispatch_compute(xl, *ws, e_start=0, e_local=kw["n_routed"], **kw)
    return SH.from_region(y, mesh, rep, x2.shape)


def moe_apply(p, x, *, topk: int, n_routed: int, capacity: int,
              renormalize: bool = True, mesh=None):
    """x: (B, S, d) -> (B, S, d): the routed experts' output plus the
    shared experts'. ``mesh``: a ``DeviceMesh`` (``x`` and ``p`` are
    DTensors on it)."""
    B, S, d = x.shape
    x2 = grad_cast_bf16(x.reshape(B * S, d))
    kw = dict(topk=topk, capacity=capacity, n_routed=n_routed,
              renormalize=renormalize)
    if mesh is not None and SH.model_axis(mesh):
        y = _expert_parallel(p, x2, mesh, **kw)
    elif mesh is not None:
        y = _replicated(p, x2, mesh, **kw)
    else:
        y = _dispatch_compute(
            x2, p["router"], p["we_gate"], p["we_up"], p["we_down"],
            e_start=0, e_local=n_routed, **kw)
    y = grad_cast_bf16(y.reshape(B, S, d))
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, act="silu")
    return y
