"""AdamW with a warmup-cosine schedule and global-norm clipping, in PyTorch
(the port of ``repro.train.optimizer``).

The moments are float32 whatever the params' dtype; the update is
computed in float32 and cast back. Every number the reference computes
in float32 is a float32 tensor here too: the learning rate, the bias
corrections ``1 - b**count`` and the update, in the reference's order of
operations (no Python float64 in between).

One card, no donation: ``adamw_update`` writes the params and both
moments in place, leaf by leaf and chunk by chunk under ``no_grad`` (the
counterpart of the reference's ``donate_argnums``), so a step holds a few
float32 temporaries of one chunk at a time, never a second copy of the
params or the state.

On a mesh (params as DTensors) the moments take their parameter's
placements, so each rank holds only its shard's ``m`` and ``v`` (the
reference's "ZeRO-3-equivalent"); the chunked update runs on each
rank's local shards, and the global norm sums each leaf's local squares
over the mesh axes that shard it, leaf after leaf in the tree's order
(on a mesh of one rank, the plain path's numbers bit for bit).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import sharding as SH
from ..models.layers import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "warmup_cosine"]

# Elements of one leaf updated together: bounds the float32 temporaries
# of a step at a few times 64 MiB (qwen3-4b's stacked MLP leaves hold
# 896 M elements each).
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min: float = 3e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def warmup_cosine(cfg: AdamWConfig, step, device=None):
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 0-d tensor on ``device`` (the step's own device by default)."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = cfg.lr_peak * step / max(1, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(
        math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    """float32 zero moments shaped as ``params``, a 0-d int32 count, all
    on the params' device."""
    def zeros(p):
        if SH.is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def _chunks(t: torch.Tensor):
    """Views of consecutive pieces of a contiguous tensor's elements (every
    gradient, moment and param here is contiguous); of a DTensor's local
    shard."""
    if SH.is_dtensor(t):
        t = t.to_local()
    return t.view(-1).split(CHUNK)


def _square_sum(g) -> torch.Tensor:
    """The float32 sum of squares of ``g``'s elements: of a DTensor's
    whole value, its local sum summed over the mesh axes that shard it."""
    sq = sum(torch.sum(torch.square(c.float())) for c in _chunks(g))
    if not SH.is_dtensor(g):
        return sq
    mesh = g.device_mesh
    sharded = [n for n, p in zip(mesh.mesh_dim_names, g.placements)
               if p.is_shard()]
    return SH.from_region(sq, mesh, SH.placements(mesh, (), sharded),
                          ()).full_tensor()


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / norm)``, in float32 and
    cast back to its dtype, in place. Returns (grads, the float32 global
    norm before clipping)."""
    flat = leaves(grads)
    with torch.no_grad():
        sq = sum(_square_sum(g) for g in flat)
        norm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        for g in flat:
            for c in _chunks(g):
                c.copy_(c.float() * scale)
    return grads, norm


def _update(g, m, v, p, *, lr, b1c, b2c, wd: float, cfg: AdamWConfig):
    """One chunk of the AdamW step, in place on ``m``, ``v`` and ``p``."""
    gf = g.float()
    m.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    t = gf * (1 - cfg.b2)
    v.mul_(cfg.b2).add_(t.mul_(gf))
    step_ = m / b1c
    step_.div_((v / b2c).sqrt_().add_(cfg.eps))
    pf = p.float()
    if wd:
        # decoupled weight decay on matrices only (ndim >= 2)
        step_.add_(wd * pf)
    p.copy_(pf - lr * step_)


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig, step):
    """One AdamW step at ``step``: writes ``params`` and the moments in
    place and returns (params, the new state)."""
    device = state.count.device
    lr = warmup_cosine(cfg, step, device)
    c = state.count + 1
    cf = c.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf
    with torch.no_grad():
        for g, m, v, p in zip(leaves(grads), leaves(state.m),
                              leaves(state.v), leaves(params)):
            wd = cfg.weight_decay if p.ndim >= 2 else 0.0
            for gc, mc, vc, pc in zip(_chunks(g), _chunks(m),
                                      _chunks(v), _chunks(p)):
                _update(gc, mc, vc, pc, lr=lr, b1c=b1c, b2c=b2c, wd=wd,
                        cfg=cfg)
    return params, AdamWState(m=state.m, v=state.v, count=c)
