"""Gradient compression for the slowest link tier, in PyTorch (the port of
``repro.train.compress``).

The paper's central move is shrinking what crosses the slowest network by
exchanging the compact dual (updates) instead of the expanded stream
(messages). The data-parallel analogue: replicas exchange int8
block-scaled gradients instead of float32/bf16 ones, 4x/2x fewer wire
bytes.

``allreduce_int8(x, mesh, generator)`` runs over the port's mesh
(``core/mesh.py``), or over one axis of a ``DeviceMesh`` (``axis=``, the
reference's ``axis``, e.g. "pod": that axis's process group as a
``ProcessGroupMesh``): per-block absmax scales (float32, one per 256
values) and the int8 payload are all-gathered, dequantized and summed.
Stochastic rounding from an explicit ``torch.Generator`` keeps the
quantizer unbiased (E[q] = x), which is what makes SGD tolerate it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "allreduce_int8",
           "axis_mesh", "wire_bytes"]

BLOCK = 256


def _pad_to_block(x):
    n = x.numel()
    pad = (-n) % BLOCK
    flat = F.pad(x.reshape(-1), (0, pad))
    return flat.reshape(-1, BLOCK), n


def quantize_int8(x, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x: any-shape float32/bf16 -> (int8 blocks, float32 scales,
    orig_size). Stochastic rounding: unbiased. ``generator`` lies on
    ``x``'s device."""
    blocks, n = _pad_to_block(x.float())
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    y = blocks / scale
    noise = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                       device=y.device) - 0.5     # uniform in [-0.5, 0.5)
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale[:, 0], n


def dequantize_int8(q, scale, n, shape, dtype):
    x = (q.float() * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


def axis_mesh(mesh, axis: str):
    """The ranks along ``axis`` of a ``DeviceMesh`` that hold this rank's
    coordinates on the other axes, as a ``ProcessGroupMesh`` (one shard
    a rank)."""
    from ..core.mesh import ProcessGroupMesh
    return ProcessGroupMesh(group=mesh.get_group(axis),
                            device=mesh.device_type)


def allreduce_int8(x, mesh, generator: torch.Generator, axis=None):
    """Unbiased int8 all-reduce over ``mesh``'s shards, or with ``axis``
    over that axis of a ``DeviceMesh`` (``axis_mesh``). ``x``: (S, ...),
    the value of each shard this process holds (``mesh.shards``; S = 1
    on a ``ProcessGroupMesh``), each quantized on its own with draws from
    ``generator``. Returns (S, ...): every shard gets the sum over all P
    shards of the dequantized values, in ``x``'s dtype. Wire bytes per
    element: 1 (payload) + 4/BLOCK (scales) vs 4 for float32."""
    if axis is not None:
        mesh = axis_mesh(mesh, axis)
    qs, ss = [], []
    for shard in x:
        q, scale, n = quantize_int8(shard, generator)
        qs.append(q)
        ss.append(scale)
    # the mesh's collectives take a leading query axis: B = 1
    q_all = mesh.all_gather(torch.stack(qs)[None])[0]     # (P, nblk, BLOCK)
    s_all = mesh.all_gather(torch.stack(ss)[None])[0]     # (P, nblk)
    deq = q_all.float() * s_all[..., None]
    total = torch.sum(deq, dim=0).reshape(-1)[:n]
    total = total.reshape(x.shape[1:]).to(x.dtype)
    return total.expand(x.shape).clone()


def wire_bytes(num_elements: int, dtype_bytes: int = 4) -> dict:
    """Analytic wire cost per element."""
    blocks = -(-num_elements // BLOCK)
    return {
        "f32_psum": num_elements * dtype_bytes,
        "int8_allgather": num_elements + blocks * 4,
        "ratio": (num_elements * dtype_bytes)
                 / (num_elements + blocks * 4),
    }
