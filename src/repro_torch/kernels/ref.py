"""Plain-torch oracles for the kernel layer (twins of ``repro.kernels.ref``).

``segment_combine``: per-destination aggregation of on-demand messages
(paper §4.1/§4.2) as one ``scatter_reduce_`` onto an identity-filled
``(..., S+1)`` tensor whose last bin takes the padding lanes and is
sliced off. Values may carry a leading query axis ``(B, E)``; segment ids
are ``(E,)`` and shared by every query.
"""
from __future__ import annotations

import torch

__all__ = ["REDUCE", "identity_for", "segment_combine",
           "segment_combine_carry"]

# ``scatter_reduce_`` names of the combiners.
REDUCE = {"add": "sum", "min": "amin", "max": "amax"}


def identity_for(combiner: str, dtype):
    """Combiner identity as a Python scalar of ``dtype``'s kind."""
    floating = dtype.is_floating_point
    if combiner == "add":
        return 0.0 if floating else 0
    if combiner == "min":
        return float("inf") if floating else torch.iinfo(dtype).max
    if combiner == "max":
        return float("-inf") if floating else torch.iinfo(dtype).min
    raise ValueError(f"unknown combiner: {combiner}")


def segment_combine(vals: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, combiner: str) -> torch.Tensor:
    """Aggregate ``vals`` by ``seg_ids`` with a monoid. ``seg_ids`` may
    contain values >= num_segments for padding lanes (discarded)."""
    if combiner not in REDUCE:
        raise ValueError(f"unknown combiner: {combiner}")
    index = seg_ids.to(torch.int64).clamp(max=num_segments)
    index = index.expand(vals.shape)
    out = torch.full(vals.shape[:-1] + (num_segments + 1,),
                     identity_for(combiner, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(-1, index, vals, REDUCE[combiner], include_self=True)
    return out[..., :num_segments]


def segment_combine_carry(key_vals: torch.Tensor, carry_vals: torch.Tensor,
                          seg_ids: torch.Tensor, num_segments: int,
                          combiner: str, carry_identity) -> tuple:
    """min/max-combine on ``key_vals`` with an argmin-style carried value:
    among lanes achieving the winning key, the min carry wins."""
    if combiner not in ("min", "max"):
        raise ValueError(f"carry combine needs min or max, got {combiner}")
    acc = segment_combine(key_vals, seg_ids, num_segments, combiner)
    index = seg_ids.to(torch.int64).clamp(max=max(num_segments - 1, 0))
    at_edge = acc.index_select(-1, index) if num_segments else key_vals
    winner = (key_vals == at_edge) & (seg_ids < num_segments)
    masked_carry = torch.where(winner, carry_vals, carry_identity)
    carry = segment_combine(masked_carry, seg_ids, num_segments, "min")
    return acc, carry
