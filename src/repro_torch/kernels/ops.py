"""Dispatch wrappers for the kernel layer (twin of ``repro.kernels.ops``).

``segment_combine_layout``: the kernel path over a static layout (the
CUDA kernel on a CUDA tensor, its plain version on a CPU one).
``segment_combine_stacked``: the same over a stack of per-shard layouts
(the shard engine's combines; K2).
``segment_combine``: the kernel path when a layout is given, the
``scatter_reduce_`` oracle otherwise.
"""
from __future__ import annotations

import torch

from . import edge_gather, ref
from .layout import (DeviceLayout, EdgeLayout, StackedLayout, build_layout,
                     stacked_layout)
from .ref import identity_for

__all__ = ["segment_combine", "segment_combine_layout",
           "segment_combine_stacked", "build_layout", "stacked_layout",
           "EdgeLayout", "DeviceLayout", "StackedLayout", "identity_for"]


def segment_combine_layout(vals_padded: torch.Tensor, layout: DeviceLayout,
                           combiner: str) -> torch.Tensor:
    """Kernel path. ``vals_padded`` is (num_lanes,) or (B, num_lanes) with
    the identity in padding lanes. Returns (..., num_segments)."""
    return edge_gather.segment_combine(
        layout.window_id, layout.tile_start, layout.rel, vals_padded,
        combiner=combiner, tile_e=layout.tile_e, tile_r=layout.tile_r,
        num_segments=layout.num_segments, work=layout.work)


def segment_combine_stacked(vals: torch.Tensor, layout: StackedLayout,
                            combiner: str) -> torch.Tensor:
    """Kernel path over stacked per-shard layouts. ``vals`` is
    (S, num_lanes) or (B, S, num_lanes); lanes with ``rel == tile_r`` are
    ignored. Returns (..., S, num_segments)."""
    return edge_gather.segment_combine_windows(
        layout.tile_start, layout.rel, vals, combiner=combiner,
        tile_e=layout.tile_e, tile_r=layout.tile_r,
        num_segments=layout.num_segments, work=layout.work)


def segment_combine(vals: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, combiner: str,
                    layout: EdgeLayout | None = None) -> torch.Tensor:
    """Aggregate per-destination messages. With a layout, ``vals`` is in
    lane order ((num_lanes,) or (B, num_lanes)), padding lanes are masked
    to the identity and the kernel path runs; without, the oracle."""
    if layout is None:
        return ref.segment_combine(vals, seg_ids, num_segments, combiner)
    lane_valid = torch.as_tensor(layout.lane_valid, device=vals.device)
    padded = torch.where(lane_valid, vals, identity_for(combiner, vals.dtype))
    return segment_combine_layout(padded, layout.to(vals.device), combiner)
