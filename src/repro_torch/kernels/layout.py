"""Static edge-tile layout for the segment-combine kernel.

The port's own copy of ``repro.kernels.layout`` (same arrays for the same
inputs), plus ``tile_start``: the per-window tile range the CUDA grid
walks (block ``w`` owns tiles ``[tile_start[w], tile_start[w+1])``).

Built once per partitioned graph (host-side numpy), like the paper's
load-time edge-list preparation. Guarantees:
  * edges sorted by destination segment,
  * rows grouped into windows of ``tile_r`` consecutive segments,
  * per-window edge runs padded to a multiple of ``tile_e`` so no tile
    straddles a window boundary,
  * empty windows own zero tiles (the kernel stores the identity there).

:func:`stack_layouts` stacks per-shard layouts of one segment count onto
a leading shard axis (the shard engine's layout); :class:`StackedLayout`
is what the stacked combine reads on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = ["EdgeLayout", "DeviceLayout", "StackedLayout", "build_layout",
           "stack_layouts"]


class DeviceLayout(NamedTuple):
    """The layout arrays a combine call reads, as int32 tensors on one
    device, with the static sizes beside them."""
    window_id: torch.Tensor   # (n_tiles,) int32, non-decreasing
    tile_start: torch.Tensor  # (n_windows+1,) int32
    rel: torch.Tensor         # (n_tiles*tile_e,) int32; pads hold tile_r
    tile_e: int
    tile_r: int
    num_segments: int


class StackedLayout(NamedTuple):
    """Per-shard layouts on a leading shard axis, as int32 tensors on one
    device: shard ``s``'s window ``w`` owns the tiles ``[tile_start[s, w],
    tile_start[s, w+1])`` of its lane row ``rel[s]``."""
    tile_start: torch.Tensor  # (S, n_windows+1) int32
    rel: torch.Tensor         # (S, n_tiles*tile_e) int32; pads hold tile_r
    tile_e: int
    tile_r: int
    num_segments: int


@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    num_segments: int
    tile_e: int
    tile_r: int
    n_tiles: int
    n_windows: int
    window_id: np.ndarray        # (n_tiles,) int32, non-decreasing
    rel: np.ndarray              # (n_tiles*tile_e,) int32; pads hold tile_r
    lane_of_edge: np.ndarray     # (E,) int32: padded lane of original edge i
    lane_valid: np.ndarray       # (n_tiles*tile_e,) bool
    window_written: np.ndarray   # (n_windows,) bool
    tile_start: np.ndarray       # (n_windows+1,) int32: first tile per window

    @property
    def num_lanes(self) -> int:
        return self.n_tiles * self.tile_e

    def place(self, arr: np.ndarray, fill) -> np.ndarray:
        """Scatter a per-edge array into padded kernel lanes."""
        out = np.full((self.num_lanes,) + arr.shape[1:], fill, arr.dtype)
        out[self.lane_of_edge] = arr
        return out

    def to(self, device) -> DeviceLayout:
        def t(a):
            return torch.as_tensor(a, dtype=torch.int32, device=device)
        return DeviceLayout(t(self.window_id), t(self.tile_start),
                            t(self.rel), self.tile_e, self.tile_r,
                            self.num_segments)


def build_layout(seg_ids: np.ndarray, num_segments: int, *,
                 tile_e: int = 512, tile_r: int = 256) -> EdgeLayout:
    """``seg_ids``: (E,) sorted ascending, values in [0, num_segments]
    (``num_segments`` itself = discard bin for pre-padded lanes)."""
    seg_ids = np.asarray(seg_ids, np.int64)
    if seg_ids.ndim != 1:
        raise ValueError("seg_ids must be 1-D")
    if seg_ids.size:
        if not (np.diff(seg_ids) >= 0).all():
            raise ValueError("seg_ids must be sorted")
        if seg_ids.max() > num_segments:
            raise ValueError("seg_ids exceed num_segments")
    total_segs = num_segments + 1
    n_windows = -(-total_segs // tile_r)

    window = seg_ids // tile_r
    counts = np.bincount(window, minlength=n_windows).astype(np.int64)
    padded = -(-counts // tile_e) * tile_e  # 0 stays 0
    tiles_per_window = padded // tile_e
    n_tiles = int(tiles_per_window.sum())
    if n_tiles == 0:  # degenerate empty graph: one dummy tile
        n_tiles = 1
        tiles_per_window = tiles_per_window.copy()
        tiles_per_window[0] = 1
        padded = padded.copy()
        padded[0] = tile_e

    src_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    dst_start = np.concatenate([[0], np.cumsum(padded)])[:-1]

    E = seg_ids.shape[0]
    idx = np.arange(E, dtype=np.int64)
    lane = dst_start[window] + (idx - src_start[window])
    L = n_tiles * tile_e

    rel = np.full(L, tile_r, np.int32)
    rel[lane] = (seg_ids - window * tile_r).astype(np.int32)
    lane_valid = np.zeros(L, bool)
    lane_valid[lane] = True

    window_id = np.repeat(
        np.arange(n_windows, dtype=np.int32), tiles_per_window)
    window_written = counts > 0
    if window_written.sum() == 0:
        window_written = window_written.copy()
        window_written[0] = True
    tile_start = np.concatenate(
        [[0], np.cumsum(tiles_per_window)]).astype(np.int32)

    return EdgeLayout(
        num_segments=num_segments, tile_e=tile_e, tile_r=tile_r,
        n_tiles=n_tiles, n_windows=int(n_windows),
        window_id=window_id.astype(np.int32), rel=rel,
        lane_of_edge=lane.astype(np.int32), lane_valid=lane_valid,
        window_written=window_written, tile_start=tile_start)


def stack_layouts(layouts: Sequence[EdgeLayout]
                  ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Stack per-shard layouts of one segment count and tile shape onto a
    leading shard axis, padded to the longest one's tile count. Returns
    ``(arrays, n_tiles, n_windows)``, ``arrays`` holding ``window_id``
    ``(S, n_tiles)``, ``rel`` ``(S, L)``, ``window_written``
    ``(S, n_windows)`` and ``tile_start`` ``(S, n_windows+1)``.

    ``window_id``, ``rel`` and ``window_written`` are the JAX shard
    engine's arrays: a shard's pad tiles point at its last window and hold
    ``rel == tile_r``. ``tile_start`` stops at each shard's own tile
    count, so the CUDA grid never reads a pad tile. The stacked combine
    leaves the identity in every window that owns no tile, which stands in
    for the JAX kernel's ``window_written`` epilogue only if no unwritten
    window owns a tile: checked here."""
    first = layouts[0]
    shape = (first.num_segments, first.tile_e, first.tile_r)
    n_tiles = max(lo.n_tiles for lo in layouts)
    n_windows = first.n_windows
    S, L = len(layouts), n_tiles * first.tile_e
    wid = np.zeros((S, n_tiles), np.int32)
    rel = np.full((S, L), first.tile_r, np.int32)
    written = np.zeros((S, n_windows), bool)
    tile_start = np.zeros((S, n_windows + 1), np.int32)
    for s, lo in enumerate(layouts):
        if (lo.num_segments, lo.tile_e, lo.tile_r) != shape:
            raise ValueError("stacked layouts need one segment count and "
                             "tile shape")
        if (np.diff(lo.tile_start)[~lo.window_written] != 0).any():
            raise ValueError(f"shard {s}: a window marked unwritten owns "
                             "tiles")
        wid[s, :lo.n_tiles] = lo.window_id
        wid[s, lo.n_tiles:] = lo.window_id[-1]
        rel[s, :lo.num_lanes] = lo.rel
        written[s] = lo.window_written
        tile_start[s] = lo.tile_start
    return (dict(window_id=wid, rel=rel, window_written=written,
                 tile_start=tile_start), n_tiles, n_windows)
