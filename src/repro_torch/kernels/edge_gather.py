"""Windowed semiring segment-combine: the port of the Pallas edge-traversal
kernel (``repro/kernels/edge_gather.py:segment_combine_pallas``, with the
epilogue of ``segment_combine_windows``).

Edges arrive sorted by destination segment in a static
:class:`~repro_torch.kernels.layout.EdgeLayout`: lanes cut into tiles of
``tile_e``, rows grouped into windows of ``tile_r``, no tile straddling a
window. For every query ``b``, ``out[b, w*tile_r + r]`` folds (add, min or
max) the values of window ``w``'s lanes whose ``rel == r``; windows that
own no tile hold the identity, and the result is cut to ``num_segments``.

:func:`segment_combine` (K1) is the wrapper the engine calls. On a CUDA
tensor it launches the hand-written Hopper kernel
(``csrc/segment_combine.cu``; its note gives the design and the bound)
and counts the launch in :data:`launches`; on a CPU tensor it runs
:func:`segment_combine_plain`, the plain PyTorch version of the same
function. There is no fallback from one to the other.

:func:`segment_combine_windows` (K2) is the same function over a stack of
per-shard layouts (the shard engine's ``segment_combine_windows`` calls),
in one launch: the second entry of the same CUDA source, counted in
:data:`windows_launches`, with :func:`segment_combine_windows_plain`
beside it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .ref import identity_for

__all__ = ["identity_for", "launches", "segment_combine",
           "segment_combine_plain", "segment_combine_windows",
           "segment_combine_windows_plain", "windows_launches"]

# Kernel launches made by :func:`segment_combine` (CUDA tensors only).
launches = 0
# Kernel launches made by :func:`segment_combine_windows` (CUDA only).
windows_launches = 0

_COMBINER_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}


def segment_combine_plain(window_id: torch.Tensor, rel: torch.Tensor,
                          vals: torch.Tensor, *, combiner: str, tile_e: int,
                          tile_r: int, num_segments: int) -> torch.Tensor:
    """The windowed combine in plain PyTorch: each lane's row is
    ``window_id[tile]*tile_r + rel``, folded by the ``scatter_reduce_``
    oracle; padding lanes (``rel == tile_r``) and rows past
    ``num_segments`` go to its discard bin."""
    row = window_id.to(torch.int64).repeat_interleave(tile_e) * tile_r + rel
    row = torch.where(rel < tile_r, row, num_segments)
    return ref.segment_combine(vals, row, num_segments, combiner)


@functools.cache
def _kernel():
    fn = _build.load("segment_combine").gravfm_segment_combine
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(window_id, tile_start, rel, vals, combiner, tile_e, tile_r,
           num_segments) -> None:
    if combiner not in _COMBINER_CODE:
        raise ValueError(f"unknown combiner: {combiner}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals must be float32 or int32, got {vals.dtype}")
    for name, t in (("window_id", window_id), ("tile_start", tile_start),
                    ("rel", rel)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    if vals.dim() not in (1, 2) or not vals.is_contiguous():
        raise ValueError("vals must be contiguous, (lanes,) or (B, lanes)")
    lanes = window_id.numel() * tile_e
    if rel.numel() != lanes or vals.shape[-1] != lanes:
        raise ValueError(
            f"layout has {lanes} lanes, rel {rel.numel()}, vals "
            f"{vals.shape[-1]}")
    n_windows = -(-(num_segments + 1) // tile_r)
    if tile_start.numel() != n_windows + 1:
        raise ValueError(f"tile_start must have {n_windows + 1} entries")


def segment_combine(window_id: torch.Tensor, tile_start: torch.Tensor,
                    rel: torch.Tensor, vals: torch.Tensor, *, combiner: str,
                    tile_e: int, tile_r: int,
                    num_segments: int) -> torch.Tensor:
    """Windowed combine of ``vals`` ((lanes,) or (B, lanes)) over the
    layout ``(window_id, tile_start, rel)``; returns ``vals.shape[:-1] +
    (num_segments,)``."""
    _check(window_id, tile_start, rel, vals, combiner, tile_e, tile_r,
           num_segments)
    if vals.device.type == "cpu":
        return segment_combine_plain(window_id, rel, vals, combiner=combiner,
                                     tile_e=tile_e, tile_r=tile_r,
                                     num_segments=num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment_combine for device {vals.device}")
    return _launch(tile_start, rel, vals, combiner, tile_e, tile_r,
                   num_segments)


def _launch(tile_start, rel, vals, combiner, tile_e, tile_r, num_segments):
    global launches
    lanes = rel.numel()
    batch = vals.numel() // lanes if lanes else 0
    if tile_e % 4:
        raise ValueError(f"tile_e must be a multiple of 4, got {tile_e}")
    if tile_r * 4 > 48 * 1024:
        raise ValueError(f"tile_r={tile_r} needs more than 48 KB of "
                         "shared memory")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535")
    out = torch.empty(vals.shape[:-1] + (num_segments,), dtype=vals.dtype,
                      device=vals.device)
    if batch == 0 or num_segments == 0:
        return out
    if rel.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("rel and vals must be 16-byte aligned")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(tile_start.data_ptr(), rel.data_ptr(),
                        vals.data_ptr(), out.data_ptr(),
                        tile_start.numel() - 1, batch, lanes, num_segments,
                        tile_e, tile_r, _COMBINER_CODE[combiner],
                        _DTYPE_CODE[vals.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment_combine kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def segment_combine_windows_plain(tile_start: torch.Tensor, rel: torch.Tensor,
                                  vals: torch.Tensor, *, combiner: str,
                                  tile_e: int, tile_r: int,
                                  num_segments: int) -> torch.Tensor:
    """K2 in plain PyTorch: shard ``s``'s tile ``t`` lies in the window
    ``w`` with ``tile_start[s, w] <= t < tile_start[s, w+1]``, so each
    lane's row is ``w*tile_r + rel``, folded per shard by the
    ``scatter_reduce_`` oracle. Padding lanes, tiles past the shard's
    ``tile_start[s, -1]`` and rows past ``num_segments`` go to its
    discard bin."""
    n_shards, lanes = rel.shape
    n_windows = tile_start.shape[1] - 1
    tile = torch.arange(lanes // tile_e, dtype=torch.int32,
                        device=rel.device).expand(n_shards, -1).contiguous()
    window = torch.searchsorted(tile_start[:, 1:].contiguous(), tile,
                                right=True).repeat_interleave(tile_e, dim=1)
    row = window * tile_r + rel
    row = torch.where((rel < tile_r) & (window < n_windows), row,
                      num_segments)
    return ref.segment_combine(vals, row, num_segments, combiner)


@functools.cache
def _windows_kernel():
    fn = _build.load("segment_combine").gravfm_segment_combine_windows
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ctypes.c_longlong,
                   i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_windows(tile_start, rel, vals, combiner, tile_e, tile_r,
                   num_segments) -> None:
    if combiner not in _COMBINER_CODE:
        raise ValueError(f"unknown combiner: {combiner}")
    if vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"vals must be float32 or int32, got {vals.dtype}")
    for name, t in (("tile_start", tile_start), ("rel", rel)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 2-D int32 tensor")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
    if vals.dim() not in (2, 3) or not vals.is_contiguous():
        raise ValueError("vals must be contiguous, (shards, lanes) or "
                         "(B, shards, lanes)")
    if vals.shape[-2:] != rel.shape or tile_start.shape[0] != rel.shape[0]:
        raise ValueError(f"rel {tuple(rel.shape)}, tile_start "
                         f"{tuple(tile_start.shape)} and vals "
                         f"{tuple(vals.shape)} disagree")
    if rel.shape[1] % tile_e:
        raise ValueError(f"{rel.shape[1]} lanes is not a whole number of "
                         f"{tile_e}-lane tiles")
    n_windows = -(-(num_segments + 1) // tile_r)
    if tile_start.shape[1] != n_windows + 1:
        raise ValueError(f"tile_start must have {n_windows + 1} columns")


def segment_combine_windows(tile_start: torch.Tensor, rel: torch.Tensor,
                            vals: torch.Tensor, *, combiner: str,
                            tile_e: int, tile_r: int,
                            num_segments: int) -> torch.Tensor:
    """Windowed combine of ``vals`` ((S, lanes) or (B, S, lanes)) over S
    stacked layouts ``(tile_start (S, n_windows+1), rel (S, lanes))``;
    returns ``vals.shape[:-1] + (num_segments,)``."""
    _check_windows(tile_start, rel, vals, combiner, tile_e, tile_r,
                   num_segments)
    if vals.device.type == "cpu":
        return segment_combine_windows_plain(
            tile_start, rel, vals, combiner=combiner, tile_e=tile_e,
            tile_r=tile_r, num_segments=num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment_combine_windows for device "
                         f"{vals.device}")
    return _launch_windows(tile_start, rel, vals, combiner, tile_e, tile_r,
                           num_segments)


def _launch_windows(tile_start, rel, vals, combiner, tile_e, tile_r,
                    num_segments):
    global windows_launches
    n_shards, lanes = rel.shape
    rows = vals.numel() // lanes if lanes else 0
    if tile_e % 4:
        raise ValueError(f"tile_e must be a multiple of 4, got {tile_e}")
    if tile_r * 4 > 48 * 1024:
        raise ValueError(f"tile_r={tile_r} needs more than 48 KB of "
                         "shared memory")
    if rows > 65535:
        raise ValueError(f"batch x shards = {rows} exceeds the grid's 65535")
    out = torch.empty(vals.shape[:-1] + (num_segments,), dtype=vals.dtype,
                      device=vals.device)
    if rows == 0 or num_segments == 0:
        return out
    if rel.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("rel and vals must be 16-byte aligned")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _windows_kernel()(
            tile_start.data_ptr(), rel.data_ptr(), vals.data_ptr(),
            out.data_ptr(), tile_start.shape[1] - 1, n_shards,
            rows // n_shards, lanes, num_segments, tile_e, tile_r,
            _COMBINER_CODE[combiner], _DTYPE_CODE[vals.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment_combine_windows kernel launch failed: "
                           f"cudaError {err}")
    windows_launches += 1
    return out
