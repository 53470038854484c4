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
over the layout's work list (``work``, :class:`~repro_torch.kernels.
layout.WorkList`) and counts the launch in :data:`launches`; on a CPU
tensor it runs :func:`segment_combine_plain`, the plain PyTorch version
of the same function. There is no fallback from one to the other, and no
kernel launch without a work list.

:func:`segment_combine_windows` (K2) is the same function over a stack of
per-shard layouts (the shard engine's ``segment_combine_windows`` calls),
in one launch of the same kernel, counted in :data:`windows_launches`,
with :func:`segment_combine_windows_plain` beside it. K1 launches it as a
stack of one shard.

A call made while its stream is being captured into a CUDA graph
launches nothing then: it is counted in the capturing thread's
:func:`recorded`, and the graph adds what it recorded to both counts at
each replay (:func:`add_launches`).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from . import _build, ref
from .layout import WorkList
from .ref import identity_for

__all__ = ["add_launches", "identity_for", "launches", "recorded",
           "segment_combine", "segment_combine_plain",
           "segment_combine_windows", "segment_combine_windows_plain",
           "windows_launches"]

# Kernel launches made by :func:`segment_combine` (CUDA tensors only).
launches = 0
# Kernel launches made by :func:`segment_combine_windows` (CUDA only).
windows_launches = 0
# Per thread: the K1 and K2 calls it recorded into CUDA graph captures.
_recorded = threading.local()
_count_lock = threading.Lock()

_COMBINER_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
# Dynamic shared memory a Hopper block may use.
_SMEM_MAX = 232448


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
                    tile_e: int, tile_r: int, num_segments: int,
                    work: WorkList | None = None) -> torch.Tensor:
    """Windowed combine of ``vals`` ((lanes,) or (B, lanes)) over the
    layout ``(window_id, tile_start, rel)``; returns ``vals.shape[:-1] +
    (num_segments,)``. ``work`` is the layout's work list, which the
    kernel path needs."""
    _check(window_id, tile_start, rel, vals, combiner, tile_e, tile_r,
           num_segments)
    if vals.device.type == "cpu":
        return segment_combine_plain(window_id, rel, vals, combiner=combiner,
                                     tile_e=tile_e, tile_r=tile_r,
                                     num_segments=num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment_combine for device {vals.device}")
    out = _launch("k1", work, rel.view(1, -1), vals.unsqueeze(-2), combiner,
                  tile_e, tile_r, num_segments)
    return out.squeeze(-2)


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
def _kernel():
    lib = _build.load("segment_combine")
    fn = lib.gravfm_segment_combine_windows
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32,
                   ctypes.c_longlong, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    smem = lib.gravfm_segment_combine_smem
    smem.argtypes = [i32, i32]
    smem.restype = ctypes.c_longlong
    return fn, smem


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
                            tile_e: int, tile_r: int, num_segments: int,
                            work: WorkList | None = None) -> torch.Tensor:
    """Windowed combine of ``vals`` ((S, lanes) or (B, S, lanes)) over S
    stacked layouts ``(tile_start (S, n_windows+1), rel (S, lanes))``;
    returns ``vals.shape[:-1] + (num_segments,)``. ``work`` is the
    stack's work list, which the kernel path needs."""
    _check_windows(tile_start, rel, vals, combiner, tile_e, tile_r,
                   num_segments)
    if vals.device.type == "cpu":
        return segment_combine_windows_plain(
            tile_start, rel, vals, combiner=combiner, tile_e=tile_e,
            tile_r=tile_r, num_segments=num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"no segment_combine_windows for device "
                         f"{vals.device}")
    return _launch("k2", work, rel, vals, combiner, tile_e, tile_r,
                   num_segments)


def recorded() -> Tuple[int, int]:
    """The K1 and K2 calls this thread has recorded into CUDA graph
    captures, in all."""
    return getattr(_recorded, "k1", 0), getattr(_recorded, "k2", 0)


def add_launches(k1: int, k2: int) -> None:
    """Count ``k1`` K1 and ``k2`` K2 launches made by a graph's replay."""
    global launches, windows_launches
    with _count_lock:
        launches += k1
        windows_launches += k2


def _count(kind: str) -> None:
    """Count one launch of ``kind`` ("k1" or "k2") on the current stream:
    in :data:`launches` / :data:`windows_launches`, or in this thread's
    :func:`recorded` while the stream is being captured."""
    if torch.cuda.is_current_stream_capturing():
        setattr(_recorded, kind, getattr(_recorded, kind, 0) + 1)
    else:
        add_launches(kind == "k1", kind == "k2")


def _launch(kind, work, rel, vals, combiner, tile_e, tile_r, num_segments):
    """Launch the kernel over ``rel`` (S, lanes) and ``vals`` (..., S,
    lanes), counted as ``kind`` (not for an empty batch or no segment).
    Returns the (..., S, num_segments) output."""
    if not isinstance(work, WorkList):
        raise ValueError("the CUDA combine needs the layout's work list "
                         "(DeviceLayout.work / layout.stacked_layout)")
    items = work.items
    if (items.dtype != torch.int32 or items.dim() != 2
            or items.shape[1] != 8 or not items.is_contiguous()
            or items.device != vals.device
            or work.arrivals.device != vals.device):
        raise ValueError("work.items must be a contiguous (n, 8) int32 "
                         "tensor on the values' device")
    n_shards, lanes = rel.shape
    batch = vals.numel() // (n_shards * lanes) if lanes else 0
    if tile_e % 4:
        raise ValueError(f"tile_e must be a multiple of 4, got {tile_e}")
    kernel, smem = _kernel()
    if smem(max(batch, 1), tile_r) > _SMEM_MAX:
        raise ValueError(f"tile_r={tile_r} needs more shared memory than "
                         "a block has")
    out = torch.empty(vals.shape[:-1] + (num_segments,), dtype=vals.dtype,
                      device=vals.device)
    if batch == 0 or num_segments == 0:
        return out
    if rel.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("rel and vals must be 16-byte aligned")
    scratch = torch.empty((work.n_slots, batch, tile_r), dtype=vals.dtype,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            items.data_ptr(), items.shape[0], work.arrivals.data_ptr(),
            scratch.data_ptr(), rel.data_ptr(), vals.data_ptr(),
            out.data_ptr(), n_shards, batch, lanes, num_segments, tile_e,
            tile_r, _COMBINER_CODE[combiner], _DTYPE_CODE[vals.dtype],
            stream)
        if err != 0:
            raise RuntimeError(f"segment_combine kernel launch failed: "
                               f"cudaError {err}")
        _count(kind)
    return out
