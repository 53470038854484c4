"""Fault-tolerant checkpointing, in PyTorch (the port of
``repro.train.checkpoint``), in the reference's on-disk format, so that
each package restores the other's checkpoints:

  * ``step_XXXXXXXX/`` holds one ``shard_{process:05d}.npz`` per process
    and a ``meta.json`` (step, process count, sorted keys, extras);
  * keys are the tree's paths joined with ``//``: dict keys, and
    ``.m``/``.v``/``.count`` for an ``AdamWState``'s fields (the
    reference's ``GetAttrKey``), e.g. ``opt//.m//embed``;
  * numpy has no bfloat16: such a leaf is stored as its uint16 bits under
    its key plus ``@@bfloat16``, decoded here without ``ml_dtypes`` (the
    reference's float8 tags name dtypes no model here holds: refused);
  * two-phase commit: write ``step_XXXXXXXX.tmp/``, fsync ``meta.json``,
    rename it to ``step_XXXXXXXX/``, then point ``LATEST`` at it, so a
    crash mid-write never corrupts the restore point;
  * ``Checkpointer.save_async`` copies the tree to the host synchronously
    and writes the files on a thread, at most one in flight, keeping the
    last ``keep`` checkpoints;
  * ``restore_latest`` walks back past incomplete directories.

The process index and count come from ``torch.distributed`` when it is
initialised, else 0 and 1. Restore places every leaf on the ``device``
asked for (the card unless the CPU is asked for) or, with ``shardings``
(a tree of ``sharding.NamedSharding`` matching the template; None
leaves stay plain), onto a mesh: a checkpoint restores onto any mesh or
none, whatever mesh wrote it.

A tree of DTensors (a sharded run) is saved whole: each leaf is gathered
(every process takes part, in the tree's order), and process ``i``
writes the leaves ``i, i + P, ...`` of the tree's order into its own
``shard_{i:05d}.npz``; the reference's restore and this one read every
process's file. Process 0 commits once every file is written
(barriers); on more than one process that save is synchronous, also
from ``save_async``, since its barriers must not run beside the next
step's collectives.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import sharding as SH
from ..core.engine import resolve_device
from .optimizer import AdamWState

__all__ = ["save", "restore", "restore_latest", "Checkpointer"]

_SEP = "//"
_DT = "@@"  # dtype tag for numpy-unrepresentable dtypes (bfloat16 etc.)
_BF16 = "bfloat16"  # the tag of a bf16 leaf, stored as its uint16 bits


def _process() -> Tuple[int, int]:
    """(this process's index, the process count)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _paths(tree, prefix=()):
    """(key, leaf) pairs in the reference's pytree order: dicts by sorted
    key, an ``AdamWState`` by field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, AdamWState):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + ("." + name,))
    else:
        yield _SEP.join(prefix), tree


def _encode(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A tensor or array as host numpy and its dtype tag (None where
    numpy holds the dtype)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: the step after a save_async updates the
        # params in place while the writer thread still reads this one
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.asarray(leaf), None


def _sharded(tree) -> bool:
    return any(SH.is_dtensor(leaf) for _, leaf in _paths(tree))


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], list]:
    """The host copy of ``tree`` this process writes (tagged key -> numpy
    array; of a sharded tree, the leaves it owns) and every tagged key of
    the tree."""
    flat, keys = {}, []
    proc, count = _process() if _sharded(tree) else (0, 1)
    for i, (key, leaf) in enumerate(_paths(tree)):
        if SH.is_dtensor(leaf):
            leaf = leaf.full_tensor()       # every process takes part
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        keys.append(key + (_DT + _BF16 if bf16 else ""))
        if i % count == proc:
            flat[keys[-1]] = _encode(leaf)[0]
    return flat, keys


def _decode(arr: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    if tag is None:
        return torch.from_numpy(np.array(arr))
    if tag != _BF16:
        raise ValueError(f"checkpoint leaf of unsupported dtype {tag!r}")
    bits = np.array(arr).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def _barrier(sharded: bool) -> None:
    if sharded and _process()[1] > 1:
        torch.distributed.barrier()


def _write(directory: str, step: int, flat: Dict[str, np.ndarray],
           extra: Optional[dict], keys=None, sharded: bool = False) -> str:
    """Write and commit one checkpoint. ``sharded``: every process writes
    its part of one tree (``keys`` all of them) and process 0 commits."""
    proc, count = _process()
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if proc == 0 or not sharded:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier(sharded)
    np.savez(os.path.join(tmp, f"shard_{proc:05d}.npz"), **flat)
    _barrier(sharded)
    if sharded and proc != 0:
        _barrier(sharded)
        return final
    meta = {"step": step, "num_processes": count,
            "keys": sorted(keys if sharded else flat), **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(os.path.join(directory, "LATEST.tmp"),
              os.path.join(directory, "LATEST"))
    _barrier(sharded)
    return final


def save(directory: str, step: int, tree, *, extra: Optional[dict] = None):
    """Write ``tree`` (tensors on any device, DTensors, or numpy arrays)
    as step ``step`` of ``directory``; returns the committed directory.
    A tree of DTensors is saved by every process together."""
    flat, keys = _flatten(tree)
    return _write(directory, step, flat, extra, keys, _sharded(tree))


def _unflatten_into(template, decoded: Dict[str, torch.Tensor], device,
                    shardings=None, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_into(
            template[k], decoded, device,
            None if shardings is None else shardings[k],
            prefix + (str(k),)) for k in template}
    if isinstance(template, AdamWState):
        return AdamWState(*(_unflatten_into(
            getattr(template, name), decoded, device,
            None if shardings is None else getattr(shardings, name),
            prefix + ("." + name,)) for name in template._fields))
    key = _SEP.join(prefix)
    if key not in decoded:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    t = decoded[key]
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape "
                         f"{tuple(t.shape)}, the template "
                         f"{tuple(template.shape)}")
    if shardings is not None:
        return shardings.place(t)
    return t.to(device)


def restore(path: str, template, *, device=None,
            shardings=None) -> Tuple[Any, dict]:
    """(the tree shaped as ``template``, its leaves read from the
    checkpoint at ``path`` onto ``device`` (the card unless "cpu" is
    asked for); the checkpoint's meta).
    ``template`` gives keys and shapes only (``meta`` tensors will do);
    each leaf keeps the dtype it was saved in. ``shardings``: a tree
    matching ``template`` of ``sharding.NamedSharding`` (or None) leaves;
    each leaf is re-cut onto its mesh (every process reads every file)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    decoded: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    base, _, tag = k.partition(_DT)
                    decoded[base] = _decode(z[k], tag or None)
    if device is None and shardings is not None:
        device = next(sh.mesh.device_type for _, sh in _paths(shardings)
                      if sh is not None)
    return _unflatten_into(template, decoded, resolve_device(device),
                           shardings), meta


def restore_latest(directory: str, template, *, device=None,
                   shardings=None):
    """Walk back past incomplete checkpoints. Returns (tree, meta) or
    (None, None) if nothing restorable."""
    if not os.path.isdir(directory):
        return None, None
    candidates = sorted(
        (d for d in os.listdir(directory)
         if d.startswith("step_") and not d.endswith(".tmp")),
        reverse=True)
    latest = os.path.join(directory, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            pointed = f.read().strip()
        if pointed in candidates:
            candidates.remove(pointed)
            candidates.insert(0, pointed)
    for name in candidates:
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, "meta.json")):
            continue  # incomplete — crashed mid-write
        try:
            return restore(path, template, device=device,
                           shardings=shardings)
        except (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile):
            continue  # unreadable or not this tree's: try an older one
    return None, None


class Checkpointer:
    """Async double-buffered checkpoint writer with retention."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree, *, extra: Optional[dict] = None):
        flat, keys = _flatten(tree)  # synchronous copy to the host
        sharded = _sharded(tree)
        self.wait()

        def work():
            _write(self.directory, step, flat, extra, keys, sharded)
            if _process()[0] == 0 or not sharded:
                self._gc()

        if sharded and _process()[1] > 1:
            work()          # barriers: not beside the next step's work
            return
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            (d for d in os.listdir(self.directory)
             if d.startswith("step_") and not d.endswith(".tmp")))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
