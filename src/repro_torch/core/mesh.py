"""The shard engine's mesh: where the shards live and the four collectives
the exchanges use (the port's counterpart of the JAX engine's one-axis
``shard_map`` mesh).

Per-shard arrays carry the query axis first and the process's own shards
second: ``(B, S, ...)``, with ``S`` the number of shards this process
holds. Two meshes:

  :class:`LocalMesh`        — all ``P`` shards on one device (``S = P``),
      as XLA's forced host device count puts P shards on one CPU. A
      collective is a reshuffle of the stacked array.
  :class:`ProcessGroupMesh` — one shard per process of a
      ``torch.distributed`` group (``S = 1``), over
      ``all_gather_into_tensor``, ``all_to_all_single`` and ``all_reduce``.

The collectives, with ``me`` a shard and ``q`` a peer:

  all_gather(x)  (B, S, ...)    -> (B, P, ...): every shard's block.
  all_to_all(x)  (B, S, P, ...) -> (B, S, P, ...): ``recv[:, me, q] =``
      peer q's ``send[:, q, me]`` (``jax.lax.all_to_all`` with
      ``split_axis=0, concat_axis=0, tiled=False``).
  ppermute(x)    (B, S, ...)    -> (B, S, ...): shard ``me`` receives
      shard ``me - 1``'s block (``jax.lax.ppermute`` with the ring
      ``[(i, (i + 1) % P)]``).
  pmax(x, dim) / psum(x, dim): max / sum over the local shard axis
      ``dim`` (none if ``dim`` is None) and then across the processes.

``all_to_all_async`` and ``ppermute_async`` start the same transfers and
return a handle whose ``wait()`` gives the result, so an overlapped
exchange issues window ``k + 1`` before it folds window ``k``. On a
``LocalMesh`` there is no wire: the handle is complete when returned.

``devices`` names the device of each shard the process holds (the
service's per-device superstep attribution).
"""
from __future__ import annotations

from typing import Optional

import torch

from .engine import resolve_device

__all__ = ["LocalMesh", "ProcessGroupMesh"]


class _Pending:
    """A started transfer: ``wait()`` finishes it and returns its result."""

    def __init__(self, works, finish):
        self._works = works
        self._finish = finish

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        return self._finish()


def _ready(x: torch.Tensor) -> _Pending:
    return _Pending((), lambda: x)


class LocalMesh:
    """``num_shards`` shards stacked on one device."""

    def __init__(self, num_shards: int, device=None):
        self.num_shards = int(num_shards)
        self.device = resolve_device(device)
        # the shards this process holds, as a slice of the shard axis
        self.shards = slice(0, self.num_shards)
        self.devices = (str(self.device),) * self.num_shards

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).contiguous()

    def all_to_all_async(self, x: torch.Tensor) -> _Pending:
        return _ready(self.all_to_all(x))

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        return torch.roll(x, 1, dims=1)

    def ppermute_async(self, x: torch.Tensor) -> _Pending:
        return _ready(self.ppermute(x))

    def pmax(self, x: torch.Tensor, dim: Optional[int] = None):
        return x if dim is None else x.amax(dim)

    def psum(self, x: torch.Tensor, dim: Optional[int] = None):
        return x if dim is None else x.sum(dim)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8: neither gloo nor NCCL reduces or moves bool."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


class ProcessGroupMesh:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group unless ``group`` is given), which the caller initialises
    first. ``device`` is where this rank's shard lives: the card unless
    the caller asks for the CPU (gloo)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialised "
                               "process group (init_process_group)")
        self._dist = dist
        self.group = group
        self.num_shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        self.shards = slice(self.rank, self.rank + 1)
        self.devices = (str(self.device),)

    def _peer(self, rank: int) -> int:
        """A rank of the group as the global rank point-to-point ops name."""
        if self.group is None:
            return rank
        return self._dist.get_global_rank(self.group, rank)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        send = _wire(x.movedim(1, 0))                       # (1, B, ...)
        out = send.new_empty((self.num_shards,) + send.shape[1:])
        self._dist.all_gather_into_tensor(out, send, group=self.group)
        return out.to(x.dtype).movedim(0, 1)

    def all_to_all_async(self, x: torch.Tensor) -> _Pending:
        send = _wire(x.select(1, 0).movedim(1, 0))          # (P, B, ...)
        out = torch.empty_like(send)
        work = self._dist.all_to_all_single(out, send, group=self.group,
                                            async_op=True)
        return _Pending((work,), lambda: out.to(x.dtype).movedim(
            0, 1).unsqueeze(1))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_to_all_async(x).wait()

    def ppermute_async(self, x: torch.Tensor) -> _Pending:
        send = _wire(x)
        out = torch.empty_like(send)
        dist, P = self._dist, self.num_shards
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._peer((self.rank + 1) % P),
                       self.group),
            dist.P2POp(dist.irecv, out, self._peer((self.rank - 1) % P),
                       self.group)])
        return _Pending(works, lambda: out.to(x.dtype))

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        return self.ppermute_async(x).wait()

    def _all_reduce(self, x, dim, op):
        local = x if dim is None else (
            x.amax(dim) if op == "max" else x.sum(dim))
        out = _wire(local).clone()
        ops = self._dist.ReduceOp
        self._dist.all_reduce(out, op=ops.MAX if op == "max" else ops.SUM,
                              group=self.group)
        return out.to(local.dtype)

    def pmax(self, x: torch.Tensor, dim: Optional[int] = None):
        return self._all_reduce(x, dim, "max")

    def psum(self, x: torch.Tensor, dim: Optional[int] = None):
        return self._all_reduce(x, dim, "sum")
