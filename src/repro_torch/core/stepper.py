"""Step-granular superstep core (twin of ``repro.core.stepper``'s
:class:`SuperstepProgram`).

One superstep = deliver (broadcast + receiver-side scatter +
gather-combine) -> gather -> stats -> next apply, over an explicit
:class:`StepCarry` whose every leaf leads with the query axis ``B``.
JAX runs the loop as one ``lax.while_loop`` (vmapped for a batch); here
:meth:`SuperstepProgram.run_loop` drives it from the host with one read
of the termination bits per superstep, and freezes finished queries with
:func:`select_lanes` — the explicit form of the freeze ``vmap`` of a
``while_loop`` performs — so a batched query is bit-identical to a solo
run of it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

__all__ = ["StepCarry", "SuperstepProgram", "select_lanes"]


class StepCarry(NamedTuple):
    """Everything the in-flight queries own between supersteps."""
    state: Dict[str, torch.Tensor]  # leaves (B, P, Vm) or (B,)
    payload: torch.Tensor           # (B, P, Vm) pending update values
    active: torch.Tensor            # (B, P, Vm) pending update mask
    superstep: torch.Tensor         # (B,) int32 supersteps completed
    stats: Dict[str, torch.Tensor]  # (B,) running counters


def _map(fn, *carries):
    """Apply ``fn`` leaf-wise over StepCarry/dict/tensor structures."""
    first = carries[0]
    if isinstance(first, StepCarry):
        return StepCarry(*(_map(fn, *parts) for parts in zip(*carries)))
    if isinstance(first, dict):
        return {k: _map(fn, *(c[k] for c in carries)) for k in first}
    return fn(*carries)


def select_lanes(mask: torch.Tensor, new, old):
    """Per-query carry select: queries where ``mask`` ((B,) bool) is True
    take ``new``, the rest keep ``old``."""
    def sel(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)
    return _map(sel, new, old)


def _over_queries(x: torch.Tensor, batch: int, vshape) -> torch.Tensor:
    """Broadcast a leaf over the query axis: per-vertex leaves (trailing
    ``vshape``) to (B, *vshape), per-query scalars to (B,)."""
    if x.dim() >= 2:
        return x.expand((batch,) + tuple(vshape))
    return x.expand(batch)


class SuperstepProgram:
    """init/step/alive for one (kernel, graph layout, deliver) triple.

    ``deliver(data, payload, active)`` returns ``(acc, got, carry_vals,
    aux)`` where ``aux`` is a dict of per-superstep counts folded into
    the running stats by ``update_stats(stats, data, active, aux)``.
    ``data`` needs ``vert_gid``, ``out_deg`` and ``vert_valid``, (P, Vm)
    (or the process's own shards of them). ``global_any`` reduces the
    (B,) live bits of this process's shards across the mesh (the
    identity for the one-device engine, ``pmax`` for the shard engine).
    """

    def __init__(self, kernel, deliver: Callable[..., Any], *,
                 init_stats: Callable[[int], Dict[str, torch.Tensor]],
                 update_stats: Callable[..., Dict[str, torch.Tensor]],
                 global_any: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None):
        self.kernel = kernel
        self.deliver = deliver
        self.init_stats = init_stats
        self.update_stats = update_stats
        self.global_any = global_any or (lambda b: b)

    def _applied(self, data, state, superstep):
        batch = superstep.shape[0]
        vshape = data.vert_gid.shape
        state, payload, active = self.kernel.apply(
            state, data.vert_gid, data.out_deg, superstep)
        active = _over_queries(active, batch, vshape) & data.vert_valid
        return state, _over_queries(payload, batch, vshape), active

    def init_carry(self, data, params: Dict[str, Any],
                   query_kwargs: Dict[str, Any], batch: int) -> StepCarry:
        """Kernel ``init_state`` + the superstep-0 ``apply`` (paper §4.3:
        "the barrier is injected into the apply modules")."""
        vshape = data.vert_gid.shape
        state = self.kernel.init_state(data.vert_gid, data.out_deg,
                                       data.vert_valid,
                                       **{**params, **query_kwargs})
        state = {k: _over_queries(v, batch, vshape).contiguous()
                 for k, v in state.items()}
        s = torch.zeros(batch, dtype=torch.int32,
                        device=data.vert_gid.device)
        state, payload, active = self._applied(data, state, s)
        return StepCarry(state, payload, active, s, self.init_stats(batch))

    def step_deliver(self, data, carry: StepCarry):
        return self.deliver(data, carry.payload, carry.active)

    def step_combine(self, data, carry: StepCarry, delivered) -> StepCarry:
        k = self.kernel
        state, payload, active, s, stats = carry
        acc, got, carry_v, aux = delivered
        if k.carry_dtype is not None:
            state = k.gather(state, acc, carry_v, got, s)
        else:
            state = k.gather(state, acc, got, s)
        stats = self.update_stats(stats, data, active, aux)
        return StepCarry(state, payload, active, s, stats)

    def step_exchange(self, data, carry: StepCarry) -> StepCarry:
        return self.step_combine(data, carry, self.step_deliver(data, carry))

    def step_apply(self, data, mid: StepCarry) -> StepCarry:
        state, _, _, s, stats = mid
        s = s + 1
        state, payload, active = self._applied(data, state, s)
        return StepCarry(state, payload, active, s, stats)

    def step(self, data, carry: StepCarry) -> StepCarry:
        return self.step_apply(data, self.step_exchange(data, carry))

    def alive(self, carry: StepCarry) -> torch.Tensor:
        """(B,) bool: any vertex of the query still active, on any shard
        of the mesh."""
        return self.global_any(carry.active.flatten(1).any(dim=1))

    def run_loop(self, data, cap: int, params: Dict[str, Any],
                 query_kwargs: Dict[str, Any], batch: int) -> StepCarry:
        """Run every query to quiescence (or ``cap`` supersteps); finished
        queries are frozen. One host read of the live bits a superstep,
        after they are reduced across the mesh, so every process of a
        mesh takes the same number of supersteps."""
        carry = self.init_carry(data, params, query_kwargs, batch)
        while True:
            live = self.alive(carry) & (carry.superstep < cap)
            if not bool(live.any()):
                return carry
            carry = select_lanes(live, self.step(data, carry), carry)
