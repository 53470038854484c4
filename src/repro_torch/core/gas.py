"""The GraVF-M three-stage programming model (paper §3), in PyTorch.

A graph algorithm is a :class:`GasKernel`: three small elementwise
functions with fixed interfaces (twin of ``repro.core.gas``):

  gather  : folds the per-destination combined message into vertex state
            (messages are pre-aggregated with ``combiner``, a monoid).
  apply   : called once per vertex at the end of a superstep; reads the
            state and may issue ONE update (payload + active flag).
  scatter : called once per (update, in-edge) at the RECEIVER to finalize
            the message.

The engine runs every query of a batch at once, so the functions see an
explicit leading query axis: per-vertex state leaves are ``(B, P, Vm)``,
per-query scalars ``(B,)``, ``superstep`` is ``(B,)``, and per-query
parameters (``query_params``, e.g. ``root``) arrive as ``(B, 1, 1)``.
The graph arrays (``vert_gid``, ``out_deg``, ``valid``) are ``(P, Vm)``;
a result that does not depend on the query may keep that shape, and the
engine broadcasts it over the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..kernels.ref import identity_for

__all__ = ["GasKernel", "COMBINER_IDENTITY"]

State = Dict[str, torch.Tensor]

COMBINER_IDENTITY = identity_for


@dataclasses.dataclass(frozen=True)
class GasKernel:
    """A user graph algorithm.

      init_state(vert_gid, out_deg, valid, **params)      -> state dict
      apply(state, vert_gid, out_deg, superstep)           -> (state, payload, active)
      scatter(payload, weight, src_gid, src_outdeg)        -> message value
      gather(state, combined_msg, got_msg, superstep)      -> state

    ``combiner`` ∈ {"min", "max", "add"}; ``msg_dtype`` the message dtype
    (a torch dtype). The remaining fields mean what they mean in
    ``repro.core.gas.GasKernel``.
    """

    name: str
    init_state: Callable[..., State]
    apply: Callable[..., Any]
    scatter: Callable[..., torch.Tensor]
    gather: Callable[..., State]
    combiner: str
    msg_dtype: torch.dtype
    update_dtype: Any = None
    max_supersteps: int = 0  # 0 = until quiescence
    update_bits: int = 32
    message_bits: int = 32
    # got = (combined != identity) is exact for this kernel; otherwise the
    # engine runs one more (max) combine to find the vertices with mail.
    got_from_identity: bool = True
    # Argmin-style carried value (SSSP's parent): among messages achieving
    # the winning key the minimum carry is delivered; gather then receives
    # (combined_key, carry, got).
    carry_dtype: Any = None
    scatter_carry: Callable[..., torch.Tensor] = None
    # Per-query ``init_state`` parameters, batched by ``run_batch``.
    query_params: tuple = ()

