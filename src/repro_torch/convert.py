"""Carrying a compiled graph and query state across the two packages.

There are no weights in a graph engine: what the JAX and torch engines
share is the compiled :class:`PartitionedGraph` and the query state.

``partitioned_graph_from_numpy`` builds the port's ``PartitionedGraph``
from another one's dataclass fields as numpy arrays (for example
``{f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)}`` of the
JAX package's), so both engines can run on the very same layout.
``state_to_numpy`` turns a state of tensors back into host numpy in the
JAX layout: ``(P, Vm)`` per-vertex shard arrays, 0-d scalars, or a
leading query axis where the state has one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

__all__ = ["partitioned_graph_from_numpy", "state_to_numpy"]


def partitioned_graph_from_numpy(
        fields: Dict[str, Union[np.ndarray, int]]):
    """The port's ``PartitionedGraph`` from its fields (arrays or ints).
    Every field of the dataclass must be given; arrays are copied."""
    # Imported here: the engine imports this module for state_to_numpy.
    from .core.partition import PartitionedGraph
    names = {f.name for f in dataclasses.fields(PartitionedGraph)}
    missing = names - set(fields)
    extra = set(fields) - names
    if missing or extra:
        raise ValueError(f"PartitionedGraph fields: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    kw = {}
    for name in names:
        v = fields[name]
        if isinstance(v, np.ndarray):
            kw[name] = np.array(v)
        elif v is None:
            kw[name] = None
        else:
            kw[name] = int(v)
    return PartitionedGraph(**kw)


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors (on any device) -> host numpy arrays, same keys."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}
