"""Carrying a compiled graph, query state and LM weights across the two
packages.

The JAX and torch graph engines share the compiled
:class:`PartitionedGraph` and the query state; the LM substrate shares
its parameter tree.

``partitioned_graph_from_numpy`` builds the port's ``PartitionedGraph``
from another one's dataclass fields as numpy arrays (for example
``{f.name: getattr(pg, f.name) for f in dataclasses.fields(pg)}`` of the
JAX package's), so both engines can run on the very same layout.
``state_to_numpy`` turns a state of tensors back into host numpy in the
JAX layout: ``(P, Vm)`` per-vertex shard arrays, 0-d scalars, or a
leading query axis where the state has one.
``lm_params_from_numpy`` turns an LM parameter tree of numpy arrays (the
JAX package's params through ``jax.tree.map(np.asarray, params)``) into
the port's tree of tensors, key for key and shape for shape: the
decoder-only tree of ``models.lm.lm_spec`` or, for an encoder-decoder
config, the ``enc``/``dec``/``cross`` tree of ``models.encdec``.
``adamw_state_from_numpy`` does the same for the reference's optimizer
state (its ``AdamWState``: float32 ``m`` and ``v`` trees and a
``count``), so both packages can step from one state. With ``mesh=`` (a
``DeviceMesh``) both place every leaf by ``sharding.param_sharding_rules``
(each rank keeps its shards of the whole tree it was given; the moments
take their params' placements, the count stays a plain tensor), so a
JAX tree and a sharded port tree compute the same thing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

__all__ = ["adamw_state_from_numpy", "lm_params_from_numpy",
           "partitioned_graph_from_numpy", "state_to_numpy"]


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


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A float32 or bfloat16 array as a tensor of its dtype. bfloat16
    comes from ``ml_dtypes`` (JAX's numpy type), which the port does not
    import: its bits pass as uint16."""
    if arr.dtype == np.float32:
        return torch.from_numpy(np.array(arr))
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(np.array(bits)).view(torch.bfloat16)
    raise ValueError(f"LM params are float32 or bfloat16, not {arr.dtype}")


def _spec(cfg, tree):
    """The spec tree ``tree`` holds: the enc-dec one when ``cfg`` is an
    encoder-decoder and the tree holds an ``enc`` stack, else the
    decoder-only one."""
    from .models import encdec as ED
    from .models import lm as LM
    if cfg.family == "encdec" and isinstance(tree, dict) and "enc" in tree:
        return ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
    return LM.lm_spec(cfg)


def _placed(spec, tree, mesh):
    from . import sharding as SH
    from .models.layers import axes_tree
    specs = SH.param_sharding_rules(mesh, spec, axes_tree(spec))
    return SH.place_tree(mesh, tree, specs)


def lm_params_from_numpy(cfg, tree, device=None, mesh=None):
    """The port's LM params for ``cfg`` from a nested dict of numpy arrays
    in the reference's layout. Every key and shape must be the spec's:
    ``models.encdec.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)`` when ``cfg``
    is an encoder-decoder and the tree holds an ``enc`` stack, else
    ``models.lm.lm_spec(cfg)`` (the decoder-only model, as the reference
    builds from any config). Each leaf keeps its dtype (float32 or
    bfloat16). Lands on ``device``: the card unless "cpu" is asked for;
    with ``mesh``, placed by the rules on it."""
    from .core.engine import resolve_device
    device = resolve_device(device if mesh is None else mesh.device_type)

    def walk(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                have = sorted(node) if isinstance(node, dict) else node
                raise ValueError(f"params{path}: keys {have}, expected "
                                 f"{sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}[{k!r}]")
                    for k in spec}
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{spec.shape}")
        return _leaf_tensor(arr).to(device)

    spec = _spec(cfg, tree)
    out = walk(spec, tree, "")
    return out if mesh is None else _placed(spec, out, mesh)


def adamw_state_from_numpy(cfg, state, device=None, mesh=None):
    """The port's ``AdamWState`` for ``cfg`` from the reference's (any
    object with ``m`` and ``v``, nested dicts of float32 numpy arrays in
    the params' layout, and ``count``): each moment tree checked key for
    key and shape for shape as ``lm_params_from_numpy`` checks params, the
    count a 0-d int32 tensor. Lands on ``device``: the card unless "cpu"
    is asked for; with ``mesh``, placed by the rules on it."""
    from .core.engine import resolve_device
    from .models.layers import leaves
    from .train.optimizer import AdamWState
    device = resolve_device(device if mesh is None else mesh.device_type)
    m = lm_params_from_numpy(cfg, state.m, device, mesh)
    v = lm_params_from_numpy(cfg, state.v, device, mesh)
    if any(t.dtype != torch.float32 for t in leaves(m) + leaves(v)):
        raise ValueError("AdamW moments are float32")
    count = torch.tensor(int(np.asarray(state.count)), dtype=torch.int32,
                         device=device)
    return AdamWState(m=m, v=v, count=count)
