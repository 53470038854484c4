"""Mesh-aware sharding rules (FSDP x TP x optional pod DP), in PyTorch
(the port of ``repro.sharding``).

How every tensor class is laid out on the production meshes:

  (16, 16)    ("data", "model")           — one pod, 256 ranks
  (2, 16, 16) ("pod", "data", "model")    — two pods, 512 ranks

Rules (the reference's):
  * batch/tokens  : ("pod", "data")  (pod axis joins data parallelism)
  * params        : FSDP over ("pod","data") on the largest divisible dim
                    x TP over "model" on the contraction/feature dim
  * attention     : query/kv heads over "model" when divisible, else the
                    KV sequence axis (flash-decoding style) for decode
  * MoE experts   : over "model" (expert parallelism)
  * vocab/embed   : vocab over "model"

Two layers:

**Pure** (``batch_axes`` .. ``param_sharding_rules``): functions of the
mesh's axis names and sizes alone, with no process group and no device.
``mesh`` is a ``DeviceMesh``, a :class:`MeshShape`, or any object with
``axis_names`` and a ``shape`` mapping of name to size. A spec is a tuple
with one entry per tensor dimension: None (replicated), a mesh axis name,
or a tuple of names (the dimension split over them, the first outermost),
as ``tuple(jax.sharding.PartitionSpec)`` reads.

**Placement** (``placements`` .. ``paste``): a spec on a
``torch.distributed.device_mesh.DeviceMesh`` as DTensor placements, one
per mesh dimension, and tensors placed, constrained or written through
them. A dimension split over ("pod", "data") shards pod-major, as JAX's
``P(("pod", "data"))`` does: DTensor splits over the mesh dimensions in
their order.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

__all__ = [
    "MeshShape", "mesh_axes", "batch_axes", "fsdp_axes", "model_axis",
    "axis_size", "logical_to_spec", "parse_axes", "param_sharding_rules",
    "NamedSharding", "placements", "spec", "shard", "place", "place_tree",
    "constrain", "on_mesh", "local_offset", "paste", "write_at",
    "batch_spec", "is_dtensor", "local_region", "from_region", "settle",
    "axes_of", "einsum",
]


# ---------------------------------------------------------------------------
# pure: axis names and sizes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices (the counterpart of
    ``jax.sharding.AbstractMesh``): ``MeshShape((2, 16, 16), ("pod",
    "data", "model"))``."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return batch_axes(mesh)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh_axes(mesh) else None


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_axes(mesh)
    s = 1
    for n in names:
        s *= sizes[n]
    return s


def logical_to_spec(mesh, logical: Sequence[Optional[str]],
                    shape: Sequence[int]) -> tuple:
    """Map logical axis names to mesh axes, dropping assignments that do
    not divide the dimension (padding-free rule: replicate rather than
    pad)."""
    b = batch_axes(mesh)
    m = model_axis(mesh)
    table = {
        None: None,
        "batch": b if b else None,
        "fsdp": b if b else None,          # FSDP shards dim over data(+pod)
        "model": m,
        "expert": m,
        "vocab": m,
        "seq": None,
        "kv_seq_model": m,                 # decode flash-split
        "kv_seq_pdm": tuple(list(b) + ([m] if m else [])) or None,
        "seq_model": m,                    # sequence parallelism
        "heads": m,
        "stack": None,                     # stacked layer dim
    }
    out = []
    for ax_logical, dim in zip(logical, shape):
        phys = table.get(ax_logical, None)
        if phys is None:
            out.append(None)
            continue
        sz = axis_size(mesh, phys)
        if dim % sz != 0:
            out.append(None)  # not divisible: replicate rather than pad
        else:
            # one axis is its name, as PartitionSpec normalizes it
            out.append(phys[0] if isinstance(phys, tuple)
                       and len(phys) == 1 else phys)
    return tuple(out)


def parse_axes(s: str):
    """'fsdp,model' -> ("fsdp", "model"); '.' entries mean replicated."""
    return tuple(None if a in (".", "") else a for a in s.split(","))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_sharding_rules(mesh, abstract_params, logical_axes):
    """``abstract_params``: a tree of anything with a ``shape`` (``meta``
    tensors will do); ``logical_axes``: the matching tree of comma-joined
    logical-axis strings. Returns the tree of specs (the reference returns
    ``NamedSharding``s; :func:`place_tree` places a tree by these)."""
    def one(a, names):
        ax = parse_axes(names)
        assert len(ax) == len(a.shape), (names, tuple(a.shape))
        return logical_to_spec(mesh, ax, tuple(a.shape))
    return _tree_map(one, abstract_params, logical_axes)


def batch_spec(mesh, shape, leading: int = 0) -> tuple:
    """The spec of a batch entry: its axis ``leading`` over the batch
    axes (after ``leading`` unsharded axes, e.g. a microbatch axis), the
    rest replicated."""
    logical = (None,) * leading + ("batch",) + (None,) * (
        len(shape) - leading - 1)
    return logical_to_spec(mesh, logical, shape)


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec, partial=()) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d`` is split over, ``Partial()``
    on the mesh axes named in ``partial`` (a part of a sum on each rank:
    a region's local gradient or result), Replicate elsewhere."""
    names = list(mesh.mesh_dim_names)
    out = [Partial() if n in partial else Replicate() for n in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(n) for n in axes_of(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in dims:
            if not isinstance(out[i], Replicate):  # sharded or partial
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec!r}")
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (``jax.sharding.NamedSharding``'s
    counterpart)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def place(self, t: torch.Tensor) -> DTensor:
        return place(self.mesh, t, self.spec)


def spec(mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, tuple(axes))


def _full(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` on the mesh's device type; a ``meta`` tensor stays one."""
    dev = mesh.device_type
    return t if t.device.type in (dev, "meta") else t.to(dev)


def place(mesh, t, spec_) -> DTensor:
    """``t`` placed by ``spec_``. A plain tensor is the whole (global)
    value, the same on every rank: each rank keeps a copy of its block,
    or ``t`` itself where its block is the whole tensor (every axis that
    splits it has one rank), so a mesh of one rank places for free. A
    ``meta`` tensor gets an empty ``meta`` block of its rank's shape (the
    dry-run: nothing is allocated or copied). A DTensor is
    redistributed."""
    pl = placements(mesh, spec_)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    t = _full(torch.as_tensor(t), mesh)
    if t.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())
    if all(mesh.size(i) == 1 for i, p in enumerate(pl) if p.is_shard()):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def shard(mesh, x, *axes) -> DTensor:
    return place(mesh, x, tuple(axes))


def place_tree(mesh, tree, specs):
    """Every leaf of ``tree`` placed by the matching leaf of ``specs``."""
    return _tree_map(lambda t, s: place(mesh, t, s), tree, specs)


def constrain(x, mesh, logical: Sequence[Optional[str]]):
    """``x`` laid out by the logical axes ``logical`` (the reference's
    ``with_sharding_constraint`` of ``logical_to_spec``): a DTensor is
    redistributed, a plain tensor (the whole value on every rank)
    placed. Without a mesh, ``x`` as it is."""
    if mesh is None:
        return x
    return place(mesh, x, logical_to_spec(mesh, logical, tuple(x.shape)))


def settle(x):
    """``x`` with its pending sums done: every ``Partial`` placement (a
    contraction over a sharded axis, kept unreduced by DTensor) made
    Replicate. DTensor keeps a sum pending through ops it takes for
    linear, casts among them, and a cast of the parts to bf16 rounds
    each part where the reference rounds their sum; the model settles
    its residual stream between blocks. Anything else as it is."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


@contextlib.contextmanager
def on_mesh(mesh):
    """Within: plain tensors met by DTensor ops (positions, masks, the
    step's scalars) count as replicated. Nests; a no-op without a
    mesh."""
    if mesh is None:
        yield
        return
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def local_offset(x: DTensor, dim: int) -> int:
    """Where this rank's block of ``x`` starts along ``dim``, in global
    indices (blocks are even: the rules never shard a dimension they do
    not divide)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    block, n = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = mesh.size(i)
            block = block * size + coord[i]
            n //= size
    return block * n


def _gathered_along(x: DTensor, dims) -> list:
    """``x``'s placements with every Shard of a dim in ``dims``
    replaced by Replicate."""
    return [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in x.placements]


def paste(buf: DTensor, new) -> DTensor:
    """Write ``new`` into ``buf`` at offset 0 on every dimension, in
    place, each rank into its own block (``jax.lax.dynamic_update_slice``
    at 0). ``new`` is no larger than ``buf`` anywhere."""
    short = [d for d in range(buf.ndim) if new.shape[d] != buf.shape[d]]
    target = _gathered_along(buf, short)
    if not isinstance(new, DTensor):
        new = DTensor.from_local(_full(new, buf.device_mesh),
                                 buf.device_mesh,
                                 [Replicate()] * buf.device_mesh.ndim,
                                 run_check=False)
    local_new = new.redistribute(buf.device_mesh, target).to_local()
    local_buf = buf.to_local()
    dst, src = [], []
    for d in range(buf.ndim):
        if d not in short:
            dst.append(slice(None))
            src.append(slice(None))
            continue
        off = local_offset(buf, d)
        take = max(0, min(new.shape[d] - off, local_buf.shape[d]))
        dst.append(slice(0, take))
        src.append(slice(off, off + take))
    local_buf[tuple(dst)].copy_(local_new[tuple(src)])
    return buf


def write_at(buf: DTensor, new, pos, axis: int) -> DTensor:
    """Write ``new`` (one position along ``axis``) into ``buf`` at
    global position ``pos`` (a one-element int64 tensor on the device),
    in place: the rank whose block holds ``pos`` writes it, the others
    write their own value back. No host read of ``pos``."""
    target = _gathered_along(buf, (axis,))
    if not isinstance(new, DTensor):
        new = DTensor.from_local(_full(new, buf.device_mesh),
                                 buf.device_mesh,
                                 [Replicate()] * buf.device_mesh.ndim,
                                 run_check=False)
    local_new = new.redistribute(buf.device_mesh, target).to_local()
    local_buf = buf.to_local()
    n = local_buf.shape[axis]
    idx = pos.to(local_buf.device).reshape(1) - local_offset(buf, axis)
    mine = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    old = local_buf.index_select(axis, idx)
    local_buf.index_copy_(axis, idx, torch.where(
        mine, local_new.to(local_buf.dtype), old))
    return buf


def local_region(x: DTensor, spec_, grad) -> torch.Tensor:
    """``x`` redistributed to ``spec_`` and its local block, for a region
    of plain-tensor code. ``grad``: the placements the region's gradient
    with respect to that block has (e.g. ``Partial()`` over an axis whose
    ranks each see part of the sum)."""
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec_)).to_local(
        grad_placements=grad)


def from_region(y: torch.Tensor, mesh, pl, like_shape) -> DTensor:
    """A region's local result ``y`` as a DTensor of placements ``pl``
    and global shape ``like_shape``."""
    return DTensor.from_local(y.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(like_shape),
                              stride=_contiguous_stride(like_shape))


def einsum(eq: str, *operands, split: Dict[str, str]):
    """``torch.einsum(eq, *operands)`` on DTensors as a region of plain
    tensors. ``split`` maps a subscript to a logical axis (``{"b":
    "batch", "h": "heads"}``): that letter's dimension is split over the
    axis's mesh axes where they divide it (``logical_to_spec``: replicate
    rather than pad), and every other dimension is whole on each rank.
    Each rank contracts its blocks; a mesh axis that splits a letter a
    tensor lacks makes that tensor a part of a sum over the axis (the
    result, where the letter is contracted; an operand's gradient,
    where the letter is another operand's or the result's). Plain
    operands count as replicated. DTensor's own einsum propagation
    shards a head axis the mesh does not divide, then cannot unflatten
    it."""
    mesh = next(o.device_mesh for o in operands if is_dtensor(o))
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    size = {c: n for s, o in zip(subs, operands) for c, n in zip(s, o.shape)}
    axes = {}
    for c, logical in split.items():
        if c in size:
            entry = logical_to_spec(mesh, (logical,), (size[c],))[0]
            if entry is not None:
                axes[c] = entry

    def layout(s):
        """(spec, placements) of a tensor of subscripts ``s``."""
        spec_ = tuple(axes.get(c) for c in s)
        parts = [a for c, e in axes.items() if c not in s for a in axes_of(e)]
        return spec_, placements(mesh, spec_, parts)

    local = []
    for s, o in zip(subs, operands):
        spec_, grad = layout(s)
        if not is_dtensor(o):
            o = place(mesh, o, (None,) * o.ndim)
        local.append(local_region(o, spec_, grad))
    y = torch.einsum(eq, *local)
    return from_region(y, mesh, layout(out)[1],
                       tuple(size[c] for c in out))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
