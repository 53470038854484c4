"""Production meshes (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group (the reference's rule: its dry-run sets
XLA's flags before the backend starts).

  single pod : (16, 16)    ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16) ("pod", "data", "model")   = 512 ranks

The LM meshes are ``torch.distributed.device_mesh.DeviceMesh``es over the
ranks of the initialised default process group (one rank a card, as
``torchrun`` starts them). The graph engine's meshes are its own mesh
type (``core/mesh.py``): a ``ProcessGroupMesh`` of one shard a rank, or
the ``LocalMesh`` that stacks every shard on one device.
"""
from __future__ import annotations

import contextlib

__all__ = ["PRODUCTION", "make_production_mesh", "make_graph_mesh",
           "make_local_mesh", "make_serving_mesh", "dryrun_world"]

# (shape, axis names) of the production meshes
PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


@contextlib.contextmanager
def dryrun_world(n: int):
    """Within: a default process group of ``n`` ranks in this one
    process, over torch's ``fake`` backend (its collectives move nothing
    and return at once), this process its rank 0; destroyed on exit. The
    dry-run's world: ``make_production_mesh(device="cpu")`` builds over
    it, and DTensors over ``meta`` blocks run a step of the production
    mesh's rank 0 without a card. The group is process-wide: raises if
    one is already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(need: int, what: str) -> None:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised process group "
                           f"(init_process_group, e.g. under torchrun) of "
                           f"{need} ranks")
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(f"{what} needs {need} ranks (one a card); the "
                           f"process group has {have}")


def _device_type(device) -> str:
    from ..core.engine import resolve_device
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over the default process group's
    ranks. Raises, naming the ranks it needs, when the world has another
    size. On the card unless ``device="cpu"`` is asked for."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device_type(device)
    shape, names = PRODUCTION[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    what = "the multi-pod mesh" if multi_pod else "the production mesh"
    _world(n, f"{what} {shape} {names}")
    return init_device_mesh(dev, shape, mesh_dim_names=names)


def make_local_mesh(axes=("data",), shape=None, *, device=None):
    """A mesh over the ranks that exist: all of them on one axis, or
    ``shape`` (its product the world size) over ``axes``. Tests and
    reduced runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group (init_process_group)")
    axes = tuple(axes)
    if shape is None:
        if len(axes) != 1:
            raise ValueError("give the shape of a mesh of several axes")
        shape = (dist.get_world_size(),)
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=axes)


def make_graph_mesh(*, group=None, device=None):
    """Every rank of ``group`` (the default process group unless given)
    as one shard of the graph engine: a ``core.mesh.ProcessGroupMesh``
    (the reference's one ``"graph"`` axis over every chip, the paper's
    n_FPGA). On the card unless ``device="cpu"`` is asked for."""
    from ..core.mesh import ProcessGroupMesh
    return ProcessGroupMesh(group=group, device=device)


def make_serving_mesh(num_shards: int, *, device=None):
    """The service's explicit graph mesh: ``num_shards`` shards stacked
    on one device, a ``core.mesh.LocalMesh`` (as the service's shard
    classes hold them)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    from ..core.mesh import LocalMesh
    return LocalMesh(num_shards, device)
