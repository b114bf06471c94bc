"""Production and host meshes as ``torch.distributed`` device meshes.

The port of ``repro/launch/mesh.py``.  Functions, not module constants:
importing this module touches no process group.  Single pod: 16x16 = 256
devices (data x model).  Multi-pod: 2 x 16 x 16 = 512 (pod x data x
model); the pod axis is outer data parallelism.

Every mesh is built by ``init_device_mesh`` over the process group the
caller initialised (``torch.distributed.init_process_group``), whose
world size must be the product of the mesh shape.  The device type follows
the group's backend: ``cuda`` for NCCL, ``cpu`` for gloo and for the fake
group of the dry run.  On one card the mesh is 1x1 over an NCCL world of
one rank (NCCL puts no two ranks on one GPU).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_device_type() -> str:
    """``cuda`` for an NCCL group, ``cpu`` for gloo and the fake group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialised: call init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    device_type = mesh_device_type()
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small mesh over the process group's ranks (tests / smoke runs)."""
    return make_mesh((data, model), ("data", "model"))


def host_mesh(mesh_shape=(1, 1), device=None, *,
              mesh: DeviceMesh | None = None) -> DeviceMesh | None:
    """The mesh a caller asked for; None for the plain one-device path.

    ``mesh`` is used as given (it must have the shape ``mesh_shape``);
    otherwise ``make_host_mesh(*mesh_shape)`` is built when the shape asks
    for more than one device.  ``(1, 1)`` without a ``mesh`` is the plain
    path whatever process group is initialised: a rank of a larger group
    then serves or trains on its own device, and runs no DTensor op.  A
    mesh whose device type is not ``device``'s raises: the caller's device
    is never replaced by the mesh's.
    """
    if mesh is None:
        if tuple(mesh_shape) == (1, 1):
            return None
        mesh = make_host_mesh(*mesh_shape)
    elif tuple(mesh.shape) != tuple(mesh_shape):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match "
                         f"the mesh's shape {tuple(mesh.shape)}")
    if device is not None:
        check_mesh_device(mesh, device)
    return mesh


def check_mesh_device(mesh: DeviceMesh, device) -> None:
    """Raise unless ``mesh`` lies on ``device``'s type of device."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"the mesh's devices are {mesh.device_type!r} but "
                         f"device {str(device)!r} was asked for")


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.mesh_dim_names if n in ("pod", "data"))


def num_data_shards(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


class AbstractMesh:
    """Axis names and sizes without devices or a process group.

    The counterpart of ``jax.sharding.AbstractMesh``: enough for the spec
    rules of ``runtime.sharding`` (which read names and sizes only), not
    for placing tensors.
    """

    def __init__(self, shape, axes):
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in rank")

    def size(self) -> int:
        return math.prod(self.shape)
