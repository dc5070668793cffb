"""Meshes of the deployment targets (port of ``repro/launch/mesh.py``).

A ``Mesh`` holds the axis names and shape of a target's mesh, and the
torch ``DeviceMesh`` over its ranks when there are ranks.  A one-device
mesh needs no process group: its step runs on one device as a plain
step.  A mesh of several devices needs one rank per device, in a
process group the caller initialized (``torch.distributed.
init_process_group``, one process per rank, e.g. under ``torchrun``);
without one, building it raises, and nothing falls back to one device.
A mesh with no ``DeviceMesh`` is a description: the rules engine and
the build read its names and sizes, and a step refuses to run on it.

Importing this module starts no process group.  There is no counterpart
of the reference's ``make_production_mesh``: the port's cluster targets
(``nvidia:h100x256``, ``nvidia:h100x512``) have no ranks here, so their
builds take a description (``describe``), which the dry run reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    # "cuda" or "cpu": where a one-device mesh's tensors live
    device_type: str = "cpu"
    # the torch DeviceMesh over the ranks; None for one device or a
    # description
    device_mesh: Any = None

    @property
    def device(self) -> torch.device:
        return torch.device(self.device_type)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def live(self) -> bool:
        """True where a step can run on it: one device, or ranks."""
        return self.device_mesh is not None or self.size == 1

    def coordinate(self) -> tuple[int, ...] | None:
        """This rank's index along each axis (zeros on one device); None
        for a rank outside the mesh."""
        if self.device_mesh is None:
            return (0,) * len(self.shape) if self.size == 1 else None
        return self.device_mesh.get_coordinate()


def describe(shape: tuple[int, ...], axes: tuple[str, ...],
             device_type: str = "cpu") -> Mesh:
    """A mesh of ``shape`` over ``axes`` with no ranks behind it."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    return Mesh(tuple(axes), tuple(shape), device_type)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str) -> Mesh:
    """The first ``prod(shape)`` ranks of the process group as a mesh of
    ``shape`` (every rank of the group must call this: the mesh's
    subgroups are made collectively), or one device's."""
    mesh = describe(shape, axes, device_type)
    if mesh.size == 1:
        return mesh
    import torch.distributed as dist
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < mesh.size:
        raise RuntimeError(
            f"mesh {tuple(shape)} over {tuple(axes)} needs {mesh.size} ranks "
            f"but the process group has {have}: launch one process per "
            f"rank (e.g. torchrun --nproc-per-node {mesh.size}) and call "
            f"torch.distributed.init_process_group first")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(mesh.size).reshape(tuple(shape))
    return dataclasses.replace(
        mesh, device_mesh=DeviceMesh(device_type, ranks,
                                     mesh_dim_names=tuple(axes)))


def _device_type(target) -> str:
    return "cpu" if target.chip == "cpu" else "cuda"


def mesh_for_target(target) -> Mesh:
    """The mesh a TargetSpec describes (the first N ranks)."""
    return _mesh(tuple(target.mesh_shape), tuple(target.mesh_axes),
                 _device_type(target))


def degraded_mesh(target, *, lost_data_slices: int = 1) -> Mesh:
    """Elastic-scaling mesh: drop `lost_data_slices` rows of the data axis
    (node failure) and rebuild — TP ('model') state needs no resharding.
    The ranks past the smaller mesh get no coordinate and sit out."""
    shape = list(target.mesh_shape)
    axes = tuple(target.mesh_axes)
    di = axes.index("data")
    if shape[di] - lost_data_slices < 1:
        raise ValueError("cannot degrade below one data slice")
    shape[di] -= lost_data_slices
    return _mesh(tuple(shape), axes, _device_type(target))
