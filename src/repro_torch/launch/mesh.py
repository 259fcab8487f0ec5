"""Device meshes: named axes over a grid of devices.

The port's copy of ``repro.launch.mesh``. A :class:`Mesh` is a plain
description (axis names and sizes, and the devices it spans when it
spans real ones); the sharding rules (``distributed/sharding.py``) and
the cell builders (``launch/steps.py``) read it. The production meshes
are abstract (no devices), as the reference's dry run uses them, and a
test mesh names the visible cards, or the devices it is given.

:func:`device_mesh` turns a mesh into a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
and sizes, over the ranks of an initialised process group (one rank per
device, ``distributed/spawn.py``): the cells then execute as DTensors
under their specs (``launch/steps.py`` ``Cell.run``), where the
reference executes ``jax.jit(fn, in_shardings=...)`` over a
``jax.sharding.Mesh``. Nothing here starts a process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` with their ``axis_sizes``, in order; ``devices``,
    when given, lists the ``size`` devices of the grid in row-major
    order."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} names {len(self.axis_names)}"
                             f" axes, {self.axis_sizes} sizes "
                             f"{len(self.axis_sizes)}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh spans {self.size} "
                             f"devices, given {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices)
    abstract mesh."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Small ``("data", "model")`` mesh over ``devices`` (default: the
    visible CUDA cards; a host with no card raises), the first
    ``n_devices`` of them when given: ``(n // 2, 2)`` for an even count,
    ``(n, 1)`` for an odd one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_test_mesh: no CUDA card is visible; "
                               "pass devices= to mesh other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = n_devices or len(devices)
    if not 0 < n <= len(devices):
        raise ValueError(f"make_test_mesh: {n} devices asked, "
                         f"{len(devices)} available")
    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    return Mesh(("data", "model"), shape, devices[:n])


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension (pod composes with data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh: Mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


def device_mesh(mesh: Mesh, device_type: str | None = None):
    """``mesh`` as a ``DeviceMesh`` over the current process group, axis
    for axis (rank ``r`` is the ``r``-th device in row-major order).

    The group must be initialised with world size ``mesh.size``.
    ``device_type`` defaults to the type of ``mesh.devices``; an abstract
    mesh (no devices) needs it, as the dry run's production meshes do on
    the ``fake`` backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group is initialised "
                           "(start the ranks with distributed.spawn)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"device_mesh: a {mesh.axis_sizes} mesh needs "
                         f"{mesh.size} ranks, the group has "
                         f"{dist.get_world_size()}")
    if device_type is None:
        if mesh.devices is None:
            raise ValueError("device_mesh: an abstract mesh needs "
                             "device_type")
        device_type = mesh.devices[0].type
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
