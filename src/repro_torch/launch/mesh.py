"""Device meshes over ``torch.distributed``: the port of
``repro.launch.mesh``.

A :class:`Mesh` names its axes as the reference's ``jax.make_mesh`` does
(``("data", "model")``, or ``("pod", "data", "model")``) and lays the
ranks out row-major over them: rank ``r`` sits at
``np.unravel_index(r, shape)``.  A mesh made by :func:`make_mesh` also
holds this rank's coordinates, one process group per axis of size > 1
(the ranks that share every other coordinate) and the device its
tensors live on.  The production and smoke meshes hold only the shape
and the names: the sharding rules (``repro_torch.launch.shardings``)
read nothing else.

There is no global mesh (the reference's ``_SHARD_CTX``): a module that
runs on a mesh takes it as ``mesh=``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """Axis sizes by name, in mesh order (``shape``, as ``jax``'s
    ``Mesh.shape``); with process groups, this rank's coordinate on each
    axis, each axis's group (None for an axis of size 1) and the
    device."""
    shape: dict
    coords: dict | None = None
    groups: dict | None = None
    device: torch.device | None = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a name or a tuple of
        names), as a sharded dimension's block index."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def make_mesh(shape, axes, *, backend: str) -> Mesh:
    """A mesh over the initialised default process group, whose size must
    be ``prod(shape)``: ``backend`` ``"gloo"`` puts the tensors on the
    CPU, ``"nccl"`` on card ``rank % device_count``, made this process's
    current device before any group is built.  Every rank must call it,
    with the same arguments: each axis group is created on every rank in
    the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: init_process_group first")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the group has {world}")
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"backend {backend!r}: want 'gloo' or 'nccl'")
    grid = np.arange(world).reshape(shape)
    coords = {a: int(c) for a, c in
              zip(axes, np.unravel_index(rank, shape))}
    groups = {}
    for i, a in enumerate(axes):
        groups[a] = None
        if shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            g = dist.new_group(line.tolist(), backend=backend)
            if rank in line:
                groups[a] = g
    return Mesh(dict(zip(axes, shape)), coords, groups, device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, shape and names only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_smoke_mesh() -> Mesh:
    """A one-rank mesh with the production axis names."""
    return Mesh({"data": 1, "model": 1})


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
