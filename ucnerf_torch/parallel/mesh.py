"""The rank grid of a multi-rank run: the port of ``make_mesh``.

``--mesh_shape S [R]`` with ``--mesh_axes`` names a grid of
``prod(mesh_shape)`` ranks, numbered row-major as JAX lays its devices
out (``devices.reshape(mesh_shape)``).  Each rank is one process holding
one device, ``cuda:(rank % device_count)`` on the card, else the CPU.
Besides the world group, every axis has one process group per line of
the grid along it (the ranks that differ only in that axis's
coordinate); a one-axis mesh uses the world group.

The backend is a placement rule: NCCL when every rank has a card of its
own; gloo when ranks share a card (NCCL refuses two ranks on one
device) and on the CPU.  Under gloo the tensors stay on the card: gloo
all-reduces and broadcasts CUDA tensors through the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def mesh_size(shape: Sequence[int]) -> int:
    return int(math.prod(int(s) for s in shape))


def check_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A mesh names one axis per dimension, as ``jax.sharding.Mesh``
    requires."""
    if len(shape) != len(axes):
        raise ValueError(
            f"--mesh_shape {tuple(shape)} has {len(shape)} axes but "
            f"--mesh_axes {tuple(axes)} names {len(axes)}")
    if any(int(s) < 1 for s in shape):
        raise ValueError(f"--mesh_shape {tuple(shape)}: every axis needs "
                         f"at least one rank")


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device_type)


def choose_backend(world: int, device_type: str) -> str:
    """NCCL when each of the ``world`` ranks has a card of its own, else
    gloo."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid and its process groups."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    axis_groups: Dict[str, object]

    @property
    def size(self) -> int:
        return mesh_size(self.shape)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.axes.index(axis)])

    def group(self, axis: Optional[str] = None):
        """The process group along ``axis``; the world group for None."""
        return dist.group.WORLD if axis is None else self.axis_groups[axis]


def make_mesh(shape: Sequence[int], axes: Sequence[str], rank: int,
              device: torch.device, backend: str) -> Mesh:
    """The mesh of an initialized default process group.  Every rank
    creates every axis line's group, in the same order, as
    ``dist.new_group`` requires."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    check_mesh(shape, axes)
    grid = np.arange(mesh_size(shape)).reshape(shape)
    groups = {}
    for i, axis in enumerate(axes):
        if len(shape) == 1:
            groups[axis] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                groups[axis] = g
    return Mesh(shape, axes, rank, device, backend, groups)


_CURRENT = [None]


def current_mesh() -> Optional[Mesh]:
    """The mesh of this process when it is a rank of a multi-rank run,
    else None."""
    return _CURRENT[0]


def set_current_mesh(mesh: Optional[Mesh]):
    _CURRENT[0] = mesh


def is_main_rank() -> bool:
    """True outside a multi-rank run and on its rank 0: the process that
    prints, writes files and saves checkpoints."""
    mesh = current_mesh()
    return mesh is None or mesh.is_main

