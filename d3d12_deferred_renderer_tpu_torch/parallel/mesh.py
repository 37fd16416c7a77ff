"""The rank mesh of the multi-device paths: the counterpart of
d3d12_deferred_renderer_tpu/parallel/mesh.py's ``make_mesh``.

The ranks of a frame form one ``torch.distributed`` process group, given
its address, size and this rank's place explicitly (nothing on a machine
tells a program of its cluster): ``make_rows_group`` joins a rank to it as
the default group.  ``make_mesh`` then lays the ranks of that group out on
named axes, row-major over the declared shape (as JAX reshapes its device
list), and makes one process group for each line of ranks along an axis:
the ranks that share every other coordinate.  Three axes compose (JAX's
mesh axes): screen-row bands ("rows"), batched frames ("frame") and shards
of the triangle stream ("tri", sort-last compositing).

The backend follows where the ranks run:

- NCCL when each rank has a card of its own;
- gloo when the ranks share one card: NCCL refuses two ranks on one
  device.  parallel/sharded.py stages the CUDA tensors of a gloo group
  through host memory, so the rendering stays on the card;
- gloo on the CPU.

The per-axis groups take the default group's backend.
"""
from __future__ import annotations

import datetime
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def rank_device(kind: str, rank: int, world_size: int) -> torch.device:
    """The device of band rank `rank`: the CPU for kind "cpu"; for "cuda"
    card `rank` when there is a card for every rank, else card 0, which the
    ranks share."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind {kind!r}: expected 'cpu' or 'cuda'")
    return torch.device("cuda", rank if world_size <= torch.cuda.device_count() else 0)


def make_rows_group(rank: int, world_size: int, init_method: str, device: torch.device,
                    timeout_s: float = 300.0):
    """Join this rank to the rows group as the default process group ->
    the group (torch.distributed.group.WORLD).  init_method is the
    rendezvous address every rank is given (tcp://localhost:<port> for
    ranks on one host); a rank that waits longer than timeout_s for the
    others, or inside a collective, raises.  The backend: NCCL when each
    rank has a card, gloo otherwise (see module docstring)."""
    own_card = device.type == "cuda" and world_size <= torch.cuda.device_count()
    dist.init_process_group(
        "nccl" if own_card else "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.group.WORLD


class Mesh(NamedTuple):
    """This rank's view of a rank mesh: the axis names and sizes in the
    order of declaration, this rank's coordinate on each axis, the process
    group of each axis's line of ranks through this rank (None for an axis
    of size 1, which needs no collective) and whether the groups stage CUDA
    tensors through host memory (gloo)."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[object, ...]
    staged: bool

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's Mesh.shape."""
        return dict(zip(self.names, self.sizes))

    def axis(self, name: str) -> int:
        """The position of axis `name` in the declaration."""
        if name not in self.names:
            raise ValueError(f"mesh has no axis {name!r}: its axes are {self.names}")
        return self.names.index(name)


def mesh_coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """The coordinates of `rank` on a mesh of `sizes`, row-major."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(sizes)))


def axis_lines(sizes: Sequence[int], axis: int) -> np.ndarray:
    """[lines, sizes[axis]]: the ranks of every line along `axis` (each
    line the ranks that share every other coordinate), in row-major order
    of the other coordinates."""
    grid = np.arange(math.prod(sizes)).reshape(tuple(sizes))
    return np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("frame", "rows")) -> Mesh:
    """Lay the ranks of the default process group out on named axes ->
    this rank's Mesh.  Every rank of the group calls it, with the same
    arguments (each makes every axis group, in one order).  The default is
    every rank on the last axis: axis_sizes (1, world size) for the default
    names, as JAX's default puts every device on "rows".  Raises ValueError
    when the product of the sizes is not the world size."""
    world = dist.get_world_size()
    names = tuple(axis_names)
    sizes = tuple(int(s) for s in (axis_sizes if axis_sizes is not None
                                   else (1,) * (len(names) - 1) + (world,)))
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for {len(names)} axis names {names}")
    if math.prod(sizes) != world:
        raise ValueError(f"axis sizes {sizes} != world size {world}")
    rank = dist.get_rank()
    groups = []
    for ax, size in enumerate(sizes):
        mine = None
        if size > 1:
            for line in axis_lines(sizes, ax):
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = g
        groups.append(mine)
    return Mesh(names, sizes, mesh_coords(rank, sizes), tuple(groups), dist.get_backend() == "gloo")
