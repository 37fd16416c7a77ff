"""The rows group of the screen-row band path: the counterpart of
d3d12_deferred_renderer_tpu/parallel/mesh.py's ``make_mesh`` for the one
axis the port has, screen-row bands.

A rank renders one band of every frame; the ranks of a frame form one
``torch.distributed`` process group, given its address, size and this
rank's place explicitly (nothing on a machine tells a program of its
cluster).  The backend follows where the ranks run:

- NCCL when each rank has a card of its own;
- gloo when the ranks share one card: NCCL refuses two ranks on one
  device.  The band path's collectives are few and small (a 4x-downsampled
  bright field, FXAA's boundary rows, the overflow count, the uint8 band),
  and parallel/sharded.py stages the CUDA ones through host memory, so the
  rendering stays on the card;
- gloo on the CPU.
"""
from __future__ import annotations

import datetime

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
