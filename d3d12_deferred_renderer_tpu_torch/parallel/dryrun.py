"""The multi-device dry run: the counterpart of
d3d12_deferred_renderer_tpu/parallel/dryrun.py.

Each step builds its scene, config and mesh, renders through a multi-device
entry point and asserts the frames against the single-device frames of the
same states (Lambert exact, PBR within 1 u8 on fewer than 0.2% of pixels):

- run_staged: frames x screen-row bands on the plain chain, with the full
  cross-band stack (replicated shadow map and banded PCF, bloom, FXAA);
- run_kernels (JAX's run_interpret): frames x row bands through the
  kernels' path (cfg.use_pallas, the fused tile renderer's band mode), held
  against the staged single-device frame of the plain chain;
- run_three_axis: frames x triangle shards x row bands on the mesh
  declared ("frame", "tri", "rows"), an order that differs from the
  shading's (rows major, tri minor): the composition the JAX package
  shipped with an axis-order defect in its round 4.

A step runs inside every rank of a group of n ranks (the default process
group of parallel.launch), the scene on the rank's device.
``dryrun_multichip(n, device)`` spawns the n ranks through
parallel.run_bands and runs the three steps in each: on the card unless
device="cpu" (gloo on the CPU), and where the card is asked for and there is
none it raises before it spawns anything.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import RendererConfig


def staged_config() -> RendererConfig:
    """The staged dry-run config: a tiny frame with every cross-band
    feature (replicated shadow map + banded PCF, bloom's gathered bright
    field, FXAA's boundary rows)."""
    return RendererConfig(width=128, height=32, use_pallas=False, shading="pbr", shadows=True,
                          shadow_map_size=64, bloom=True, fxaa=True)


def kernel_config() -> RendererConfig:
    """The kernels' dry-run config: the band path the card runs (binned
    record stream + the fused tile renderer a band); the config-4 extras
    are the staged step's."""
    return RendererConfig(width=128, height=64, use_pallas=True, fused=True, shading="pbr",
                          shadows=False, bloom=False, fxaa=False)


def dryrun_scene(cfg: RendererConfig, device):
    """A cube and 8 point lights on `device`: small, and every band and
    shard holds geometry."""
    from ..models import build_scene_geometry, procedural
    from ..scene import make_scene, random_point_lights

    geo = build_scene_geometry([procedural.cube(1.0)])
    return make_scene(geo, cfg, lights=random_point_lights(8, cfg=cfg, device=device), device=device)


def factor_axes(n_ranks: int, height: int = 32):
    """n -> (frames, rows): rows the largest power of 2 (at most 8) that
    divides n and the height; frames the rest."""
    rows, n = 1, n_ranks
    while n % 2 == 0 and height % (rows * 2) == 0 and rows < 8:
        rows *= 2
        n //= 2
    return n_ranks // rows, rows


def assert_matches_single_device(got: torch.Tensor, start_state, cfg: RendererConfig, max_lsb: int, name: str):
    """Frame i of `got` [B, H, W, 3] against the (i + 1)-th step_frame of
    `start_state` on one device: at most max_lsb u8 off, on fewer than 0.2%
    of pixels."""
    from ..frame import step_frame

    s = start_state
    for i in range(got.shape[0]):
        s, f = step_frame(s, cfg)
        diff = (got[i].to(torch.int32) - f.to(torch.int32)).abs()
        frac = float((diff > 0).double().mean())
        assert int(diff.max()) <= max_lsb and frac < 2e-3, (name, i, int(diff.max()), frac)


def run_staged(device) -> None:
    """Frames x row bands on the plain chain with the full cross-band
    stack, against single-device frames."""
    from .mesh import make_mesh
    from .sharded import animation_times, render_frames_batch_sharded

    cfg = staged_config()
    state = dryrun_scene(cfg, device)
    frames, rows = factor_axes(dist.get_world_size(), cfg.height)
    mesh = make_mesh((frames, rows), ("frame", "rows"))
    batch = max(frames, 2)
    out = render_frames_batch_sharded(state, animation_times(0.0, batch, device=device), cfg, mesh)
    assert tuple(out.shape) == (batch, cfg.height, cfg.width, 3), out.shape
    assert_matches_single_device(out, state, cfg, 1, "frames x rows")


def run_kernels(device) -> None:
    """Frames x row bands through the kernels' path (the fused band), held
    against the staged single-device frame of the plain chain (within 1
    u8 on < 0.2%)."""
    from .mesh import make_mesh
    from .sharded import animation_times, render_frames_batch_sharded

    cfg = kernel_config()
    state = dryrun_scene(staged_config(), device)
    n = dist.get_world_size()
    rows = 2 if n % 2 == 0 else 1
    mesh = make_mesh((n // rows, rows), ("frame", "rows"))
    batch = max(n // rows, 2)
    out = render_frames_batch_sharded(state, animation_times(0.0, batch, device=device), cfg, mesh)
    assert tuple(out.shape) == (batch, cfg.height, cfg.width, 3), out.shape
    assert_matches_single_device(out, state, dataclasses.replace(cfg, use_pallas=False, fused=False), 1,
                                 "kernel bands")


def three_axis_mesh(n_ranks: int):
    """-> (the (frame, tri, rows) mesh, frames): declared "tri" before
    "rows", unlike the shading's band order, so it keeps pinning that the
    result does not depend on the declaration."""
    from .mesh import make_mesh

    tri = 2
    rows = 2 if n_ranks % 4 == 0 else 1
    frames = n_ranks // (tri * rows)
    return make_mesh((frames, tri, rows), ("frame", "tri", "rows")), frames


def run_three_axis(device) -> None:
    """Frames x triangle shards x row bands with shadows, bloom and FXAA,
    against single-device frames."""
    from .sharded import animation_times, render_frames_batch_tri_sharded

    cfg = staged_config()
    state = dryrun_scene(cfg, device)
    mesh, frames = three_axis_mesh(dist.get_world_size())
    batch = max(frames, 2)
    out = render_frames_batch_tri_sharded(state, animation_times(0.0, batch, device=device), cfg, mesh,
                                          frame_axis="frame", tri_axis="tri", rows_axis="rows")
    assert tuple(out.shape) == (batch, cfg.height, cfg.width, 3), out.shape
    assert_matches_single_device(out, state, cfg, 1, "frames x tri x rows")


STEPS = (("staged", run_staged), ("kernels", run_kernels), ("three_axis", run_three_axis))


def dryrun_job(device):
    """The dry run's rank: every step in turn -> [step name, ...]."""
    done = []
    for name, step in STEPS:
        step(device)
        done.append(name)
    return done


def dryrun_multichip(n: int, device: str = "cuda", timeout_s: float = 600.0) -> list:
    """Spawn n ranks (parallel.run_bands) and run the three steps in each
    -> each rank's ([step name, ...], {kernel wrapper: launches}).  Raises
    where a step's assertion fails in any rank."""
    from .launch import counted, run_bands

    if n % 2:
        raise ValueError(f"the three-axis step needs an even rank count, got {n}")
    return run_bands(n, counted, (dryrun_job,), device=device, timeout_s=timeout_s)


__all__ = [
    "staged_config", "kernel_config", "dryrun_scene", "factor_axes", "assert_matches_single_device",
    "run_staged", "run_kernels", "three_axis_mesh", "run_three_axis", "dryrun_multichip",
]
