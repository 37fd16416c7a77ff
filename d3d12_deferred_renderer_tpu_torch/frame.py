"""The frame: advance the scene, render it.

The counterpart of d3d12_deferred_renderer_tpu/frame.py, with "on the TPU"
read as "on the card".  Two paths:

- the fused frame (cfg.fused with cfg.use_pallas, PBR, quantized G-buffer):
  triangle setup (kernel) -> binning -> fused tile renderer (kernel) ->
  uint8; with shadows (the deferred-directional split) the shadow map, PCF
  and the directional resolve (kernel) follow the tile renderer, then
  bloom, tonemap, gamma and FXAA (ops/fused.render_fused);
- the staged frame, every other ported config: triangle setup (kernel) ->
  raster -> [bump] -> G-buffer encode -> Lambert, or [shadow map + PCF] +
  the per-tile light cull + PBR lighting -> bloom, tonemap, gamma, FXAA ->
  uint8.  With cfg.use_pallas the raster is the tile raster kernel over the
  binned records (ops/raster_tiles), the bump the bump kernel
  (ops/bump), the shadow map the depth-only setup and raster kernels
  (ops/shadows) and the PBR lighting the G-buffer lighting kernel on
  8 x 128 tiles (ops/lighting_cuda); without it, the whole-frame reference
  rasterizer (ops/raster_ref), the block-form bump, and the 32-pixel-tile
  plain lighting (lighting.shade_pbr_tiled), as the JAX package's CPU path
  and its golden images use.

A kernel's wrapper runs the kernel on CUDA tensors and its plain version on
CPU tensors.  PyTorch runs the frame eagerly, one launch after another on
the current stream.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .config import RendererConfig
from .ops import post
from .ops.bump import apply_normal_mapping
from .ops.fused import render_fused
from .ops.gbuffer import GBuffer, encode_gbuffer
from .ops.lighting import (
    inverse_view_proj, reconstruct_world_positions, shade_lambert, shade_pbr_tiled,
)
from .ops.lighting_cuda import shade_pbr_tiled_kernel
from .ops.raster_ref import rasterize_packed
from .ops.raster_tiles import rasterize_binned
from .ops.shadows import render_shadow_map, shadow_visibility
from .ops.transform import setup_frame_triangles
from .scene import SceneState, animate


def _fused_eligible(cfg: RendererConfig) -> bool:
    """The fused tile renderer covers the PBR frame with a quantized
    G-buffer; cfg.use_pallas off takes the staged path, as in JAX."""
    return cfg.fused and cfg.use_pallas and cfg.shading == "pbr" and cfg.quantize_gbuffer


# Configs outside the ported slice, with the ROADMAP.md Queue 1 item that
# ports them.
_NOT_PORTED = (
    (lambda c: _fused_eligible(c) and c.shadows and not c.deferred_directional,
     "fused shadows without the deferred-directional split (the tile kernel's "
     "visibility plane, item 7)"),
    (lambda c: _fused_eligible(c) and not c.inkernel_light_cull,
     "the fused frame's depth prepass + tile light cull (item 7)"),
    (lambda c: c.shadows and c.shadow_vis_downsample > 1, "shadow_vis_downsample > 1 (item 7)"),
    (lambda c: c.shadows and c.shadow_window_gather,
     "the shadow window gather (rejected by design; item 7)"),
    (lambda c: c.shadows and c.shadow_bin_tiers is not None,
     "calibrated shadow binning tiers (calibrate, item 10)"),
    (lambda c: c.supersample > 1, "supersampling (item 9)"),
)


def check_ported(cfg: RendererConfig) -> None:
    """Raise NotImplementedError for a config the port cannot render yet."""
    for test, what in _NOT_PORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch package yet (ROADMAP.md Queue 1)"
            )


def _rasterize(tris, cfg: RendererConfig):
    """(FragmentPlanes, overflow): the tile raster kernel over the binned
    records with cfg.use_pallas, else the whole-frame reference raster."""
    if cfg.use_pallas:
        return rasterize_binned(tris.packed, tris.aabb, tris.valid, cfg, return_overflow=True)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    return frags, torch.zeros((), dtype=torch.int32, device=tris.packed.device)


def render_stats(state: SceneState, cfg: RendererConfig):
    """One frame -> (uint8 [H, W, 3], {"overflow": int32 tensor}): the count
    of tiles that dropped triangles or lights at a capacity cap, plus
    binning-tier budget excess.  Zero on every supported config; a loud
    signal, never a silent drop, otherwise."""
    check_ported(cfg)
    if _fused_eligible(cfg):
        frame, overflow = render_fused(state, cfg, return_overflow=True)
        return frame, {"overflow": overflow}

    tris, view_proj = setup_frame_triangles(state, cfg)
    frags, overflow = _rasterize(tris, cfg)
    inv_vp = inverse_view_proj(view_proj)
    if cfg.normal_mapping:
        world = None if cfg.use_pallas else reconstruct_world_positions(frags.depth, view_proj, cfg, inv_vp)
        frags = apply_normal_mapping(frags, world, cfg, cfg.bump_strength, cfg.bump_frequency,
                                     inv_vp=inv_vp)
    gb = encode_gbuffer(frags, state.materials, cfg)
    if cfg.shading == "lambert":
        color = shade_lambert(gb, state.lights, cfg)
        if cfg.fxaa:
            color = post.fxaa(color)
    else:
        vis = None
        if cfg.shadows:
            shadow_depth, light_vp, s_overflow = render_shadow_map(state, cfg, return_overflow=True)
            vis, v_overflow = shadow_visibility(gb.depth, view_proj, shadow_depth, light_vp, cfg,
                                                return_overflow=True, inv_vp=inv_vp)
            overflow = overflow + s_overflow + v_overflow
        shade = shade_pbr_tiled_kernel if cfg.use_pallas else shade_pbr_tiled
        hdr, l_overflow = shade(gb, state.lights, cfg, view_proj, state.camera.eye,
                                shadow_visibility=vis, return_overflow=True, inv_vp=inv_vp)
        overflow = overflow + l_overflow
        color = post.apply_post(hdr, cfg)
    return post.to_uint8(color), {"overflow": overflow}


def render(state: SceneState, cfg: RendererConfig) -> torch.Tensor:
    """One frame -> display-ready uint8 [H, W, 3].  The overflow count stays
    on the device (render_stats returns it): a host-side warning would
    synchronise every frame (ROADMAP.md Queue 1 item 9)."""
    return render_stats(state, cfg)[0]


def render_gbuffer(state: SceneState, cfg: RendererConfig) -> GBuffer:
    """The geometry pass only (for tests and tools): the G-buffer with its
    format quantization."""
    check_ported(cfg)
    tris, _ = setup_frame_triangles(state, cfg)
    return encode_gbuffer(_rasterize(tris, cfg)[0], state.materials, cfg)


def step_frame(state: SceneState, cfg: RendererConfig) -> Tuple[SceneState, torch.Tensor]:
    """One iteration of the reference's loop (main.cpp:161-342): advance the
    animation clock, render."""
    state = animate(state, cfg.yaw_per_frame, cfg)
    return state, render(state, cfg)

