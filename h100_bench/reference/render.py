"""The plain reference frame: what the presented uint8 frame of a
configuration at an animation clock must be.

It reads the scene arrays (scenegen.scene_arrays) and the configuration's
renderer settings only, and imports nothing of the program.  The chain:
the yaw of every mesh set to the clock, triangle setup, the raster
(raster.py), world positions from depth, the procedural bump, the G-buffer
round trip, the shadow map and its PCF, every light at every pixel, then
bloom, Reinhard, gamma, FXAA and uint8 (shade.py).
"""
from __future__ import annotations

import types

import torch

from . import raster, setup, shade
from .xmath import matmul4_fma


def renderer_config(fields: dict) -> types.SimpleNamespace:
    """The renderer settings of a configuration file, lists as tuples."""
    return types.SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def device_scene(arrays: dict, device) -> dict:
    """The scene arrays as tensors on `device` (mesh ids int32, the rest float32)."""
    return {k: torch.as_tensor(v, dtype=torch.int32 if k == "geometry.tri_mesh_id" else torch.float32,
                               device=device) for k, v in arrays.items()}


def render_frame(scene: dict, cfg, clock: float, dtype=torch.float32) -> torch.Tensor:
    """uint8 [H, W, 3] of `scene` (device_scene) at animation clock `clock`
    under renderer settings `cfg` (renderer_config); the lighting in
    `dtype`."""
    if cfg.shading != "pbr" or cfg.supersample != 1 or cfg.animate_camera or cfg.shadow_vis_downsample > 1:
        raise NotImplementedError("the reference renders PBR frames at 1x with a fixed camera and full-rate PCF")
    H, W = cfg.height, cfg.width
    dev = scene["time"].device
    orientation = scene["orientation"].clone()
    orientation[:, 1] = torch.tensor(clock, dtype=torch.float32, device=dev)
    eye = scene["camera.eye"]
    model, view_proj, mvp = setup.frame_matrices(scene["position"], orientation, scene["scale"], eye,
                                                 scene["camera.at"], scene["camera.up"], cfg)
    cols = (scene["geometry.fv_pos_cols"], scene["geometry.fv_nrm_cols"], scene["geometry.fv_uv_cols"],
            scene["geometry.tri_mesh_id"])
    tris = setup.setup_triangles_reference(*cols, mvp, model, W, H, cull="back")
    frags = raster.rasterize(tris.packed, H, W)
    inv_vp = torch.linalg.inv_ex(view_proj)[0]
    world = shade.world_positions(frags.depth, inv_vp)
    normal = frags.normal
    if cfg.normal_mapping:
        normal = shade.bump(normal, frags.uv, frags.mesh_id, world, cfg.tile_h, cfg.tile_w,
                            cfg.bump_strength, cfg.bump_frequency)
    gb0, gb1 = shade.gbuffer(normal, frags.mesh_id, scene["materials.albedo"], scene["materials.metalness"],
                             scene["materials.roughness"], cfg.quantize_gbuffer)
    vis = None
    if cfg.shadows:
        S = cfg.shadow_map_size
        lvp = shade.light_view_proj(scene["lights.direction"])
        srec = setup.setup_depth_reference(cols[0], cols[3], matmul4_fma(model, lvp), S, S, cull="none")
        sdepth = raster.rasterize(srec.packed, S, S, depth_only=True).depth
        vis = shade.pcf_visibility(frags.depth, inv_vp, sdepth, lvp)
    hdr = shade.shade_pbr(gb0, gb1, frags.depth, world, eye, scene, cfg, vis, dtype)
    return shade.post(hdr, cfg)
