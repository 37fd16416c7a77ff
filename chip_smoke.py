"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile the hand-written kernels (csrc/*.cu) with nvcc, one
             process per source, all started together.
2. k1      — the setup kernel against its plain PyTorch version on the
             flagship scene (23,906 triangles, 1920x1080): valid, mesh id and
             padding exact, float fields bit-equal or within rounding bounds.
3. k2      — the fused tile kernel against its plain version on the same
             binned input, at 256x64 and 1920x1080: equal per-tile overflow,
             max |du8| <= 1, fewer than 1% of pixels different; records
             and live lights per tile, ms back to back and replayed from a
             CUDA graph (device_ms), the bound from the pixels inside each
             binned record's box.
4. k6      — the tile raster kernel against its plain version on the same
             binned input at 256x64, 1280x720 (config 1) and 1920x1080
             (flagship scene): depth, mesh id and pad planes bit-equal,
             normal and uv planes within 2e-6, equal overflow; timed as k2.
5. k7      — the G-buffer lighting kernel against its plain version on the
             flagship G-buffer (256 lights), without and with a visibility
             plane: HDR within rtol 2e-4, atol 2e-5, after tonemap + gamma
             max |du8| <= 1 on fewer than 1% of pixels, equal tile counts.
6. k4      — the depth-only setup kernel against its plain version in the
             light's view of the flagship scene, cull none: records and
             boxes bit-equal.
7. k3      — the depth-only raster kernel: the 1024^2 shadow map on 16 x 128
             tiles equal (torch.equal) to its plain version at 64, 128 and
             256 records a work item, and on the display grid equal to the
             tile raster kernel's depth plane; timed as k2 on both grids.
8. k8      — the bump kernel against its plain version on the flagship
             frame's fragments: normals within 1e-6 (both round every
             operation once).
9. k2v     — the fused tile kernel's config-4 variant (bump, linear HDR, the
             split's aux planes) at 1920x1080: depth and mesh-id planes
             bit-equal to the tile raster kernel's on the same binned input,
             the depth, normal and mesh-id planes bit-equal to the plain
             version's, the frame within 1 u8 LSB of the plain version on
             < 1% of pixels.
10. k5     — the directional resolve kernel against its plain version on
             the k2v planes and the frame's PCF visibility: HDR within rtol
             2e-4, atol 2e-5.
11. main   — the fused flagship frame through the entry points (animate +
             render_stats, step_frame): a 64-step sweep of the whole yaw
             orbit with overflow 0, launch counts equal to the frames
             rendered, a frame that is not blank and agrees with the plain
             chain, and ms/frame from CUDA events over 3 x 30 frames.
12. staged — one line for config 1 (the reference's frame: Lambert, cube +
             pyramid, 1280x720) and one for the staged flagship (fused=False,
             1920x1080, 256 lights): the same sweep, launch counts and timing
             through tp.step_frame / tp.render_stats; overflow 0 for config
             1, equal to the plain chain's at every 4th step for the flagship.
13. config4 — one line for each config-4 path (shadows + bump + bloom on the
             flagship scene, 1024^2 shadow map): the fused frame with the
             deferred-directional split and the staged frame (fused=False):
             the same sweep (overflow 0; staged: equal to the plain chain's
             at every 4th step), launches, the last frame against its plain
             chain and the timing.
14. parity — bench.py's two 256x64 parity blocks ("pbr" and "config4"),
             the fused frame against the staged frame through the kernels:
             mean |du8| <= 1 and at most 2% of pixels more than 4 LSB off.
15. k2l    — the fused tile kernel fed by per-tile light lists (the depth
             prepass: the depth-only raster kernel on the frame's binned
             records, then the light cull) at 1920x1080 on the flagship
             scene: without a visibility plane, with the unsplit config-4
             PCF plane, with that plane, bump and linear HDR, and with bump
             and the split's aux planes; against the plain version (max
             |du8| <= 1 on < 1% of pixels, zero tile overflow), the prepass
             depth and the aux depth and mesh-id planes bit-equal to the
             tile raster kernel's; each variant's ms beside the in-kernel
             cull's on the same frame.
16. prepass — one line for each fused frame with the depth prepass through
             the entry points: the flagship without the in-kernel cull, and
             config 4 without the split or the in-kernel cull (the
             visibility plane): the sweep (overflow 0), launches (the depth
             raster once a frame for the prepass and once for the shadow
             map), the last frame against its plain chain, the timing.
17. calibrate — autotune_shadow on the split config 4 and autotune on the
             colonnade scene (the fused flagship config), as
             tools/bench_configs.py runs them: the derived tiers or budgets
             and their sort keys, then the calibrated config's 16-step
             sweep (overflow 0), launches and timing; the calibrated shadow map
             equal to the default tiers', the colonnade frame against its
             plain chain.
18. k9     — the row scatter kernel against its plain version (bit-equal) at
             n = 4096, 8192 (the TPU tool's sizes) and the flagship binning's
             sort-key count: ms, ns/row, the plain version's and one
             index_copy_'s ms, the bound, and torch.sort's ns/key at the
             same count.

Then the card's name and power limit (nvidia-smi), the kernels line, and the
last line {"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.  Needs one card; imports no JAX.  Each main path runs
with every launch count set to 0 just before it and read just after.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over `reps` calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn: `reps` calls captured in one CUDA
    graph and replayed, so the host's per-call cost (argument checks,
    allocation, the launch itself) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def u8(color):
    import torch

    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)


def frame_stats(a, b) -> dict:
    """bench.py's parity metrics between two uint8/int frames [..., 3]."""
    import torch

    d = (a.to(torch.int32) - b.to(torch.int32)).abs().amax(-1).double()
    return {
        "mean_abs_u8": float(d.mean()),
        "frac_gt_4lsb": float((d > 4).double().mean()),
        "frac_diff": float((d > 0).double().mean()),
        "max_u8": int(d.max()),
    }


def flagship_scene(tp, cfg, device):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=24))
    state = tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(256, cfg=cfg, radius=1.2, device=device),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=device),
        device=device,
    )
    return geo, state


def small_scene(tp, cfg, device):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, device=device),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=device),
        device=device,
    )


def k2_inputs(tp, state, cfg):
    """Setup + binning of one frame -> the tile renderer's arguments."""
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting, lighting_cuda
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    args = (
        binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
        fused.build_material_table(state.materials, cfg.gamma),
        lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg,
                                    lighting.inverse_view_proj(view_proj), cfg.width, cfg.height),
    )
    kw = dict(
        nty=-(-cfg.height // cfg.tile_h), ntx=-(-cfg.width // cfg.tile_w),
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
    )
    return args, kw, binned


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations counted from the kernels' sources (a multiply or add is 1, a
# fused multiply-add 2, a divide, square root or pow 1): the edge tests of
# one record at one pixel, the shading of one covered pixel without point
# lights, one point light at one covered pixel.
RASTER_OPS_PER_RECORD_PIXEL = 26
SHADE_OPS_PER_PIXEL = 130
SHADE_OPS_PER_PIXEL_LIGHT = 120
SETUP_OPS_PER_TRIANGLE = 300
SETUP_DEPTH_OPS_PER_TRIANGLE = 200
BUMP_OPS_PER_PIXEL = 150     # world from depth + bump.cuh
RESOLVE_OPS_PER_PIXEL = 100  # world from depth + view + directional GGX

# The config-4 flags (tools/bench_configs.py's config-4 row): shadows,
# procedural bump and bloom, the deferred-directional split with the
# in-kernel light cull, full-resolution PCF.
CONFIG4_FLAGS = dict(shadows=True, normal_mapping=True, bloom=True, deferred_directional=True,
                     inkernel_light_cull=True, max_lights_per_tile=128, shadow_vis_downsample=1)
# The shipped unsplit config-4 rows of the JAX package's tools: the config-4
# flags without the split and without the in-kernel cull (the depth
# prepass, per-tile light lists, the visibility plane in the tile kernel).
CONFIG4_UNSPLIT_FLAGS = {**CONFIG4_FLAGS, "deferred_directional": False, "inkernel_light_cull": False}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate, and which of them it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def per_tile_covered(depth_planes, tile_h: int, tile_w: int):
    """Covered pixels (depth < 1) per tile [NT] of a [Hp, Wp] depth plane."""
    Hp, Wp = depth_planes.shape
    return (depth_planes < 1.0).reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w).sum((1, 3)).reshape(-1)


def raster_box_pixels(counts, offs, stream, ntx: int, tile_h: int, tile_w: int) -> int:
    """The raster work these binned records need: over every (tile, valid
    record) pair, the pixel centres inside the record's box (its vertices'
    min and max) and inside its tile, computed on the card."""
    import torch

    n = counts.long()
    tiles = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rows = offs[:-1].long()[tiles] + (torch.arange(tiles.numel(), device=n.device) - first)
    rec = stream[rows]
    x, y = rec[:, 0:6:2], rec[:, 1:6:2]
    counted = []
    for lo, hi, t0, size in ((x.amin(1), x.amax(1), (tiles % ntx) * tile_w, tile_w),
                             (y.amin(1), y.amax(1), (tiles // ntx) * tile_h, tile_h)):
        c0 = torch.maximum(torch.ceil(lo - 0.5), t0.float())
        c1 = torch.minimum(torch.floor(hi - 0.5), (t0 + size - 1).float())
        counted.append(torch.nan_to_num(torch.clamp(c1 - c0 + 1.0, min=0.0), nan=0.0).double())
    return int((counted[0] * counted[1] * (rec[:, 28] > 0.0)).sum())


def tile_load(counts) -> dict:
    """Records per tile: the most, and the 99th percentile."""
    import torch

    c = counts.double()
    return {"max_records_in_a_tile": int(c.max()), "p99_records_per_tile": float(torch.quantile(c, 0.99))}


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def config1_scene(tp, cfg, device):
    """The reference's scene: cube + pyramid from the repo's OBJ assets."""
    import os

    models = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "models")
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(models, f"{m}.obj"))
                                   for m in ("cube", "pyramid")])
    return geo, tp.make_scene(geo, cfg, device=device)


def shadow_plain(state, cfg, raster: bool = True):
    """The shadow map by the plain versions on the card: depth-only setup,
    binning, depth raster -> (depth [S, S] or None, light_vp, overflow)."""
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import raster_tiles, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_depth_reference

    S = cfg.shadow_map_size
    g = state.geometry
    lvp = shadows.light_view_proj(state.lights.direction)
    scfg = shadows.shadow_bin_config(cfg, g.tri_mesh_id.shape[0])
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    tris = setup_depth_reference(g.fv_pos_cols, g.tri_mesh_id, xmath.matmul4_fma(model, lvp), S, S)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg)
    depth = None
    if raster:
        depth = raster_tiles.raster_depth_reference(
            b.counts, b.offs, b.stream, nty=-(-S // scfg.tile_h), ntx=-(-S // scfg.tile_w),
            tile_h=scfg.tile_h, tile_w=scfg.tile_w)[:S, :S]
    return depth, lvp, b.overflow


def staged_plain_chain(state, cfg, shade: bool = True):
    """The staged frame by the plain versions on the card: plain setup,
    binning, plain tile raster, [plain bump], G-buffer, Lambert or [the
    plain shadow map + PCF] + the light cull + plain lighting, post.
    Returns (uint8 frame or None, overflow, light cull or None)."""
    import torch
    from d3d12_deferred_renderer_tpu_torch.ops import bump, lighting, lighting_cuda, post, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.gbuffer import encode_gbuffer
    from d3d12_deferred_renderer_tpu_torch.ops.raster_tiles import (
        fragments_from_planes, raster_tiles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        frame_matrices, setup_triangles_reference,
    )

    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    model, view_proj, mvp = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, W, H)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    planes = raster_tiles_reference(binned.counts, binned.offs, binned.stream,
                                    nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)
    frags = fragments_from_planes(planes, H, W)
    if cfg.normal_mapping:
        n = bump.bump_tiles_reference(bump.bump_planes(frags, nty * TH, ntx * TW),
                                      bump.bump_uniforms(inv_vp, W, H), nty=nty, ntx=ntx, tile_h=TH,
                                      tile_w=TW, strength=cfg.bump_strength, freq=cfg.bump_frequency)
        frags = frags._replace(normal=n[:, :H, :W].permute(1, 2, 0))
    gb = encode_gbuffer(frags, state.materials, cfg)
    overflow, tl = binned.overflow, None
    if cfg.shading == "lambert":
        color = lighting.shade_lambert(gb, state.lights, cfg) if shade else None
        if shade and cfg.fxaa:
            color = post.fxaa(color)
    else:
        li = state.lights
        vis = None
        if cfg.shadows:
            sd, lvp, s_ovf = shadow_plain(state, cfg, raster=shade)
            if sd is None:  # overflow only: the PCF cap reads the depth alone
                sd = torch.ones((cfg.shadow_map_size,) * 2, device=gb.depth.device)
            vis, v_ovf = shadows.shadow_visibility(gb.depth, view_proj, sd, lvp, cfg,
                                                   return_overflow=True, inv_vp=inv_vp)
            overflow = overflow + s_ovf + v_ovf
        tl = lighting.cull_lights_to_tiles(
            gb.depth, li, cfg, view_proj, tile=(TH, TW),
            max_per_tile=min(li.num_point, cfg.max_live_lights_per_tile), inv_vp=inv_vp,
        )
        overflow = overflow + tl.overflow
        color = None
        if shade:
            hdr = lighting_cuda.shade_tiles_reference(
                lighting_cuda.gbuffer_planes(gb, nty * TH, ntx * TW, vis),
                lighting_cuda.build_light_table(li), tl.indices.reshape(nty * ntx, -1),
                tl.counts.reshape(-1),
                lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H),
                nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=cfg.gamma,
            )
            color = post.apply_post(hdr[:, :H, :W].permute(1, 2, 0), cfg)
    frame = post.to_uint8(color) if color is not None else None
    return frame, overflow, tl


def prepass_lists(depth_pre, state, cfg, view_proj, inv_vp):
    """The per-tile light lists of the depth prepass: the light cull on the
    tile grid, capped at min(L, max_live_lights_per_tile), the id lists
    padded to CHUNK -> (ids [NT, Lk], counts [NT], overflow)."""
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting

    L = state.lights.num_point
    tl = lighting.cull_lights_to_tiles(depth_pre, state.lights, cfg, view_proj, tile=(cfg.tile_h, cfg.tile_w),
                                       max_per_tile=min(L, cfg.max_live_lights_per_tile), inv_vp=inv_vp)
    NT = tl.counts.numel()
    return fused.pad_light_ids_to_chunk(tl.indices.reshape(NT, -1)), tl.counts.reshape(-1), tl.overflow


def fused_plain_chain(state, cfg):
    """The fused frame by the plain versions on the card: plain setup,
    binning, [the plain depth prepass, the light cull, and without the
    split the plain shadow map + PCF], the plain tile renderer and, with
    the split, the plain shadow map, PCF and plain resolve.  Returns (uint8
    frame, overflow, the tile renderer's planes)."""
    import torch.nn.functional as F
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting, lighting_cuda, raster_tiles, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        frame_matrices, setup_triangles_reference,
    )

    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    model, view_proj, mvp = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, W, H)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    li = state.lights
    L = li.num_point
    mats = fused.build_material_table(state.materials, cfg.gamma)
    u = lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H)
    ik = cfg.inkernel_light_cull and L > 0
    split = cfg.deferred_directional and cfg.shadows
    overflow = binned.overflow
    depth_pre = ids = counts = vis = None
    if (L and not ik) or (cfg.shadows and not split):
        depth_pre = raster_tiles.raster_depth_reference(binned.counts, binned.offs, binned.stream,
                                                        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)[:H, :W]
    if L and not ik:
        ids, counts, l_ovf = prepass_lists(depth_pre, state, cfg, view_proj, inv_vp)
        overflow = overflow + l_ovf
    if cfg.shadows:
        sd, lvp, s_ovf = shadow_plain(state, cfg)
        overflow = overflow + s_ovf
        if not split:
            vis, v_ovf = shadows.shadow_visibility(depth_pre, view_proj, sd, lvp, cfg, return_overflow=True,
                                                   inv_vp=inv_vp)
            overflow = overflow + v_ovf
            vis = F.pad(vis, (0, ntx * TW - W, 0, nty * TH - H), value=1.0)
    out, tovf = fused.fused_tiles_reference(
        binned.counts, binned.offs, binned.stream, fused.build_light_table(li), mats, u,
        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
        bump=(cfg.bump_strength, cfg.bump_frequency) if cfg.normal_mapping else None,
        hdr_out=cfg.bloom or split, aux=split, light_ids=ids, light_counts=counts, vis=vis,
    )
    overflow = overflow + tovf.sum()
    color = out[:3]
    if split:
        vis, v_ovf = fused.split_visibility(out, view_proj, sd, lvp, cfg, u, inv_vp)
        overflow = overflow + v_ovf
        color = fused.directional_resolve_reference(out, vis, mats, u)
    return fused.finish_frame(color, cfg, hdr=cfg.bloom or split), overflow, out


def binning_sort_keys(cfg, n_records: int) -> int:
    """The (tile, triangle) keys the sort path of ops/binning.bin_triangles
    sorts each frame: every tier's budget times its rect expansion, and the
    big tier times the tile grid."""
    nty, ntx = -(-cfg.height // cfg.tile_h), -(-cfg.width // cfg.tile_w)
    NT, T = nty * ntx, n_records
    s = max(1, round((cfg.height * cfg.width) / (1920 * 1080)))
    E = max(1, cfg.bin_expand * s)
    EM = max(E + 1, cfg.bin_expand_medium * s)
    EL = max(EM + 1, cfg.bin_expand_large * s)
    LS = T if cfg.bin_max_small < 0 else min(cfg.bin_max_small * s, T)
    keys = LS * E + min(cfg.bin_max_medium * s, T) * EM + min(cfg.bin_max_large * s, T) * EL
    return keys + (min(cfg.bin_max_big * s, T) * NT if EL < NT else 0)


def drive_path(tp, state, cfg, kernels, sweep_steps: int = 64):
    """A main path through the entry points, with every launch count set to
    0 just before it and read just after: 2 warm-up frames, a sweep of the
    whole yaw orbit in `sweep_steps` steps through render_stats, then 3
    passes of 30 step_frame calls timed by CUDA events and the host clock.
    Returns (last state, last frame, frames, launches, sweep states,
    sweep overflows, passes)."""
    import torch

    reset_launches(kernels)
    frames = 0
    for _ in range(2):  # warm-up
        state, frame = tp.step_frame(state, cfg)
        frames += 1
    sweep_states, sweep_ovf = [], []
    sweep = state
    for _ in range(sweep_steps):
        sweep = tp.animate(sweep, 2.0 * math.pi / sweep_steps, cfg)
        _, stats = tp.render_stats(sweep, cfg)
        sweep_states.append(sweep)
        sweep_ovf.append(stats["overflow"])
        frames += 1
    passes = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for _ in range(30):
            state, frame = tp.step_frame(state, cfg)
            frames += 1
        end.record()
        torch.cuda.synchronize()
        passes.append((start.elapsed_time(end) / 30, (time.perf_counter() - t_host) * 1e3 / 30))
    launches = {k.__name__: k.launches for k in kernels}
    return state, frame, frames, launches, sweep_states, [int(o) for o in torch.stack(sweep_ovf)], passes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import numpy as np

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import (
        bump, fused, lighting, lighting_cuda, post, raster_tiles, scatter, setup_cuda, shadows,
    )
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        TRI_MESH_ID, TRI_VALID, frame_matrices, setup_depth_reference, setup_frame_triangles,
        setup_triangles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    check("jax" not in sys.modules, "the port imported jax")
    wrappers = (setup_cuda.setup_triangles, fused.fused_tiles, raster_tiles.raster_tiles,
                lighting_cuda.shade_tiles, setup_cuda.setup_depth_triangles, raster_tiles.raster_depth,
                bump.bump_tiles, fused.directional_resolve, scatter.row_scatter)
    no_launch = {k.__name__: 0 for k in wrappers}

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_build.library()
    emit({
        "phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
        "nvcc_seconds": cuda_build.BuildInfo.seconds, "cached": cuda_build.BuildInfo.cached,
        "library": cuda_build.BuildInfo.path,
        "ptxas": [ln.strip() for ln in cuda_build.BuildInfo.log.splitlines()
                  if "registers" in ln or "spill" in ln],
    })

    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    geo, state0 = flagship_scene(tp, cfg, dev)
    check(geo.num_triangles == 23_906, f"flagship scene has {geo.num_triangles} triangles")
    T = geo.num_triangles
    kernels = {}

    # ---- 2. K1 against its plain version ----
    state = tp.animate(state0, cfg.yaw_per_frame, cfg)
    model, _, mvp = frame_matrices(state, cfg)
    g = state.geometry
    k1_args = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id, mvp, model,
               cfg.width, cfg.height)
    got = setup_cuda.setup_triangles(*k1_args)
    ref = setup_triangles_reference(*k1_args)
    torch.cuda.synchronize()
    gp, rp = got.packed, ref.packed
    check(gp.shape == rp.shape == (2 * geo.num_triangles, 32), f"K1 shape {tuple(gp.shape)}")
    check(torch.equal(gp[:, TRI_MESH_ID], rp[:, TRI_MESH_ID]), "K1 mesh ids differ")
    check(torch.equal(gp[:, 30:32], rp[:, 30:32]), "K1 padding differs")
    flips = int((gp[:, TRI_VALID] != rp[:, TRI_VALID]).sum())
    check(flips == 0, f"K1 valid flags differ on {flips} records")
    exact = gp == rp
    close = torch.isclose(gp, rp, rtol=2e-4, atol=2e-4)
    bad = float((~(exact | close)).double().mean())
    check(float(exact.double().mean()) > 0.9 and bad < 1e-4, f"K1 records off: bad {bad}")
    check(bool(torch.isclose(got.aabb, ref.aabb, rtol=2e-4, atol=2e-3).all()), "K1 boxes off")
    k1_err = float((gp - rp).abs().max())
    k1_ms = cuda_ms(lambda: setup_cuda.setup_triangles(*k1_args), 200)
    k1_plain_ms = cuda_ms(lambda: setup_triangles_reference(*k1_args), 20)
    k1_dev_ms = graph_ms(lambda: setup_cuda.setup_triangles(*k1_args), 50)
    emit({
        "phase": "k1", "ok": True, "records": int(gp.shape[0]),
        "valid": int(got.valid.sum()), "bit_equal_frac": float(exact.double().mean()),
        "max_abs_err": k1_err, "aabb_max_abs_err": float((got.aabb - ref.aabb).abs().max()),
        "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": k1_plain_ms,
    })
    M = mvp.shape[0]
    k1_bytes = T * (36 + 36 + 24 + 4) + 2 * M * 64 + 2 * T * (32 * 4 + 16)
    kernels["setup"] = dict(
        name="setup_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:254",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
        **bound(k1_bytes, T * SETUP_OPS_PER_TRIANGLE), library_ms=None, device_ms=k1_dev_ms,
    )

    # ---- 3. K2 against its plain version, small and full size ----
    small_cfg = dataclasses.replace(cfg, width=256, height=64)
    for label, kcfg, kstate in (
        ("256x64", small_cfg, tp.animate(small_scene(tp, small_cfg, dev), cfg.yaw_per_frame, cfg)),
        ("1920x1080", cfg, state),
    ):
        args, kw, binned = k2_inputs(tp, kstate, kcfg)
        color, tovf = fused.fused_tiles(*args, **kw)
        pcolor, ptovf, live = fused.fused_tiles_reference(*args, **kw, return_live=True)
        torch.cuda.synchronize()
        check(color.shape == (3, kw["nty"] * kcfg.tile_h, kw["ntx"] * kcfg.tile_w), "K2 shape")
        check(bool(torch.isfinite(color).all()), "K2 produced non-finite values")
        check(torch.equal(tovf, ptovf), f"K2 tile overflow differs at {label}")
        st = frame_stats(u8(color).permute(1, 2, 0), u8(pcolor).permute(1, 2, 0))
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 frame off at {label}: {st}")
        covered = float((u8(color).amax(0) > 0).double().mean())
        check(covered > 0.2, f"K2 frame nearly blank at {label}")
        err = float((color - pcolor).abs().max())
        line = {"phase": "k2", "ok": True, "size": label, "overflow": int(tovf.sum()) + int(binned.overflow),
                "covered_frac": covered, "max_abs_err": err,
                "bit_equal_frac": float((color == pcolor).double().mean()), **st}
        if label == "1920x1080":
            line["binned_pairs"] = int(binned.offs[-1])
            line.update(tile_load(binned.counts))
            line["max_live_lights_in_a_tile"] = int(live.max())
            line["ms"] = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["device_ms"] = graph_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **kw), 2)
            # The work this frame needs: the pixels inside each binned
            # record's box in its tile, every covered pixel, and every
            # covered pixel with each live light of its tile (covered pixels
            # from the tile raster kernel on the same records).
            planes = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream,
                                               **{k: kw[k] for k in ("nty", "ntx", "tile_h", "tile_w")})
            cov = per_tile_covered(planes[raster_tiles.PLANE_DEPTH], kcfg.tile_h, kcfg.tile_w)
            pairs = int(binned.counts.sum())
            box_px = raster_box_pixels(binned.counts, binned.offs, binned.stream, kw["ntx"], kcfg.tile_h,
                                       kcfg.tile_w)
            line["box_pixels"] = box_px
            k2_ops = (box_px * RASTER_OPS_PER_RECORD_PIXEL + int(cov.sum()) * SHADE_OPS_PER_PIXEL
                      + int((cov * live).sum()) * SHADE_OPS_PER_PIXEL_LIGHT)
            k2_bytes = (pairs * 128 + 4 * (2 * binned.counts.numel() + 1) + 4 * args[3].numel()
                        + 4 * args[4].numel() + 4 * args[5].numel() + 4 * color.numel() + 4 * tovf.numel())
            line["live_pixel_light_pairs"] = int((cov * live).sum())
            line.update(bound(k2_bytes, k2_ops))
            kernels["fused"] = dict(
                name="fused_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/fused.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/fused.py:157",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                **bound(k2_bytes, k2_ops), library_ms=None, device_ms=line["device_ms"],
            )
        emit(line)

    # ---- 4. K6 against its plain version: 256x64, config 1, flagship ----
    staged_cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=False)
    c1_cfg = tp.REFERENCE_CONFIG
    c1_geo, c1_state0 = config1_scene(tp, c1_cfg, dev)
    small_staged = dataclasses.replace(staged_cfg, width=256, height=64)
    for label, kcfg, kstate in (
        ("256x64", small_staged, tp.animate(small_scene(tp, small_staged, dev), 0.3, small_staged)),
        ("1280x720", c1_cfg, tp.animate(c1_state0, 0.3, c1_cfg)),
        ("1920x1080", staged_cfg, state),
    ):
        TH, TW = kcfg.tile_h, kcfg.tile_w
        kw = dict(nty=-(-kcfg.height // TH), ntx=-(-kcfg.width // TW), tile_h=TH, tile_w=TW)
        tris, _ = setup_frame_triangles(kstate, kcfg)
        binned = bin_triangles(tris.packed, tris.aabb, tris.valid, kcfg)
        model, _, mvp = frame_matrices(kstate, kcfg)
        g = kstate.geometry
        ptris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                          mvp, model, kcfg.width, kcfg.height)
        pbinned = bin_triangles(ptris.packed, ptris.aabb, ptris.valid, kcfg)
        bargs = (binned.counts, binned.offs, binned.stream)
        planes = raster_tiles.raster_tiles(*bargs, **kw)
        pplanes = raster_tiles.raster_tiles_reference(*bargs, **kw)
        torch.cuda.synchronize()
        for p in (raster_tiles.PLANE_DEPTH, raster_tiles.PLANE_MID, raster_tiles.PLANE_PAD):
            check(torch.equal(planes[p], pplanes[p]), f"K6 plane {p} not bit-equal at {label}")
        err = float((planes - pplanes).abs().max())
        check(err <= 2e-6, f"K6 normal/uv planes off by {err} at {label}")
        check(int(binned.overflow) == int(pbinned.overflow), f"K6 overflow differs at {label}")
        covered = float((planes[raster_tiles.PLANE_MID] >= 0).double().mean())
        check(covered > 0.02, f"K6 planes nearly empty at {label}")
        line = {"phase": "k6", "ok": True, "size": label, "overflow": int(binned.overflow),
                "covered_frac": covered, "max_abs_err": err,
                "bit_equal_frac": float((planes == pplanes).double().mean()),
                "binned_pairs": int(binned.counts.sum()), **tile_load(binned.counts)}
        if label == "1920x1080":
            line["ms"] = cuda_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw), 100)
            line["device_ms"] = graph_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw), 50)
            line["plain_ms"] = cuda_ms(lambda: raster_tiles.raster_tiles_reference(*bargs, **kw), 2)
            pairs = int(binned.counts.sum())
            k6_bytes = pairs * 128 + 4 * (2 * binned.counts.numel() + 1) + 4 * planes.numel()
            line["box_pixels"] = raster_box_pixels(*bargs, kw["ntx"], TH, TW)
            k6_bound = bound(k6_bytes, line["box_pixels"] * RASTER_OPS_PER_RECORD_PIXEL)
            line.update(k6_bound)
            kernels["raster"] = dict(
                name="raster_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/raster.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/raster_pallas.py:730",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"], **k6_bound, library_ms=None,
                device_ms=line["device_ms"],
            )
        emit(line)

    # ---- 5. K7 against its plain version on the flagship G-buffer ----
    H, W, TH, TW = staged_cfg.height, staged_cfg.width, staged_cfg.tile_h, staged_cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    gb = tp.render_gbuffer(state, staged_cfg)
    _, view_proj, _ = frame_matrices(state, staged_cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    li = state.lights
    tl = lighting.cull_lights_to_tiles(gb.depth, li, staged_cfg, view_proj, tile=(TH, TW),
                                       max_per_tile=min(li.num_point, staged_cfg.max_live_lights_per_tile),
                                       inv_vp=inv_vp)
    _, _, ptl = staged_plain_chain(state, staged_cfg, shade=False)
    check(torch.equal(tl.counts, ptl.counts) and torch.equal(tl.indices, ptl.indices),
          "K7 light lists of the kernel G-buffer differ from the plain chain's")
    vis_np = np.random.default_rng(11).uniform(0, 1, (H, W)).astype(np.float32)
    for label, vis in (("no_vis", None), ("vis", torch.from_numpy(vis_np).to(dev))):
        sargs = (lighting_cuda.gbuffer_planes(gb, nty * TH, ntx * TW, vis),
                 lighting_cuda.build_light_table(li), tl.indices.reshape(NT, -1), tl.counts.reshape(NT),
                 lighting_cuda.make_uniforms(state.camera.eye, li, staged_cfg, inv_vp, W, H))
        skw = dict(nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=staged_cfg.gamma)
        hdr = lighting_cuda.shade_tiles(*sargs, **skw)
        phdr = lighting_cuda.shade_tiles_reference(*sargs, **skw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(hdr).all()), f"K7 produced non-finite values ({label})")
        excess = float(((hdr - phdr).abs() - (2e-5 + 2e-4 * phdr.abs())).max())
        check(excess <= 0.0, f"K7 HDR outside rtol 2e-4, atol 2e-5 ({label}): excess {excess}")
        img = [u8(post.apply_post(h[:, :H, :W].permute(1, 2, 0), staged_cfg)) for h in (hdr, phdr)]
        st = frame_stats(*img)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K7 frame off ({label}): {st}")
        err = float((hdr - phdr).abs().max())
        cov = per_tile_covered(sargs[0][lighting_cuda.P_DEPTH], TH, TW)
        pairs = int((cov * tl.counts.reshape(NT)).sum())
        line = {"phase": "k7", "ok": True, "variant": label, "max_abs_err": err,
                "bit_equal_frac": float((hdr == phdr).double().mean()),
                "tiles_overflowing": int(tl.overflow), "max_live_lights_in_a_tile": int(tl.counts.max()),
                "covered_pixels": int(cov.sum()), "live_pixel_light_pairs": pairs, **st}
        if label == "no_vis":
            line["ms"] = cuda_ms(lambda: lighting_cuda.shade_tiles(*sargs, **skw), 100)
            line["plain_ms"] = cuda_ms(lambda: lighting_cuda.shade_tiles_reference(*sargs, **skw), 2)
            # The bytes the function needs: the depth plane at every pixel,
            # the other planes at covered pixels only (background is depth
            # alone), each tile's live ids and their light rows, the counts,
            # the uniforms and the HDR output.
            n_planes, plane = sargs[0].shape[0], sargs[0][0].numel()
            live_ids = int(tl.counts.sum())
            k7_bytes = 4 * (plane + (n_planes - 1) * int(cov.sum()) + live_ids + NT + 32
                            + hdr.numel()) + 32 * li.num_point
            k7_ops = int(cov.sum()) * SHADE_OPS_PER_PIXEL + pairs * SHADE_OPS_PER_PIXEL_LIGHT
            line.update(bound(k7_bytes, k7_ops))
            kernels["shade"] = dict(
                name="shade_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/shade.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/lighting_pallas.py:52",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                **bound(k7_bytes, k7_ops), library_ms=None,
            )
        emit(line)
    del gb, sargs, hdr, phdr, img

    # ---- 6. K4: the depth-only setup in the light's view ----
    cfg4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_FLAGS)
    S = cfg4.shadow_map_size
    lvp = shadows.light_view_proj(state.lights.direction)
    model, _, _ = frame_matrices(state, cfg4)
    k4_args = (g.fv_pos_cols, g.tri_mesh_id, xmath.matmul4_fma(model, lvp), S, S)
    got = setup_cuda.setup_depth_triangles(*k4_args)
    ref = setup_depth_reference(*k4_args)
    torch.cuda.synchronize()
    check(torch.equal(got.packed, ref.packed) and torch.equal(got.aabb, ref.aabb),
          "K4 records or boxes differ from the plain version")
    check(not bool(got.packed[:, 12:27].any()), "K4 attribute fields not zero")
    k4_ms = cuda_ms(lambda: setup_cuda.setup_depth_triangles(*k4_args), 200)
    k4_plain_ms = cuda_ms(lambda: setup_depth_reference(*k4_args), 20)
    k4_dev_ms = graph_ms(lambda: setup_cuda.setup_depth_triangles(*k4_args), 50)
    k4_bytes = T * (36 + 4) + M * 64 + 2 * T * (32 * 4 + 16)
    emit({"phase": "k4", "ok": True, "records": int(got.packed.shape[0]), "valid": int(got.valid.sum()),
          "max_abs_err": 0.0, "ms": k4_ms, "device_ms": k4_dev_ms, "plain_ms": k4_plain_ms,
          **bound(k4_bytes, T * SETUP_DEPTH_OPS_PER_TRIANGLE)})
    kernels["setup_depth"] = dict(
        name="setup_depth_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:281",
        max_abs_err=0.0, ms=k4_ms, plain_ms=k4_plain_ms,
        **bound(k4_bytes, T * SETUP_DEPTH_OPS_PER_TRIANGLE), library_ms=None, device_ms=k4_dev_ms,
    )

    # ---- 7. K3: the 1024^2 shadow map on 16 x 128 tiles; the display grid ----
    scfg = shadows.shadow_bin_config(cfg4, T)
    sb = bin_triangles(got.packed, got.aabb, got.valid, scfg)
    skw = dict(nty=S // scfg.tile_h, ntx=S // scfg.tile_w, tile_h=scfg.tile_h, tile_w=scfg.tile_w)
    sargs = (sb.counts, sb.offs, sb.stream)
    sdepth = raster_tiles.raster_depth(*sargs, **skw)
    psdepth = raster_tiles.raster_depth_reference(*sargs, **skw)
    tris, _ = setup_frame_triangles(state, staged_cfg)
    db = bin_triangles(tris.packed, tris.aabb, tris.valid, staged_cfg)
    dkw = dict(nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)
    ddepth = raster_tiles.raster_depth(db.counts, db.offs, db.stream, **dkw)
    dplanes = raster_tiles.raster_tiles(db.counts, db.offs, db.stream, **dkw)
    torch.cuda.synchronize()
    check(torch.equal(sdepth, psdepth), "K3 shadow map not bit-equal to its plain version")
    check(torch.equal(ddepth, dplanes[raster_tiles.PLANE_DEPTH]), "K3 depth differs from K6's depth plane")
    check(int(sb.overflow) == 0, f"shadow binning overflow {int(sb.overflow)}")
    shadow_cov = float((sdepth < 1.0).double().mean())
    check(shadow_cov > 0.05, f"shadow map nearly empty ({shadow_cov})")
    # The split at other work-item sizes R: the same depth.
    for R in (128, 256):
        check(torch.equal(raster_tiles.raster_depth(*sargs, **skw, records_per_block=R), psdepth),
              f"K3 shadow map at R = {R} differs from its plain version")
    k3_ms = cuda_ms(lambda: raster_tiles.raster_depth(*sargs, **skw), 100)
    k3_dev_ms = graph_ms(lambda: raster_tiles.raster_depth(*sargs, **skw), 50)
    k3_r_ms = {R: graph_ms(lambda: raster_tiles.raster_depth(*sargs, **skw, records_per_block=R), 50)
               for R in (64, 128, 256)}
    k3_plain_ms = cuda_ms(lambda: raster_tiles.raster_depth_reference(*sargs, **skw), 2)
    pre_dev_ms = graph_ms(lambda: raster_tiles.raster_depth(db.counts, db.offs, db.stream, **dkw), 50)
    spairs = int(sb.counts.sum())
    k3_bytes = spairs * 128 + 4 * (2 * sb.counts.numel() + 1) + 4 * sdepth.numel()
    s_box_px = raster_box_pixels(*sargs, skw["ntx"], scfg.tile_h, scfg.tile_w)
    k3_bound = bound(k3_bytes, s_box_px * RASTER_OPS_PER_RECORD_PIXEL)
    d_box_px = raster_box_pixels(db.counts, db.offs, db.stream, ntx, TH, TW)
    pre_bound = bound(4 * int(db.counts.sum()) * 32 + 4 * (2 * NT + 1) + 4 * ddepth.numel(),
                      d_box_px * RASTER_OPS_PER_RECORD_PIXEL)
    emit({"phase": "k3", "ok": True, "size": f"{S}x{S}", "tile": f"{scfg.tile_h}x{scfg.tile_w}",
          "binned_pairs": spairs, **tile_load(sb.counts), "box_pixels": s_box_px,
          "records_per_block": raster_tiles.DEPTH_RECORDS_PER_BLOCK,
          "tris_per_tile_cap": scfg.max_tris_per_tile, "covered_frac": shadow_cov,
          "display_grid_bit_equal_to_k6": True, "max_abs_err": 0.0, "ms": k3_ms, "device_ms": k3_dev_ms,
          "device_ms_by_records_per_block": k3_r_ms, "plain_ms": k3_plain_ms, **k3_bound,
          "prepass": {"size": f"{W}x{H}", "binned_pairs": int(db.counts.sum()), **tile_load(db.counts),
                      "box_pixels": d_box_px, "device_ms": pre_dev_ms, **pre_bound}})
    kernels["raster_depth"] = dict(
        name="raster_depth", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/raster.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/raster_pallas.py:799",
        max_abs_err=0.0, ms=k3_ms, plain_ms=k3_plain_ms, **k3_bound, library_ms=None, device_ms=k3_dev_ms,
        prepass_device_ms=pre_dev_ms, prepass_bound_ms=pre_bound["bound_ms"],
    )
    del sdepth, psdepth, ddepth

    # ---- 8. K8: the bump on the flagship frame's fragments ----
    inv_vp = lighting.inverse_view_proj(view_proj)
    bplanes = bump.bump_planes(raster_tiles.fragments_from_planes(dplanes, H, W), nty * TH, ntx * TW)
    bargs = (bplanes, bump.bump_uniforms(inv_vp, W, H))
    bkw = dict(nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, strength=cfg4.bump_strength, freq=cfg4.bump_frequency)
    bn = bump.bump_tiles(*bargs, **bkw)
    pbn = bump.bump_tiles_reference(*bargs, **bkw)
    torch.cuda.synchronize()
    k8_err = float((bn - pbn).abs().max())
    check(k8_err <= 1e-6, f"K8 normals off by {k8_err} (bound 1e-6)")
    moved = float((bn != bplanes[1:4]).any(0).double().mean())
    check(moved > 0.1, f"K8 perturbed only {moved} of the pixels")
    k8_ms = cuda_ms(lambda: bump.bump_tiles(*bargs, **bkw), 100)
    k8_plain_ms = cuda_ms(lambda: bump.bump_tiles_reference(*bargs, **bkw), 5)
    k8_dev_ms = graph_ms(lambda: bump.bump_tiles(*bargs, **bkw), 50)
    # The bytes the function needs: the mesh id and the normal at every
    # pixel (a background or out-of-frame pixel keeps its normal), depth, u
    # and v at covered in-frame pixels only (padding has mesh id -1), the
    # normals out and the uniforms.
    plane8 = bplanes[bump.B_MID].numel()
    cov8 = int((bplanes[bump.B_MID] >= 0).sum())
    k8_bytes = 4 * (4 * plane8 + 3 * cov8 + bn.numel() + 32)
    k8_bound = bound(k8_bytes, cov8 * BUMP_OPS_PER_PIXEL)
    emit({"phase": "k8", "ok": True, "max_abs_err": k8_err,
          "bit_equal_frac": float((bn == pbn).double().mean()), "perturbed_frac": moved,
          "covered_pixels": cov8, "ms": k8_ms, "device_ms": k8_dev_ms, "plain_ms": k8_plain_ms, **k8_bound})
    kernels["bump"] = dict(
        name="bump_tiles", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/bump.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/bump.py:196",
        max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain_ms, **k8_bound, library_ms=None, device_ms=k8_dev_ms,
    )
    del bplanes, bargs, bn, pbn

    # ---- 9. K2's config-4 variant: bump + linear HDR + the split's planes ----
    args, kw, binned = k2_inputs(tp, state, cfg4)
    kw.update(bump=(cfg4.bump_strength, cfg4.bump_frequency), hdr_out=True, aux=True)
    out4, tovf4 = fused.fused_tiles(*args, **kw)
    pout4, ptovf4 = fused.fused_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(tovf4, ptovf4), "K2 variant tile overflow differs")
    check(torch.equal(out4[3], dplanes[raster_tiles.PLANE_DEPTH]), "K2 variant depth differs from K6's")
    check(torch.equal(out4[7], dplanes[raster_tiles.PLANE_MID]), "K2 variant mesh ids differ from K6's")
    # The bumped, quantized and decoded normals (planes 4-6) feed the lit
    # mask and K5: bit-equal to the plain version's, as K8's normals are.
    aux_err = float((out4[3:8] - pout4[3:8]).abs().max())
    check(aux_err == 0.0, f"K2 variant aux planes (depth, normal, mesh id) off the plain version's by {aux_err}"
                          f" (elements off per plane: {(out4[3:8] != pout4[3:8]).sum((1, 2)).tolist()})")
    st = frame_stats(*(u8(post.gamma_encode(post.reinhard(o[:3, :H, :W]), cfg4.gamma)).permute(1, 2, 0)
                       for o in (out4, pout4)))
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 variant frame off: {st}")
    k2v_ms = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    k2v_dev_ms = graph_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    emit({"phase": "k2v", "ok": True, "variant": "bump+hdr_out+aux", "max_abs_err": float((out4 - pout4).abs().max()),
          "aux_max_abs_err": aux_err, "aux_depth_mid_bit_equal_to_k6": True, "overflow": int(tovf4.sum()),
          "ms": k2v_ms, "device_ms": k2v_dev_ms, **st})
    del dplanes

    # ---- 10. K5: the directional resolve on the k2v planes (the kernel's
    # aux planes, bit-equal to the plain version's as checked above) ----
    u4 = args[5]
    sd4, lvp4, _ = shadow_plain(state, cfg4)
    vis4, _ = fused.split_visibility(out4, view_proj, sd4, lvp4, cfg4, u4, inv_vp)
    rargs = (out4, vis4, args[4], u4)
    rhdr = fused.directional_resolve(*rargs)
    prhdr = fused.directional_resolve_reference(*rargs)
    torch.cuda.synchronize()
    excess = float(((rhdr - prhdr).abs() - (2e-5 + 2e-4 * prhdr.abs())).max())
    check(excess <= 0.0, f"K5 HDR outside rtol 2e-4, atol 2e-5: excess {excess}")
    st = frame_stats(*(u8(post.gamma_encode(post.reinhard(h[:, :H, :W]), cfg4.gamma)).permute(1, 2, 0)
                       for h in (rhdr, prhdr)))
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K5 frame off: {st}")
    k5_err = float((rhdr - prhdr).abs().max())
    k5_ms = cuda_ms(lambda: fused.directional_resolve(*rargs), 100)
    k5_plain_ms = cuda_ms(lambda: fused.directional_resolve_reference(*rargs), 5)
    k5_dev_ms = graph_ms(lambda: fused.directional_resolve(*rargs), 50)
    # The bytes the function needs: depth and the HDR at every pixel, the
    # normal, mesh id and visibility at covered pixels, the HDR out.
    cov5 = int((out4[3] < 1.0).sum())
    k5_bytes = 4 * (4 * out4[3].numel() + 5 * cov5 + 3 * out4[3].numel() + 64 + 32)
    emit({"phase": "k5", "ok": True, "max_abs_err": k5_err, "bit_equal_frac": float((rhdr == prhdr).double().mean()),
          "covered_pixels": cov5, "ms": k5_ms, "device_ms": k5_dev_ms, "plain_ms": k5_plain_ms,
          **bound(k5_bytes, cov5 * RESOLVE_OPS_PER_PIXEL), **st})
    kernels["resolve"] = dict(
        name="directional_resolve", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/resolve.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/fused.py:445",
        max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms,
        **bound(k5_bytes, cov5 * RESOLVE_OPS_PER_PIXEL), library_ms=None, device_ms=k5_dev_ms,
    )
    del out4, pout4, rhdr, prhdr, rargs, args, vis4

    # ---- 11. K2 fed by the depth prepass's per-tile light lists ----
    lcfg = dataclasses.replace(cfg, inkernel_light_cull=False)
    args, kw, binned = k2_inputs(tp, state, lcfg)
    grid = {k: kw[k] for k in ("nty", "ntx", "tile_h", "tile_w")}
    bargs = (binned.counts, binned.offs, binned.stream)
    depth_pre = raster_tiles.raster_depth(*bargs, **grid)
    kplanes = raster_tiles.raster_tiles(*bargs, **grid)
    check(torch.equal(depth_pre, kplanes[raster_tiles.PLANE_DEPTH]), "prepass depth differs from K6's depth plane")
    ids, counts, l_ovf = prepass_lists(depth_pre[:H, :W], state, lcfg, view_proj, inv_vp)
    c4u = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_UNSPLIT_FLAGS)
    vis_u, v_ovf = shadows.shadow_visibility(depth_pre[:H, :W], view_proj, sd4, lvp4, c4u, return_overflow=True,
                                             inv_vp=inv_vp)
    vis_u = torch.nn.functional.pad(vis_u, (0, ntx * TW - W, 0, nty * TH - H), value=1.0)
    check(int(l_ovf) == 0 and int(v_ovf) == 0, f"prepass lists or PCF overflow: {int(l_ovf)}, {int(v_ovf)}")
    bump4 = (cfg4.bump_strength, cfg4.bump_frequency)
    lkw = dict(kw, ik_slots=0, light_ids=ids, light_counts=counts)
    k2l_variants = {
        "lists": lkw,
        "lists+vis": dict(lkw, vis=vis_u),
        "lists+vis+bump+hdr_out": dict(lkw, vis=vis_u, bump=bump4, hdr_out=True),
        "lists+bump+aux": dict(lkw, bump=bump4, aux=True),
    }
    cov_l = per_tile_covered(depth_pre, TH, TW)
    pairs = int(binned.counts.sum())
    live_pairs = int((cov_l * counts).sum())
    k2l_ops = (raster_box_pixels(*bargs, ntx, TH, TW) * RASTER_OPS_PER_RECORD_PIXEL
               + int(cov_l.sum()) * SHADE_OPS_PER_PIXEL + live_pairs * SHADE_OPS_PER_PIXEL_LIGHT)
    ik_ms = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    k2l_ms, k2l_dev_ms = {}, {}
    for label, vkw in k2l_variants.items():
        lout, lovf = fused.fused_tiles(*args, **vkw)
        plout, plovf = fused.fused_tiles_reference(*args, **vkw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lout).all()), f"K2 {label} produced non-finite values")
        check(torch.equal(lovf, plovf) and not bool(lovf.any()), f"K2 {label} tile overflow not 0")
        hdr = vkw.get("hdr_out") or vkw.get("aux")
        img = [o[:3, :H, :W] for o in (lout, plout)]
        if hdr:
            img = [post.gamma_encode(post.reinhard(o), cfg.gamma) for o in img]
        st = frame_stats(*(u8(o).permute(1, 2, 0) for o in img))
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 {label} frame off: {st}")
        line = {"phase": "k2l", "ok": True, "variant": label, "max_abs_err": float((lout - plout).abs().max()),
                "bit_equal_frac": float((lout == plout).double().mean()), **st}
        if vkw.get("aux"):
            check(torch.equal(lout[3], kplanes[raster_tiles.PLANE_DEPTH])
                  and torch.equal(lout[7], kplanes[raster_tiles.PLANE_MID]), f"K2 {label}: depth or mesh id != K6's")
            aux_err = float((lout[3:8] - plout[3:8]).abs().max())
            check(aux_err == 0.0, f"K2 {label} aux planes off the plain version's by {aux_err}")
            line["aux_depth_mid_bit_equal_to_k6"] = True
        line["ms"] = k2l_ms[label] = cuda_ms(lambda: fused.fused_tiles(*args, **vkw), 50)
        line["device_ms"] = k2l_dev_ms[label] = graph_ms(lambda: fused.fused_tiles(*args, **vkw), 50)
        # The bytes the function needs: the in-kernel cull's, plus the lists
        # and counts and, with it, the visibility plane; the same operations
        # over this frame's live pixel-light pairs.
        k2l_bytes = (pairs * 128 + 4 * (2 * NT + 1) + 4 * (args[3].numel() + args[4].numel() + args[5].numel())
                     + 4 * (ids.numel() + NT) + (4 * vis_u.numel() if "vis" in vkw else 0)
                     + 4 * lout.numel() + 4 * NT)
        line.update(bound(k2l_bytes, k2l_ops))
        if label == "lists":
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **vkw), 2)
            line["in_kernel_cull_ms"] = ik_ms
            line["lists_shape"] = list(ids.shape)
            line["max_live_lights_in_a_tile"] = int(counts.max())
            line["live_pixel_light_pairs"] = live_pairs
            kernels["fused"]["list_fed"] = dict(ms=line["ms"], device_ms=line["device_ms"], plain_ms=line["plain_ms"],
                                                in_kernel_cull_ms=ik_ms, **bound(k2l_bytes, k2l_ops))
        emit(line)
    kernels["fused"]["variants_ms"] = k2l_ms
    kernels["fused"]["variants_device_ms"] = k2l_dev_ms
    del args, lout, plout, kplanes, depth_pre, vis_u, sd4
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t_start})

    total_launches = {k.__name__: 0 for k in wrappers}

    # ---- 6. the main path: the fused flagship frame ----
    torch.cuda.reset_peak_memory_stats()
    state, frame, frames, launches, _, sweep_ovf, passes = drive_path(tp, state0, cfg, wrappers)
    sweep_max = max(sweep_ovf)
    check(sweep_max == 0, f"overflow {sweep_max} on the yaw orbit sweep")
    main_kernels = ("setup_triangles", "fused_tiles")
    check(all(launches[k] == frames for k in main_kernels),
          f"launch counts {launches} != {frames} frames")
    for k, n in launches.items():
        total_launches[k] += n

    check(frame.shape == (cfg.height, cfg.width, 3) and frame.dtype == torch.uint8, "frame shape")
    covered = float((frame.amax(-1) > 0).double().mean())
    check(covered > 0.2, f"main-path frame nearly blank ({covered})")
    # The last frame against the plain chain (plain setup, binning, plain
    # tile renderer) on the same state.
    L = state.lights.num_point
    plain_frame, _, _ = fused_plain_chain(state, cfg)
    st = frame_stats(frame, plain_frame)
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"main-path frame vs plain chain: {st}")
    best = min(p[0] for p in passes)
    emit({
        "phase": "main", "ok": True, "resolution": f"{cfg.width}x{cfg.height}",
        "triangles": geo.num_triangles, "lights": L, "frames": frames,
        "sweep_steps": 64, "sweep_max_overflow": sweep_max,
        "launches": {k: launches[k] for k in main_kernels},
        "covered_frac": covered, "vs_plain_chain": st,
        "ms_per_frame": best, "fps": 1e3 / best,
        "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
    })

    # ---- 7. the staged frame: config 1 and the staged flagship ----
    for label, scfg, sstate0 in (("config1", c1_cfg, c1_state0), ("staged_flagship", staged_cfg, state0)):
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, sweep_states, sweep_ovf, passes = drive_path(
            tp, sstate0, scfg, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        pbr = scfg.shading == "pbr"
        expect = {**no_launch, "setup_triangles": frames, "raster_tiles": frames,
                  "shade_tiles": frames if pbr else 0}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        line = {"phase": "staged", "ok": True, "config": label,
                "resolution": f"{scfg.width}x{scfg.height}", "shading": scfg.shading,
                "triangles": int(sstate.geometry.tri_mesh_id.numel()),
                "lights": sstate.lights.num_point, "frames": frames, "launches": launches,
                "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf)}
        if not pbr:
            check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        # The overflow of the plain chain at every 4th step of the sweep.
        sampled = list(range(3, len(sweep_states), 4))
        plain_ovf = [int(staged_plain_chain(sweep_states[i], scfg, shade=False)[1]) for i in sampled]
        kernel_ovf = [sweep_ovf[i] for i in sampled]
        check(plain_ovf == kernel_ovf, f"{label}: overflow {kernel_ovf} != plain chain's {plain_ovf}")
        line["sampled_steps"] = sampled
        line["sampled_overflow"] = kernel_ovf
        if pbr:
            # Live lights per tile over the whole orbit, uncapped, from the
            # kernel path's depth (bit-equal to the plain raster's).
            per_step = []
            for s in sweep_states:
                sgb = tp.render_gbuffer(s, scfg)
                _, svp, _ = frame_matrices(s, scfg)
                stl = lighting.cull_lights_to_tiles(sgb.depth, s.lights, scfg, svp,
                                                    tile=(scfg.tile_h, scfg.tile_w),
                                                    max_per_tile=s.lights.num_point)
                per_step.append(stl.counts.max())
            per_step = [int(c) for c in torch.stack(per_step)]
            line["orbit_max_live_lights_per_tile"] = max(per_step)
            line["live_light_cap"] = min(sstate.lights.num_point, scfg.max_live_lights_per_tile)
            line["steps_over_cap"] = sum(c > line["live_light_cap"] for c in per_step)
        check(sframe.shape == (scfg.height, scfg.width, 3) and sframe.dtype == torch.uint8,
              f"{label}: frame shape")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.02, f"{label}: frame nearly blank ({covered})")
        pframe, _, _ = staged_plain_chain(sstate, scfg)
        st = frame_stats(sframe, pframe)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        line.update({
            "covered_frac": covered, "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
            "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
            "peak_mem_mib": peak_mib,
        })
        emit(line)

    # ---- 13. config 4: the fused frame with the split, and the staged frame ----
    for label, fused_path in (("config4_fused_split", True), ("config4_staged", False)):
        c4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=fused_path, **CONFIG4_FLAGS)
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, sweep_states, sweep_ovf, passes = drive_path(
            tp, state0, c4, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        common = {"setup_triangles": frames, "setup_depth_triangles": frames, "raster_depth": frames}
        if fused_path:
            expect = {**no_launch, **common, "fused_tiles": frames, "directional_resolve": frames}
        else:
            expect = {**no_launch, **common, "raster_tiles": frames, "bump_tiles": frames,
                      "shade_tiles": frames}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        line = {"phase": "config4", "ok": True, "config": label,
                "resolution": f"{c4.width}x{c4.height}", "shadow_map": c4.shadow_map_size,
                "triangles": T, "lights": sstate.lights.num_point, "frames": frames,
                "launches": {k: n for k, n in launches.items() if n},
                "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
                "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf)}
        if not fused_path:
            sampled = list(range(3, len(sweep_states), 4))
            plain_ovf = [int(staged_plain_chain(sweep_states[i], c4, shade=False)[1]) for i in sampled]
            kernel_ovf = [sweep_ovf[i] for i in sampled]
            check(plain_ovf == kernel_ovf, f"{label}: overflow {kernel_ovf} != plain chain's {plain_ovf}")
            line["sampled_steps"], line["sampled_overflow"] = sampled, kernel_ovf
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        pframe = (fused_plain_chain(sstate, c4) if fused_path else staged_plain_chain(sstate, c4))[0]
        st = frame_stats(sframe, pframe)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        line.update({
            "covered_frac": covered, "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
            "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
            "peak_mem_mib": peak_mib,
        })
        emit(line)

    # ---- 16. the fused frame with the depth prepass: the flagship without
    # the in-kernel cull, config 4 without the split (the visibility plane) ----
    for label, pcfg in (
        ("fused_listfed", dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, inkernel_light_cull=False)),
        ("config4_fused_unsplit", dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_UNSPLIT_FLAGS)),
    ):
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, _, sweep_ovf, passes = drive_path(tp, state0, pcfg, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        expect = {**no_launch, "setup_triangles": frames, "raster_depth": frames, "fused_tiles": frames}
        if pcfg.shadows:  # the shadow map: depth-only setup and a second depth raster
            expect.update(setup_depth_triangles=frames, raster_depth=2 * frames)
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        st = frame_stats(sframe, fused_plain_chain(sstate, pcfg)[0])
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        emit({"phase": "prepass", "ok": True, "config": label, "resolution": f"{pcfg.width}x{pcfg.height}",
              "triangles": T, "lights": sstate.lights.num_point, "frames": frames,
              "launches": {k: n for k, n in launches.items() if n},
              "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
              "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf), "covered_frac": covered,
              "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
              "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
              "peak_mem_mib": peak_mib})

    # ---- 17. calibrate: autotune_shadow on the split config 4, autotune on
    # the colonnade scene (tools/bench_configs.py's two calibrated rows) ----
    c4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_FLAGS)
    cgeo = tp.build_scene_geometry(tp.procedural.colonnade_meshes())
    ccfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    cstate0 = tp.make_scene(
        cgeo, ccfg, lights=tp.random_point_lights(256, cfg=ccfg, radius=1.2, device=dev), placement="origin",
        materials=tp.Materials.varied(cgeo.num_meshes, device=dev), device=dev)
    for label, tune, tcfg, tstate0 in (("config4_autotune_shadow", tp.autotune_shadow, c4, state0),
                                      ("colonnade_autotune", tp.autotune, ccfg, cstate0)):
        t0 = time.perf_counter()
        cal, rep = tune(tstate0, tcfg)
        tune_s = time.perf_counter() - t0
        n_rec = 2 * int(tstate0.geometry.tri_mesh_id.numel())
        line = {"phase": "calibrate", "ok": True, "config": label, "tune_seconds": tune_s,
                "triangles": n_rec // 2, "report": rep}
        if label == "config4_autotune_shadow":
            scfg_def = shadows.shadow_bin_config(tcfg, n_rec // 2)
            scfg_cal = shadows.shadow_bin_config(cal, n_rec // 2)
            line["sort_keys"] = {"default_tiers": binning_sort_keys(scfg_def, n_rec),
                                 "calibrated": binning_sort_keys(scfg_cal, n_rec)}
            # The calibrated tiers bin the same records: the same shadow map.
            sd_def, _ = shadows.render_shadow_map(tstate0, tcfg)
            sd_cal, _ = shadows.render_shadow_map(tstate0, cal)
            check(torch.equal(sd_def, sd_cal), f"{label}: calibrated shadow map differs from the default tiers'")
            expect_k = {"setup_triangles": 1, "setup_depth_triangles": 1, "raster_depth": 1, "fused_tiles": 1,
                        "directional_resolve": 1}
        else:
            line["sort_keys"] = {"flagship_tiers": binning_sort_keys(tcfg, n_rec),
                                 "calibrated": binning_sort_keys(cal, n_rec)}
            expect_k = {"setup_triangles": 1, "fused_tiles": 1}
        print(f"{label}: {json.dumps(rep)}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        # A 16-step sweep keeps the script's time down; the prepass paths
        # above sweep the whole 64.
        sstate, sframe, frames, launches, _, sweep_ovf, passes = drive_path(tp, tstate0, cal, wrappers,
                                                                            sweep_steps=16)
        expect = {**no_launch, **{k: n * frames for k, n in expect_k.items()}}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        if label == "colonnade_autotune":
            st = frame_stats(sframe, fused_plain_chain(sstate, cal)[0])
            check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
            line["vs_plain_chain"] = st
        best = min(p[0] for p in passes)
        line.update({"frames": frames, "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
                     "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf), "covered_frac": covered,
                     "ms_per_frame": best, "fps": 1e3 / best, "passes_device_ms": [p[0] for p in passes],
                     "passes_host_ms": [p[1] for p in passes],
                     "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20})
        emit(line)

    # ---- 14. bench.py's parity blocks: fused against staged at 256x64 ----
    pgeo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4))
    parity = {}
    for pname, extras in (("pbr", {}), ("config4", {k: CONFIG4_FLAGS[k] for k in (
            "shadows", "normal_mapping", "bloom", "deferred_directional", "inkernel_light_cull")})):
        pcfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True, **extras)
        pstate = tp.make_scene(
            pgeo, pcfg, lights=tp.random_point_lights(16, cfg=pcfg, radius=1.2, device=dev),
            placement="grid", materials=tp.Materials.varied(pgeo.num_meshes, device=dev), device=dev)
        f_fused, o_fused = tp.render_stats(pstate, pcfg)
        f_staged, o_staged = tp.render_stats(pstate, dataclasses.replace(pcfg, fused=False))
        st = frame_stats(f_fused, f_staged)
        parity[pname] = {k: st[k] for k in ("mean_abs_u8", "frac_gt_4lsb", "max_u8", "frac_diff")}
        parity[pname]["overflow"] = [int(o_fused["overflow"]), int(o_staged["overflow"])]
        check(st["mean_abs_u8"] <= 1.0 and st["frac_gt_4lsb"] <= 0.02, f"parity {pname}: {st}")
    emit({"phase": "parity", "ok": True, "size": "256x64", **parity})

    # ---- 18. K9: the row scatter, at the TPU tool's sizes and at the
    # flagship binning's sort-key count ----
    n_keys = binning_sort_keys(cfg, 2 * T)
    k9_launches = 0
    for n in (4096, 8192, n_keys):
        gen = torch.Generator().manual_seed(n)
        idx = torch.randperm(n, generator=gen).to(torch.int32).to(dev)
        val = torch.randint(0, 1 << 30, (n, 128), generator=gen, dtype=torch.int32).to(dev)
        got = scatter.row_scatter(idx, val)
        ref = scatter.row_scatter_reference(idx, val)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K9 differs from its plain version at n = {n}")
        # The scatter's own run: launches counted from 0 over the timing.
        # call_ms times calls back to back (the wrapper's host work
        # included); ms replays them from a CUDA graph (device time).
        scatter.row_scatter.launches = 0
        k9_call_ms = cuda_ms(lambda: scatter.row_scatter(idx, val), 200)
        k9_launches += scatter.row_scatter.launches
        check(scatter.row_scatter.launches == 201, f"K9 launches {scatter.row_scatter.launches} != 201")
        out, idx_l = torch.empty_like(val), idx.long()
        keys = torch.randint(0, 1 << 40, (n,), generator=gen, dtype=torch.int64).to(dev)
        fns = {"kernel": lambda: scatter.row_scatter(idx, val),
               "plain": lambda: scatter.row_scatter_reference(idx, val),
               "index_copy_": lambda: out.index_copy_(0, idx_l, val), "sort": lambda: torch.sort(keys)}
        dev_ms = {k: graph_ms(f, 50) for k, f in fns.items()}
        k9_ms, k9_plain_ms, k9_lib_ms = dev_ms["kernel"], dev_ms["plain"], dev_ms["index_copy_"]
        k9_bound = bound(2 * n * 512 + 4 * n, 0)
        emit({"phase": "k9", "ok": True, "rows": n, "bit_equal": True, "ms": k9_ms, "ns_per_row": k9_ms * 1e6 / n,
              "call_ms": k9_call_ms, "plain_ms": k9_plain_ms, "library_ms": k9_lib_ms, "library": "index_copy_",
              "torch_sort_int64_ms": dev_ms["sort"], "torch_sort_ns_per_key": dev_ms["sort"] * 1e6 / n,
              "timing": "device ms per call, 50 calls replayed from one CUDA graph", **k9_bound})
    kernels["scatter"] = dict(
        name="row_scatter", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/scatter.cu",
        replaces="tools/ubench_pallas_scatter.py:39", launches=k9_launches, max_abs_err=0.0, ms=k9_ms,
        device_ms=k9_ms, plain_ms=k9_plain_ms, **k9_bound, library_ms=k9_lib_ms, rows=n_keys,
    )

    for key, name in (("setup", "setup_triangles"), ("fused", "fused_tiles"),
                      ("raster", "raster_tiles"), ("shade", "shade_tiles"),
                      ("setup_depth", "setup_depth_triangles"), ("raster_depth", "raster_depth"),
                      ("bump", "bump_tiles"), ("resolve", "directional_resolve")):
        kernels[key]["launches"] = total_launches[name]
        check(total_launches[name] > 0, f"{name} never launched on the main paths")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("device_ms", "list_fed", "variants_ms", "variants_device_ms", "rows", "prepass_device_ms", "prepass_bound_ms")
    emit({"kernels": [{**{k: kernels[n][k] for k in keys}, **{k: kernels[n][k] for k in extra if k in kernels[n]}}
                      for n in ("setup", "fused", "raster", "shade", "setup_depth", "raster_depth", "bump",
                                "resolve", "scatter")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
