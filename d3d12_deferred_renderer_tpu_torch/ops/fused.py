"""Fused tiled-deferred frame: raster -> G-buffer -> light cull -> shading ->
tonemap, one kernel launch, the G-buffer never leaves the chip.

The counterpart of d3d12_deferred_renderer_tpu/ops/fused.py for the flagship
branch of ``render_fused`` (PBR, in-kernel light culling, no shadows, bump,
bloom, FXAA or split).  Per screen tile (8 x 128 pixels):

1. rasterize the tile's binned records in submission order (ops/raster_ref
   rules: pixel centers, top-left fill, depth LESS, [0, 1] depth clip,
   perspective-correct normal);
2. cull every point light EXACTLY against the tile's geometry: covered
   pixels split at the midpoint dmid = (dmin + dmax) / 2 of their squared
   eye distance into two slabs, each slab's world AABB (+-3e38 when empty),
   and a light is live iff its influence sphere (dist^2 <= r^2) touches
   either box; live ids compact in ascending order into
   ``ik_slots = ceil(min(max_live_lights_per_tile, L) / 16) * 16`` slots, and a
   tile with more live lights adds one to the overflow count;
3. quantize the normal to 10 bits and decode it, look the material up by the
   winning mesh id (-1 is background and shades to 0);
4. ambient + directional GGX + the point-light GGX loop over the live ids,
   then Reinhard and gamma.

``fused_tiles_reference`` is the plain PyTorch version of the tile kernel
(csrc/fused.cu) over [tiles, pixels] tensors; ``fused_tiles`` is the wrapper
that runs the kernel on CUDA tensors and the plain version on CPU tensors.
Step 1 is the tile raster of ops/raster_tiles.py and step 4 the shading of
ops/lighting_cuda.py, in plain PyTorch and in the kernels alike
(csrc/raster.cuh, csrc/shade.cuh).
"""
from __future__ import annotations

import torch

from ..config import RendererConfig
from ..scene import Materials, SceneState
from .binning import CHUNK, bin_triangles
from .gbuffer import quantize_unorm
from .lighting import inverse_view_proj
from .lighting_cuda import (
    U_EYE, U_SIZE, U_TONEMAP, build_light_table, dot3, make_uniforms,
    shade_pixels_reference, world_from_depth,
)
from .raster_tiles import raster_tile_pixels, tile_pixels, tiles_to_image
from .transform import TRI_STRIDE, setup_frame_triangles

BIG = 3.0e38  # empty-slab bound: every light distance to it overflows to inf

F32 = torch.float32


def build_material_table(mats: Materials, gamma: float) -> torch.Tensor:
    """[max(M, 8), 8] material rows with the G-buffer quantization and the
    sRGB decode baked in: albedo 8-bit then ^gamma, metalness 8-bit,
    roughness 2-bit (0.5 becomes 2/3)."""
    M = mats.albedo.shape[0]
    alb_q = torch.round(torch.clamp(mats.albedo, 0.0, 1.0) * 255.0) / 255.0
    alb_lin = torch.pow(torch.clamp(alb_q, min=0.0), gamma)
    metal_q = torch.round(torch.clamp(mats.metalness, 0.0, 1.0) * 255.0) / 255.0
    rough_q = torch.round(torch.clamp(mats.roughness, 0.0, 1.0) * 3.0) / 3.0
    t = torch.zeros((max(M, 8), 8), dtype=F32, device=mats.albedo.device)
    t[:M, 0:3] = alb_lin
    t[:M, 3] = metal_q
    t[:M, 4] = rough_q
    return t


def build_uniforms(state: SceneState, cfg: RendererConfig, view_proj) -> torch.Tensor:
    """The kernel's [32] uniforms for a whole cfg frame."""
    return make_uniforms(state.camera.eye, state.lights, cfg, inverse_view_proj(view_proj),
                         cfg.width, cfg.height)


def live_light_slots(cfg: RendererConfig, n_lights: int) -> int:
    """Compaction slots per tile: the live-light budget rounded up to CHUNK."""
    if n_lights == 0:
        return 0
    return -(-min(cfg.max_live_lights_per_tile, n_lights) // CHUNK) * CHUNK


# --------------------------------------------------------------------------
# Plain version of the tile kernel
# --------------------------------------------------------------------------


def fused_tiles_reference(
    counts, offs, stream, lights, mats, uniforms, *,
    nty, ntx, tile_h, tile_w, n_lights, ik_slots, gamma, return_live=False,
):
    """Plain version of the fused tile kernel.

    counts [NT] int32, offs [NT + 1] int32, stream [R, 32] f32 (tile t's
    records are rows offs[t] .. offs[t] + counts[t]), lights [>= L, 8],
    mats [>= 8, 8], uniforms [32].  Returns (color [3, Hp, Wp] f32 after
    tonemap and gamma, tile_overflow [NT] int32), and with return_live the
    live-light count of each tile [NT] as a third element: the in-kernel
    cull's own counts, which the kernel's work bound (chip_smoke.py) needs
    and no other function computes."""
    dev = stream.device
    NT = nty * ntx
    px, py = tile_pixels(nty, ntx, tile_h, tile_w, dev)
    u = uniforms

    # ---- raster (ops/raster_tiles, without the uv planes) ----
    frags = raster_tile_pixels(counts, offs, stream, px, py, uv=False)
    depth, nrm, mid = frags.depth, frags.normal, frags.mesh_id
    covered = mid >= 0.0

    # ---- exact in-kernel light cull: two eye-distance slabs per tile ----
    world = world_from_depth(u, px, py, depth)
    eye = [u[U_EYE + i] for i in range(3)]
    d = [world[i] - eye[i] for i in range(3)]
    d2 = dot3(d, d)
    big = torch.full_like(d2, BIG)
    dmin = torch.where(covered, d2, big).amin(1, keepdim=True)
    dmax = torch.where(covered, d2, -big).amax(1, keepdim=True)
    dmid = 0.5 * (dmin + dmax)
    lt = lights[:n_lights]
    r2 = lt[:, 3] * lt[:, 3]
    live = torch.zeros((NT, n_lights), dtype=torch.bool, device=dev)
    for m in (covered & (d2 <= dmid), covered & (d2 > dmid)):
        dist2 = None
        for i in range(3):
            bn = torch.where(m, world[i], big).amin(1, keepdim=True)
            bx = torch.where(m, world[i], -big).amax(1, keepdim=True)
            li = lt[:, i][None, :]
            dd = torch.clamp(torch.maximum(bn - li, li - bx), min=0.0)
            dist2 = dd * dd if dist2 is None else dist2 + dd * dd
        live = live | (dist2 <= r2[None, :])
    cnt = live.sum(1)
    tile_overflow = (cnt > ik_slots).to(torch.int32)
    n_live = torch.clamp(cnt, max=ik_slots)
    lid = torch.arange(n_lights, device=dev)
    ids = torch.sort(torch.where(live, lid, n_lights + lid), dim=1).values[:, :ik_slots] % max(n_lights, 1)

    # ---- materials by winning mesh id; G-buffer normal round trip ----
    mrow = torch.clamp(mid, min=0.0).long()
    mat = torch.where(covered[..., None], mats[mrow], torch.zeros((), dtype=F32, device=dev))
    alb = [mat[..., c] for c in range(3)]
    metal, rough = mat[..., 3], mat[..., 4]
    nlen = torch.sqrt(dot3(nrm, nrm))
    inv_nlen = 1.0 / torch.where(nlen == 0.0, torch.ones_like(nlen), nlen)
    zero = torch.zeros_like(nlen)
    enc = [quantize_unorm(torch.where(covered, c * inv_nlen, zero) * 0.5 + 0.5, 10) for c in nrm]
    dec = [e * 2.0 - 1.0 for e in enc]
    dlen = torch.sqrt(dot3(dec, dec))
    inv_dlen = 1.0 / torch.where(dlen == 0.0, torch.ones_like(dlen), dlen)
    n = [c * inv_dlen for c in dec]

    # ---- shading (ops/lighting_cuda), tonemap, gamma ----
    hdr = shade_pixels_reference(u, depth, world, n, alb, metal, rough, lights, ids, n_live)
    out = []
    for o in hdr:
        o = torch.where(u[U_TONEMAP] > 0.5, o / (1.0 + o), o)
        out.append(torch.pow(torch.clamp(o, min=0.0), 1.0 / gamma))
    color = tiles_to_image(torch.stack(out), nty, ntx, tile_h, tile_w)
    if return_live:
        return color, tile_overflow, n_live.to(torch.int32)
    return color, tile_overflow


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------


def fused_tiles(
    counts, offs, stream, lights, mats, uniforms, *,
    nty, ntx, tile_h, tile_w, n_lights, ik_slots, gamma,
):
    """Fused tile renderer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see fused_tiles_reference for the contract)."""
    kw = dict(nty=nty, ntx=ntx, tile_h=tile_h, tile_w=tile_w,
              n_lights=n_lights, ik_slots=ik_slots, gamma=gamma)
    if stream.device.type == "cpu":
        return fused_tiles_reference(counts, offs, stream, lights, mats, uniforms, **kw)
    from ..utils import cuda_build

    NT = nty * ntx
    cuda_build.check_tensors(
        stream.device,
        counts=(counts, torch.int32, (NT,)),
        offs=(offs, torch.int32, (NT + 1,)),
        stream=(stream, F32, (None, TRI_STRIDE)),
        lights=(lights, F32, (None, 8)),
        mats=(mats, F32, (None, 8)),
        uniforms=(uniforms, F32, (U_SIZE,)),
    )
    if lights.shape[0] < max(n_lights, 1) or mats.shape[0] < 8:
        raise ValueError("light or material table shorter than its count")
    if tile_h * tile_w > 1024:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's 1024")
    if not 0 <= ik_slots <= max(n_lights, 0) + CHUNK:
        raise ValueError(f"ik_slots {ik_slots} out of range for {n_lights} lights")
    color = torch.empty((3, nty * tile_h, ntx * tile_w), dtype=F32, device=stream.device)
    tile_overflow = torch.empty((NT,), dtype=torch.int32, device=stream.device)
    err = cuda_build.library().fused_tiles_launch(
        counts.data_ptr(), offs.data_ptr(), stream.data_ptr(),
        lights.data_ptr(), n_lights, mats.data_ptr(), uniforms.data_ptr(),
        nty, ntx, tile_h, tile_w, ik_slots, 1.0 / gamma,
        color.data_ptr(), tile_overflow.data_ptr(),
        torch.cuda.current_stream(stream.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "fused_tiles")
    fused_tiles.launches += 1
    return color, tile_overflow


fused_tiles.launches = 0


def render_fused(state: SceneState, cfg: RendererConfig, return_overflow: bool = False):
    """Fused tiled-deferred frame -> uint8 [H, W, 3] (and, with
    return_overflow, the int32 overflow count: binning overflow plus tiles
    whose live lights exceeded their slots).  Whole frames, the flagship
    branch only: frame.render_stats checks the config."""
    H, W = cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)

    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    li = state.lights
    L = li.num_point
    color, tile_overflow = fused_tiles(
        binned.counts, binned.offs, binned.stream,
        build_light_table(li), build_material_table(state.materials, cfg.gamma),
        build_uniforms(state, cfg, view_proj),
        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, n_lights=L,
        ik_slots=live_light_slots(cfg, L), gamma=cfg.gamma,
    )
    # The tile grid is rendered whole; the padding crops off here.
    frame = (
        torch.round(torch.clamp(color[:, :H, :W], 0.0, 1.0) * 255.0)
        .to(torch.uint8)
        .permute(1, 2, 0)
    )
    if return_overflow:
        return frame, binned.overflow + tile_overflow.sum().to(torch.int32)
    return frame
