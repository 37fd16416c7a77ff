"""Fused tiled-deferred frame: raster -> G-buffer -> lights -> shading ->
tonemap, one kernel launch, the G-buffer never leaves the chip.

The counterpart of d3d12_deferred_renderer_tpu/ops/fused.py's
``render_fused``: the flagship frame (PBR) and the config-4 stack (shadows,
procedural bump, bloom, FXAA).  Per screen tile (8 x 128 pixels):

1. rasterize the tile's binned records in submission order (ops/raster_ref
   rules: pixel centers, top-left fill, depth LESS, [0, 1] depth clip,
   perspective-correct normal and, for the bump, uv), then with the bump
   perturb the normals inside the tile (ops/bump.bump_planar);
2. the tile's point lights, one of two ways:
   - the in-kernel cull (cfg.inkernel_light_cull): every point light EXACTLY
     against the tile's geometry: covered pixels split at the midpoint
     dmid = (dmin + dmax) / 2 of their squared eye distance into two slabs,
     each slab's world AABB (+-3e38 when empty), and a light is live iff its
     influence sphere (dist^2 <= r^2) touches either box; live ids compact
     in ascending order into
     ``ik_slots = ceil(min(max_live_lights_per_tile, L) / 16) * 16`` slots,
     and a tile with more live lights adds one to the overflow count;
   - per-tile light lists: a depth prepass (the depth-only raster kernel on
     the frame's own binned records) feeds lighting.cull_lights_to_tiles on
     the kernel's tile grid, capped at min(L, max_live_lights_per_tile) with
     its own loud overflow; the kernel reads each tile's first count ids;
3. quantize the normal to 10 bits and decode it, look the material up by the
   winning mesh id (-1 is background and shades to 0);
4. ambient + directional GGX (times the shadow visibility when there is a
   plane) + the point-light GGX loop over the live ids, then Reinhard and
   gamma; or linear HDR (bloom follows), and with the split no directional
   term but the depth, decoded normal and mesh-id planes out.

Shadows come one of two ways.  Without the deferred-directional split the
prepass depth (bit-equal to the kernel's own) gives the PCF visibility
(ops/shadows) before the tile kernel, which multiplies it into the
directional term.  With the split the directional term is added after the
tile kernel: the shadow map, PCF visibility from the kernel's own depth
plane at the tiles with a pixel facing the light, and the directional
resolve kernel (csrc/resolve.cu: hdr += vis x directional GGX).  Bloom,
tonemap, gamma and FXAA follow.

``fused_tiles_reference`` is the plain PyTorch version of the tile kernel
(csrc/fused.cu) over [tiles, pixels] tensors; ``fused_tiles`` is the wrapper
that runs the kernel on CUDA tensors and the plain version on CPU tensors;
``directional_resolve_reference`` and ``directional_resolve`` are the same
pair for the resolve kernel.  Step 1 is the tile raster of
ops/raster_tiles.py, the bump that of ops/bump.py and step 4 the shading of
ops/lighting_cuda.py, in plain PyTorch and in the kernels alike
(csrc/raster.cuh, csrc/bump.cuh, csrc/shade.cuh).

Band mode (``render_fused``'s ``band_h`` / ``y_offset``, the screen-row band
path) renders rows [y_offset, y_offset + band_h) of the frame through the
same kernels, the uniforms' U_Y0 giving the band's first row, and returns
its linear HDR for the caller's post.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import RendererConfig
from ..scene import Materials, SceneState
from ..utils.debug import check_finite
from . import post
from .binning import CHUNK, bin_triangles
from .bump import bump_planar
from .gbuffer import quantize_unorm
from .lighting import cull_lights_to_tiles, inverse_view_proj
from .lighting_cuda import (
    U_EYE, U_H, U_LDIR, U_SIZE, U_TONEMAP, U_W, U_Y0, build_light_table, directional_radiance, dot3,
    make_uniforms, shade_pixels_reference, view_dirs, world_from_depth,
)
from .raster_tiles import image_to_tiles, raster_depth, raster_tile_pixels, tile_pixels, tiles_to_image
from .shadows import render_shadow_map, shadow_visibility
from .transform import TRI_STRIDE, setup_frame_triangles

BIG = 3.0e38  # empty-slab bound: every light distance to it overflows to inf

F32 = torch.float32


def build_material_table(mats: Materials, gamma: float) -> torch.Tensor:
    """[max(M, 8), 8] material rows with the G-buffer quantization and the
    sRGB decode baked in: albedo 8-bit then ^gamma, metalness 8-bit,
    roughness 2-bit (0.5 becomes 2/3)."""
    M = mats.albedo.shape[0]
    alb_lin = torch.pow(torch.clamp(quantize_unorm(mats.albedo, 8), min=0.0), gamma)
    t = torch.zeros((max(M, 8), 8), dtype=F32, device=mats.albedo.device)
    t[:M, 0:3] = alb_lin
    t[:M, 3] = quantize_unorm(mats.metalness, 8)
    t[:M, 4] = quantize_unorm(mats.roughness, 2)
    return t


def live_light_slots(cfg: RendererConfig, n_lights: int) -> int:
    """Compaction slots per tile: the live-light budget rounded up to CHUNK."""
    if n_lights == 0:
        return 0
    return -(-min(cfg.max_live_lights_per_tile, n_lights) // CHUNK) * CHUNK


def pad_light_ids_to_chunk(light_ids: torch.Tensor) -> torch.Tensor:
    """The per-tile light-id lists [NT, Lk] padded with id 0 to a CHUNK
    multiple of Lk, as the JAX package pads them (the padding lies past
    every tile's count and is never read)."""
    Lk = light_ids.shape[1]
    return F.pad(light_ids, (0, -(-Lk // CHUNK) * CHUNK - Lk))


# --------------------------------------------------------------------------
# Plain version of the tile kernel
# --------------------------------------------------------------------------


def _cull_tiles(u, world, covered, lights, n_lights, ik_slots):
    """The in-kernel light cull of the plain version -> (ids [NT, ik_slots],
    live counts [NT], tile overflow [NT] int32)."""
    dev = covered.device
    NT = covered.shape[0]
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
    return ids, n_live, tile_overflow


def fused_tiles_reference(
    counts, offs, stream, lights, mats, uniforms, *,
    nty, ntx, tile_h, tile_w, n_lights, ik_slots, gamma, bump=None, hdr_out=False,
    aux=False, light_ids=None, light_counts=None, vis=None, return_live=False,
):
    """Plain version of the fused tile kernel.

    counts [NT] int32, offs [NT + 1] int32, stream [R, 32] f32 (tile t's
    records are rows offs[t] .. offs[t] + counts[t]), lights [>= L, 8],
    mats [>= 8, 8], uniforms [32] (the grid's first pixel row in the frame
    is uniforms[U_Y0]).  The lights of a tile come from the
    in-kernel cull of n_lights lights into ik_slots slots or, when
    ``light_ids`` [NT, Lk] int32 and ``light_counts`` [NT] int32 are given,
    from the tile's first count ids (the count clamped to [0, Lk], each id
    to the table's rows; tile_overflow 0: the lists' cull counts its own).
    ``vis`` [Hp, Wp] f32, the shadow visibility, multiplies the directional
    term (never with aux).  The config-4 variants:

    - ``bump`` (strength, frequency): uv joins the raster and bump_planar
      perturbs the raw normals per tile before the G-buffer quantization,
      pixels outside the frame counting as background;
    - ``hdr_out``: linear HDR out, no tonemap or gamma;
    - ``aux`` (the deferred-directional split; implies hdr_out): no
      directional term, and five more planes out: depth, the decoded
      G-buffer normal xyz and the mesh id (-1 background).

    Returns (color [3 or 8, Hp, Wp] f32, tile_overflow [NT] int32), and
    with return_live the live-light count of each tile [NT] as a third
    element (the in-kernel cull's own counts, which no other function
    computes, or the clamped list counts): the kernel's work bound
    (chip_smoke.py) needs them."""
    dev = stream.device
    NT = nty * ntx
    px, py = tile_pixels(nty, ntx, tile_h, tile_w, dev)
    u = uniforms
    py = py + u[U_Y0]

    # ---- raster (ops/raster_tiles; uv only for the bump) ----
    frags = raster_tile_pixels(counts, offs, stream, px, py, uv=bump is not None)
    depth, nrm, mid = frags.depth, frags.normal, frags.mesh_id
    covered = mid >= 0.0
    world = world_from_depth(u, px, py, depth)
    if bump is not None:
        def blk(a):
            return a.reshape(NT, tile_h, tile_w)

        inside = (px < u[U_W]) & (py < u[U_H])
        mid_b = torch.where(inside, mid, torch.full_like(mid, -1.0))
        nrm = bump_planar([blk(w) for w in world], [blk(t) for t in frags.uv], [blk(c) for c in nrm],
                          blk(mid_b), bump[0], bump[1])
        nrm = [c.reshape(NT, -1) for c in nrm]

    # ---- the tile's lights: the lists, or the exact in-kernel cull against
    # two eye-distance slabs per tile ----
    if light_ids is not None:
        ids = torch.clamp(light_ids, 0, lights.shape[0] - 1)
        n_live = torch.clamp(light_counts, 0, light_ids.shape[1])
        tile_overflow = torch.zeros((NT,), dtype=torch.int32, device=dev)
    else:
        ids, n_live, tile_overflow = _cull_tiles(u, world, covered, lights, n_lights, ik_slots)
    vis_t = None if vis is None else image_to_tiles(vis[None], nty, ntx, tile_h, tile_w)[0]

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
    out = shade_pixels_reference(u, depth, world, n, alb, metal, rough, lights, ids, n_live,
                                 vis=vis_t, direct=not aux)
    if not (hdr_out or aux):
        out = [torch.where(u[U_TONEMAP] > 0.5, o / (1.0 + o), o) for o in out]
        out = [torch.pow(torch.clamp(o, min=0.0), 1.0 / gamma) for o in out]
    if aux:
        out = out + [depth, *n, mid]
    color = tiles_to_image(torch.stack(out), nty, ntx, tile_h, tile_w)
    if return_live:
        return color, tile_overflow, n_live.to(torch.int32)
    return color, tile_overflow


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------


def fused_tiles(
    counts, offs, stream, lights, mats, uniforms, *,
    nty, ntx, tile_h, tile_w, n_lights, ik_slots, gamma, bump=None, hdr_out=False, aux=False,
    light_ids=None, light_counts=None, vis=None,
):
    """Fused tile renderer: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see fused_tiles_reference for the contract)."""
    kw = dict(nty=nty, ntx=ntx, tile_h=tile_h, tile_w=tile_w, n_lights=n_lights,
              ik_slots=ik_slots, gamma=gamma, bump=bump, hdr_out=hdr_out, aux=aux,
              light_ids=light_ids, light_counts=light_counts, vis=vis)
    if (light_ids is None) != (light_counts is None):
        raise ValueError("light_ids and light_counts come together")
    if aux and vis is not None:
        raise ValueError("the split (aux) adds the directional term later: no visibility plane")
    if stream.device.type == "cpu":
        return fused_tiles_reference(counts, offs, stream, lights, mats, uniforms, **kw)
    from ..utils import cuda_build

    NT = nty * ntx
    Hp, Wp = nty * tile_h, ntx * tile_w
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
    if bump is not None and (tile_h < 2 or tile_w < 2):
        raise ValueError("the in-kernel bump needs tiles of at least 2 x 2 pixels")
    if light_ids is not None:
        cuda_build.check_tensors(
            stream.device,
            light_ids=(light_ids, torch.int32, (NT, None)),
            light_counts=(light_counts, torch.int32, (NT,)),
        )
        if light_ids.shape[1] < 1:
            raise ValueError("empty light-id lists")
        # The lists' row length sizes the shared rows; ids index the table.
        slots, n_rows = light_ids.shape[1], lights.shape[0]
    else:
        if not 0 <= ik_slots <= max(n_lights, 0) + CHUNK:
            raise ValueError(f"ik_slots {ik_slots} out of range for {n_lights} lights")
        slots, n_rows = ik_slots, n_lights
    if vis is not None:
        cuda_build.check_tensors(stream.device, vis=(vis, F32, (Hp, Wp)))

    def ptr(t):
        return None if t is None else t.data_ptr()

    color = torch.empty((8 if aux else 3, Hp, Wp), dtype=F32, device=stream.device)
    tile_overflow = torch.empty((NT,), dtype=torch.int32, device=stream.device)
    strength, freq = bump if bump is not None else (0.0, 0.0)
    err = cuda_build.library().fused_tiles_launch(
        counts.data_ptr(), offs.data_ptr(), stream.data_ptr(),
        lights.data_ptr(), n_rows, mats.data_ptr(), mats.shape[0], uniforms.data_ptr(),
        nty, ntx, tile_h, tile_w, ptr(light_ids), ptr(light_counts), slots, ptr(vis), 1.0 / gamma,
        int(bump is not None), float(strength), 2.0 * math.pi * freq, int(hdr_out or aux), int(aux),
        color.data_ptr(), tile_overflow.data_ptr(),
        torch.cuda.current_stream(stream.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "fused_tiles")
    fused_tiles.launches += 1
    return color, tile_overflow


fused_tiles.launches = 0


# --------------------------------------------------------------------------
# Directional resolve (the deferred-directional split)
# --------------------------------------------------------------------------


def directional_resolve_reference(planes, vis, mats, uniforms):
    """Plain version of the directional resolve kernel.

    planes [>= 8, Hp, Wp] f32: the split tile kernel's output (hdr rgb,
    depth, decoded normal xyz, mesh id), vis [Hp, Wp] shadow visibility,
    mats [>= 8, 8] the baked material table, uniforms [32].  Returns hdr
    [3, Hp, Wp] plus vis x directional GGX x light color where depth < 1
    (world position from depth at the pixel centers, materials by mesh id:
    the shading the tile kernel left out)."""
    Hp, Wp = vis.shape
    dev = planes.device
    u = uniforms
    depth, n, mid = planes[3], [planes[4 + i] for i in range(3)], planes[7]
    px = (torch.arange(Wp, dtype=F32, device=dev) + 0.5)[None, :]
    py = (torch.arange(Hp, dtype=F32, device=dev) + 0.5)[:, None]
    world = world_from_depth(u, px, py, depth)
    mrow = torch.clamp(mid, 0.0, float(mats.shape[0] - 1)).long()
    mat = torch.where((mid >= 0.0)[..., None], mats[mrow], torch.zeros((), dtype=F32, device=dev))
    alb = [mat[..., c] for c in range(3)]
    direct = directional_radiance(u, n, view_dirs(u, world), alb, mat[..., 3], mat[..., 4], vis)
    covered = depth < 1.0
    zero = torch.zeros((), dtype=F32, device=dev)
    return torch.stack([planes[c] + torch.where(covered, direct[c], zero) for c in range(3)])


def directional_resolve(planes, vis, mats, uniforms):
    """Directional resolve: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see directional_resolve_reference)."""
    if planes.device.type == "cpu":
        return directional_resolve_reference(planes, vis, mats, uniforms)
    from ..utils import cuda_build

    Hp, Wp = vis.shape
    cuda_build.check_tensors(
        planes.device,
        planes=(planes, F32, (None, Hp, Wp)),
        vis=(vis, F32, (Hp, Wp)),
        mats=(mats, F32, (None, 8)),
        uniforms=(uniforms, F32, (U_SIZE,)),
    )
    if planes.shape[0] < 8 or mats.shape[0] < 1:
        raise ValueError("the resolve needs 8 planes and a material table")
    hdr = torch.empty((3, Hp, Wp), dtype=F32, device=planes.device)
    err = cuda_build.library().directional_resolve_launch(
        planes.data_ptr(), vis.data_ptr(), mats.data_ptr(), mats.shape[0], uniforms.data_ptr(),
        Hp, Wp, hdr.data_ptr(), torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "directional_resolve")
    directional_resolve.launches += 1
    return hdr


directional_resolve.launches = 0


def split_visibility(out, view_proj, shadow_depth, light_vp, cfg: RendererConfig, uniforms, inv_vp):
    """The deferred-directional split's shadow visibility from the split
    tile kernel's planes `out` [8, Hp, Wp] -> (vis [Hp, Wp], padded with 1,
    int32 overflow of the PCF tile cap).  PCF reads the kernel's own depth
    and samples only tiles with a pixel that faces the light: a pixel facing
    away has a zero directional term."""
    H, W = cfg.height, cfg.width
    ldir = uniforms[U_LDIR : U_LDIR + 3]
    lit = ((out[4, :H, :W] * ldir[0] + out[5, :H, :W] * ldir[1]) + out[6, :H, :W] * ldir[2]) > 0.0
    vis, overflow = shadow_visibility(out[3, :H, :W], view_proj, shadow_depth, light_vp, cfg,
                                      return_overflow=True, lit_mask=lit, inv_vp=inv_vp)
    return F.pad(vis, (0, out.shape[2] - W, 0, out.shape[1] - H), value=1.0), overflow


def finish_frame(color, cfg: RendererConfig, hdr: bool) -> torch.Tensor:
    """The fused frame's tail: channel-first color [3, >= H, >= W] ->
    uint8 [H, W, 3].  Linear HDR takes bloom, tonemap and gamma here; FXAA
    runs on the gamma-encoded image before the quantization."""
    color = color[:, : cfg.height, : cfg.width]
    if hdr:
        if cfg.bloom:
            color = post.bloom_chw(color, cfg.bloom_threshold, cfg.bloom_strength)
        if cfg.tonemap == "reinhard":
            color = post.reinhard(color)
        color = post.gamma_encode(color, cfg.gamma)
    color = color.permute(1, 2, 0)
    if cfg.fxaa:
        color = post.fxaa(color)
    check_finite("colour before to_uint8", color)
    return post.to_uint8(color)


def render_fused(state: SceneState, cfg: RendererConfig, return_overflow: bool = False,
                 band_h: int | None = None, y_offset: int = 0):
    """Fused tiled-deferred frame -> uint8 [H, W, 3] (and, with
    return_overflow, the int32 overflow count: the binning's, the light
    cull's (tiles whose live lights exceeded their slots or list) and, with
    shadows, the shadow map's binning and the PCF tile cap).  The JAX
    package's conditions decide the branches: the in-kernel cull when
    cfg.inkernel_light_cull and there are point lights, the split when
    cfg.deferred_directional and cfg.shadows (never in band mode), and the
    depth prepass when the lists or the unsplit shadows need it.

    With band_h (a multiple of cfg.tile_h, else ValueError) the whole chain
    (binning, prepass, light cull, dense PCF, the tile kernel) runs on rows
    [y_offset, y_offset + band_h) of the frame and returns the band's linear
    HDR [band_h, W, 3]: bloom, tonemap, gamma and FXAA belong to the caller
    (parallel/sharded.py)."""
    band = band_h is not None
    H, W = band_h or cfg.height, cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    if band and H % TH:
        raise ValueError(f"fused band height {H} must be a multiple of tile_h={TH}")
    nty, ntx = -(-H // TH), -(-W // TW)
    li = state.lights
    L = li.num_point
    ik = cfg.inkernel_light_cull and L > 0
    split = cfg.deferred_directional and cfg.shadows and not band
    rows = dict(y_offset=y_offset, full_height=cfg.height if band else None)

    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg, band_h, y_offset)
    inv_vp = inverse_view_proj(view_proj)
    mats = build_material_table(state.materials, cfg.gamma)
    uniforms = make_uniforms(state.camera.eye, li, cfg, inv_vp, W, cfg.height, y_offset)
    overflow = binned.overflow
    depth_pre = light_ids = light_counts = vis = None
    if (L and not ik) or (cfg.shadows and not split):
        # The depth prepass on the frame's own binned records: bit-equal to
        # the tile kernel's depth.
        depth_pre = raster_depth(binned.counts, binned.offs, binned.stream,
                                 nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, y0=y_offset)[:H, :W]
    if L and not ik:
        tl = cull_lights_to_tiles(depth_pre, li, cfg, view_proj, tile=(TH, TW),
                                  max_per_tile=min(L, cfg.max_live_lights_per_tile), inv_vp=inv_vp,
                                  **rows)
        light_ids = pad_light_ids_to_chunk(tl.indices.reshape(nty * ntx, -1))
        light_counts = tl.counts.reshape(-1)
        overflow = overflow + tl.overflow
    if cfg.shadows:
        sd, lvp, s_overflow = render_shadow_map(state, cfg, return_overflow=True)
        overflow = overflow + s_overflow
        if not split:
            vis, v_overflow = shadow_visibility(depth_pre, view_proj, sd, lvp, cfg,
                                                return_overflow=True, inv_vp=inv_vp, **rows)
            check_finite("shadow visibility", vis)
            overflow = overflow + v_overflow
            vis = F.pad(vis, (0, ntx * TW - W, 0, nty * TH - H), value=1.0)
    out, tile_overflow = fused_tiles(
        binned.counts, binned.offs, binned.stream, build_light_table(li), mats, uniforms,
        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, n_lights=L,
        ik_slots=live_light_slots(cfg, L), gamma=cfg.gamma,
        bump=(cfg.bump_strength, cfg.bump_frequency) if cfg.normal_mapping else None,
        hdr_out=cfg.bloom or split or band, aux=split,
        light_ids=light_ids, light_counts=light_counts, vis=vis,
    )
    check_finite("fused kernel output", out[0:3, :H, :W])
    overflow = overflow + tile_overflow.sum().to(torch.int32)
    color = out[0:3]
    if band:
        hdr = color[:, :H, :W].permute(1, 2, 0)
        return (hdr, overflow) if return_overflow else hdr
    if split:
        vis, v_overflow = split_visibility(out, view_proj, sd, lvp, cfg, uniforms, inv_vp)
        check_finite("shadow visibility", vis)
        overflow = overflow + v_overflow
        color = directional_resolve(out, vis, mats, uniforms)
    frame = finish_frame(color, cfg, hdr=cfg.bloom or split)
    return (frame, overflow) if return_overflow else frame
