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
"""
from __future__ import annotations

import math

import torch

from ..config import RendererConfig
from ..scene import Lights, Materials, SceneState
from ..xmath import normalize_safe
from .binning import CHUNK, bin_triangles
from .gbuffer import quantize_unorm
from .raster_ref import perspective_attr, triangle_fragments
from .transform import TRI_MESH_ID, TRI_N0, TRI_STRIDE, TRI_VALID, setup_frame_triangles

# uniforms layout (f32 vector)
U_INV_VP = 0      # 16 floats, row-major, row-vector convention
U_EYE = 16        # 3
U_LDIR = 19       # 3 (normalized -lightDirection: toward the light)
U_LCOLOR = 22     # 3
U_AMBIENT = 25
U_W = 26
U_H = 27
U_TONEMAP = 28    # 1.0 = reinhard, 0.0 = none
U_Y0 = 29         # band row offset (0 for whole frames)
U_SIZE = 32

BIG = 3.0e38  # empty-slab bound: every light distance to it overflows to inf

F32 = torch.float32


def build_light_table(li: Lights) -> torch.Tensor:
    """[max(L, 1), 8] point-light rows (pos.xyz, radius, color.rgb, intensity)."""
    L = li.num_point
    t = torch.zeros((max(L, 1), 8), dtype=F32, device=li.point_position.device)
    if L:
        t[:, 0:3] = li.point_position
        t[:, 3] = li.point_radius
        t[:, 4:7] = li.point_color
        t[:, 7] = li.point_intensity
    return t


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
    li = state.lights
    ldir = normalize_safe(-li.direction)
    inv_vp, _ = torch.linalg.inv_ex(view_proj)
    u = torch.zeros((U_SIZE,), dtype=F32, device=view_proj.device)
    u[U_INV_VP : U_INV_VP + 16] = inv_vp.reshape(-1)
    u[U_EYE : U_EYE + 3] = state.camera.eye
    u[U_LDIR : U_LDIR + 3] = ldir
    u[U_LCOLOR : U_LCOLOR + 3] = li.color
    u[U_AMBIENT] = cfg.ambient
    u[U_W] = float(cfg.width)
    u[U_H] = float(cfg.height)
    u[U_TONEMAP] = 1.0 if cfg.tonemap == "reinhard" else 0.0
    return u


def live_light_slots(cfg: RendererConfig, n_lights: int) -> int:
    """Compaction slots per tile: the live-light budget rounded up to CHUNK."""
    if n_lights == 0:
        return 0
    return -(-min(cfg.max_live_lights_per_tile, n_lights) // CHUNK) * CHUNK


# --------------------------------------------------------------------------
# Plain version of the tile kernel
# --------------------------------------------------------------------------


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _rsqrt_guarded(x2, eps):
    return torch.where(x2 == 0.0, torch.ones_like(x2), torch.rsqrt(torch.clamp(x2, min=eps)))


def _ggx_directional(l, n, v, alb, metal, rough):
    """Cook-Torrance GGX * NdotL for a light direction l (3-lists of planes)."""
    h = [v[i] + l[i] for i in range(3)]
    ih = _rsqrt_guarded(_dot3(h, h), 1e-38)
    h = [hi * ih for hi in h]
    ndl = torch.clamp(_dot3(n, l), min=0.0)
    ndv = torch.clamp(_dot3(n, v), min=1e-4)
    ndh = torch.clamp(_dot3(n, h), min=0.0)
    vdh = torch.clamp(_dot3(v, h), min=0.0)
    alpha = torch.clamp(rough * rough, min=1e-3)
    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / (math.pi * denom * denom)
    kk = (rough + 1.0) * (rough + 1.0) / 8.0
    g1 = ndv / (ndv * (1.0 - kk) + kk)
    g2 = ndl / (ndl * (1.0 - kk) + kk + 1e-7)
    G = g1 * g2
    u = 1.0 - vdh
    u2 = u * u
    f5 = u2 * u2 * u
    out = []
    for c in range(3):
        f0 = 0.04 * (1.0 - metal) + alb[c] * metal
        F = f0 + (1.0 - f0) * f5
        spec = (D * G) * F / (4.0 * ndv * ndl + 1e-4)
        kd = (1.0 - F) * (1.0 - metal)
        diffuse = kd * alb[c] * (1.0 / math.pi)
        out.append((diffuse + spec) * ndl)
    return out


def _tile_pixels(nty, ntx, tile_h, tile_w, device):
    """Pixel-center coordinates [NT, P] of every tile, tiles row-major."""
    i = torch.arange(tile_h * tile_w, device=device)
    row = (i // tile_w).to(F32)
    col = (i % tile_w).to(F32)
    ty = torch.arange(nty, device=device).repeat_interleave(ntx).to(F32)[:, None]
    tx = torch.arange(ntx, device=device).repeat(nty).to(F32)[:, None]
    py = (ty * tile_h + 0.5) + row[None, :]
    px = (tx * tile_w + 0.5) + col[None, :]
    return px, py


def world_from_depth(u, px, py, depth):
    """World position planes from depth and pixel centers (inverse VP)."""
    ndc_x = px * (2.0 / u[U_W]) - 1.0
    ndc_y = 1.0 - py * (2.0 / u[U_H])

    def ivp(i, j):
        return u[U_INV_VP + 4 * i + j]

    hs = [
        ndc_x * ivp(0, j) + ndc_y * ivp(1, j) + depth * ivp(2, j) + ivp(3, j)
        for j in range(4)
    ]
    inv_hw = 1.0 / torch.where(hs[3] == 0.0, torch.ones_like(hs[3]), hs[3])
    return [hs[j] * inv_hw for j in range(3)]


def fused_tiles_reference(
    counts, offs, stream, lights, mats, uniforms, *,
    nty, ntx, tile_h, tile_w, n_lights, ik_slots, gamma,
):
    """Plain PyTorch version of the fused tile kernel.

    counts [NT] int32, offs [NT + 1] int32, stream [R, 32] f32 (tile t's
    records are rows offs[t] .. offs[t] + counts[t]), lights [>= L, 8],
    mats [>= 8, 8], uniforms [32].  Returns (color [3, Hp, Wp] f32 after
    tonemap and gamma, tile_overflow [NT] int32)."""
    dev = stream.device
    NT, P = nty * ntx, tile_h * tile_w
    px, py = _tile_pixels(nty, ntx, tile_h, tile_w, dev)
    u = uniforms

    # ---- raster: one list slot at a time over every tile ----
    depth = torch.ones((NT, P), dtype=F32, device=dev)
    nrm = [torch.zeros((NT, P), dtype=F32, device=dev) for _ in range(3)]
    mid = torch.full((NT, P), -1.0, dtype=F32, device=dev)
    base = offs[:-1].long()
    n_slots = int(counts.max()) if NT else 0
    for k in range(n_slots):
        rows = torch.clamp(base + k, max=stream.shape[0] - 1)
        rec = stream[rows]  # [NT, 32]
        covered, z, bs = triangle_fragments(rec, px, py)
        ok = (rec[:, TRI_VALID : TRI_VALID + 1] > 0.0) & (k < counts)[:, None]
        passes = covered & ok & (z >= 0.0) & (z <= 1.0) & (z < depth)
        depth = torch.where(passes, z, depth)
        for j in range(3):
            nrm[j] = torch.where(passes, perspective_attr(rec, bs, TRI_N0 + j, 3), nrm[j])
        mid = torch.where(passes, rec[:, TRI_MESH_ID : TRI_MESH_ID + 1], mid)
    covered = mid >= 0.0

    # ---- exact in-kernel light cull: two eye-distance slabs per tile ----
    world = world_from_depth(u, px, py, depth)
    eye = [u[U_EYE + i] for i in range(3)]
    d = [world[i] - eye[i] for i in range(3)]
    d2 = _dot3(d, d)
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
    nlen = torch.sqrt(_dot3(nrm, nrm))
    inv_nlen = 1.0 / torch.where(nlen == 0.0, torch.ones_like(nlen), nlen)
    zero = torch.zeros_like(nlen)
    enc = [quantize_unorm(torch.where(covered, c * inv_nlen, zero) * 0.5 + 0.5, 10) for c in nrm]
    dec = [e * 2.0 - 1.0 for e in enc]
    dlen = torch.sqrt(_dot3(dec, dec))
    inv_dlen = 1.0 / torch.where(dlen == 0.0, torch.ones_like(dlen), dlen)
    n = [c * inv_dlen for c in dec]

    # ---- shading ----
    v = [eye[i] - world[i] for i in range(3)]
    iv = _rsqrt_guarded(_dot3(v, v), 1e-38)
    v = [c * iv for c in v]
    ldir = [u[U_LDIR + i] for i in range(3)]
    direct = _ggx_directional(ldir, n, v, alb, metal, rough)
    acc = [direct[c] * u[U_LCOLOR + c] for c in range(3)]

    ndv = torch.clamp(_dot3(n, v), min=1e-4)
    alpha = torch.clamp(rough * rough, min=1e-3)
    a2 = alpha * alpha
    kk = (rough + 1.0) * (rough + 1.0) / 8.0
    g1 = ndv / (ndv * (1.0 - kk) + kk)
    f0 = [0.04 * (1.0 - metal) + alb[c] * metal for c in range(3)]
    inv_pi = 1.0 / math.pi
    for j in range(int(n_live.max()) if NT and ik_slots else 0):
        lr = lights[ids[:, j]][:, None, :]  # [NT, 1, 8]
        ok = (j < n_live)[:, None]
        t = [lr[..., i] - world[i] for i in range(3)]
        dl2 = _dot3(t, t)
        inv_d = torch.rsqrt(torch.clamp(dl2, min=1e-12))
        l = [c * inv_d for c in t]
        inv_r2 = 1.0 / (lr[..., 3] * lr[..., 3])
        q = dl2 * inv_r2
        wq = torch.clamp(1.0 - q * q, 0.0, 1.0)
        window = wq * wq
        atten = torch.where(ok, lr[..., 7] * window / (dl2 + 1.0), zero)
        h = [v[i] + l[i] for i in range(3)]
        ih = _rsqrt_guarded(_dot3(h, h), 1e-38)
        h = [c * ih for c in h]
        ndl = torch.clamp(_dot3(n, l), min=0.0)
        ndh = torch.clamp(_dot3(n, h), min=0.0)
        vdh = torch.clamp(_dot3(v, h), min=0.0)
        denom = ndh * ndh * (a2 - 1.0) + 1.0
        D = a2 / (math.pi * denom * denom)
        g2 = ndl / (ndl * (1.0 - kk) + kk + 1e-7)
        dg = D * (g1 * g2)
        spec_den = 4.0 * ndv * ndl + 1e-4
        u5 = 1.0 - vdh
        u5sq = u5 * u5
        f5 = u5sq * u5sq * u5
        scale = ndl * atten
        for c in range(3):
            F = f0[c] + (1.0 - f0[c]) * f5
            spec = dg * F / spec_den
            diffuse = (1.0 - F) * (1.0 - metal) * alb[c] * inv_pi
            acc[c] = acc[c] + (diffuse + spec) * scale * lr[..., 4 + c]

    # ---- ambient, background mask, tonemap, gamma ----
    shaded = depth < 1.0
    out = []
    for c in range(3):
        o = torch.where(shaded, acc[c] + u[U_AMBIENT] * alb[c], zero)
        o = torch.where(u[U_TONEMAP] > 0.5, o / (1.0 + o), o)
        out.append(torch.pow(torch.clamp(o, min=0.0), 1.0 / gamma))
    color = (
        torch.stack(out)
        .reshape(3, nty, ntx, tile_h, tile_w)
        .permute(0, 1, 3, 2, 4)
        .reshape(3, nty * tile_h, ntx * tile_w)
    )
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
