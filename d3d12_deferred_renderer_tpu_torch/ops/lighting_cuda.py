"""G-buffer lighting kernel: tiled-deferred PBR over the encoded G-buffer.

The counterpart of d3d12_deferred_renderer_tpu/ops/lighting_pallas.py
(``_shade_kernel``, entry ``shade_pbr_tiled_pallas``).  Per screen tile
(tile_h x tile_w pixels, 8 x 128 in every shipped config):

1. decode the G-buffer planes as lighting.hlsl:34-40 does: albedo
   pow(max(a, 0), gamma), normal *2-1 then renormalized with the zero guard;
2. reconstruct the world position from depth through the inverse
   view-projection in the uniforms;
3. shade: directional GGX (times the shadow-visibility plane when one is
   given), the point-light GGX loop over the tile's culled light ids in
   ascending order, ambient; background pixels (depth 1) are 0.

The output is linear HDR [3, Hp, Wp]; tonemap and gamma stay in
ops/post.apply_post.  The per-tile light lists come from
lighting.cull_lights_to_tiles on the kernel's own tile grid, capped at
min(L, cfg.max_live_lights_per_tile) with loud overflow.

Steps 2-3 are the fused tile renderer's shading too (ops/fused.py), as
``_shade_row`` is shared by both TPU kernels: ``shade_pixels_reference`` is
its plain version, which both plain tile versions call, and csrc/shade.cuh
its device version, which both kernels include.  ``shade_tiles_reference``
is the plain version of the kernel (csrc/shade.cu); ``shade_tiles`` is the
wrapper that runs the kernel on CUDA tensors and the plain version on CPU
tensors.

Band mode (the screen-row band path): the uniforms' U_Y0 is the planes'
first pixel row in the frame and U_H the frame's height, so a band's world
positions, light cull and shading are the full frame's.  A band that is not
a multiple of tile_h pads its last tile row with background (depth 1): the
padded rows shade to 0 and are cropped, and the light cull pads them the
same way (as lighting.cull_lights_to_tiles and the JAX package do), so they
count toward no overflow that the JAX package does not count.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..config import RendererConfig
from ..scene import Lights
from ..xmath import normalize_safe
from .gbuffer import GBuffer
from .lighting import cull_lights_to_tiles, inverse_view_proj
from .raster_tiles import image_to_tiles, tile_pixels, tiles_to_image

# uniforms layout (f32 vector)
U_INV_VP = 0      # 16 floats, row-major, row-vector convention
U_EYE = 16        # 3
U_LDIR = 19       # 3 (normalized -lightDirection: toward the light)
U_LCOLOR = 22     # 3
U_AMBIENT = 25
U_W = 26
U_H = 27
U_TONEMAP = 28    # 1.0 = reinhard, 0.0 = none
U_Y0 = 29         # first pixel row of the shaded rows (a band's; 0 for a whole frame)
U_SIZE = 32

# G-buffer input planes (leading dim of the stacked planes)
P_AR, P_AG, P_AB, P_MET = 0, 1, 2, 3
P_NX, P_NY, P_NZ, P_RGH = 4, 5, 6, 7
P_DEPTH, P_VIS = 8, 9

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


@functools.lru_cache(maxsize=None)
def _uniform_tail(ambient: float, width: int, height: int, tonemap: float, device, y0: int = 0) -> torch.Tensor:
    """Fields U_AMBIENT.. of the uniforms: constant per config (and band),
    copied to the device once and reused, so that a frame makes no
    host-to-device copy."""
    t = torch.zeros((U_SIZE - U_AMBIENT,), dtype=F32)
    t[U_AMBIENT - U_AMBIENT] = ambient
    t[U_W - U_AMBIENT] = float(width)
    t[U_H - U_AMBIENT] = float(height)
    t[U_TONEMAP - U_AMBIENT] = tonemap
    t[U_Y0 - U_AMBIENT] = float(y0)
    return t.to(device)


def make_uniforms(eye, lights: Lights, cfg: RendererConfig, inv_vp, width: int, height: int,
                  y0: int = 0) -> torch.Tensor:
    """The [32] uniforms of both shading kernels for a width x height frame,
    or for its rows from y0 on (a band), built on the device of `inv_vp`
    from tensors already there."""
    tail = _uniform_tail(cfg.ambient, width, height,
                         1.0 if cfg.tonemap == "reinhard" else 0.0, inv_vp.device, y0)
    ldir = normalize_safe(-lights.direction)
    return torch.cat([inv_vp.reshape(-1), eye, ldir, lights.color, tail])


# --------------------------------------------------------------------------
# Plain version of the shading (shared with the fused tile renderer)
# --------------------------------------------------------------------------


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _rsqrt_guarded(x2, eps):
    return torch.where(x2 == 0.0, torch.ones_like(x2), torch.rsqrt(torch.clamp(x2, min=eps)))


def _ggx_directional(l, n, v, alb, metal, rough):
    """Cook-Torrance GGX * NdotL for a light direction l (3-lists of planes)."""
    h = [v[i] + l[i] for i in range(3)]
    ih = _rsqrt_guarded(dot3(h, h), 1e-38)
    h = [hi * ih for hi in h]
    ndl = torch.clamp(dot3(n, l), min=0.0)
    ndv = torch.clamp(dot3(n, v), min=1e-4)
    ndh = torch.clamp(dot3(n, h), min=0.0)
    vdh = torch.clamp(dot3(v, h), min=0.0)
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
        Fr = f0 + (1.0 - f0) * f5
        spec = (D * G) * Fr / (4.0 * ndv * ndl + 1e-4)
        kd = (1.0 - Fr) * (1.0 - metal)
        diffuse = kd * alb[c] * (1.0 / math.pi)
        out.append((diffuse + spec) * ndl)
    return out


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


def view_dirs(u, world):
    """Unit vectors from the world positions toward the eye."""
    v = [u[U_EYE + i] - world[i] for i in range(3)]
    iv = _rsqrt_guarded(dot3(v, v), 1e-38)
    return [c * iv for c in v]


def directional_radiance(u, n, v, alb, metal, rough, vis=None):
    """Directional GGX times the visibility (when given) times the light
    color, 3 planes."""
    ldir = [u[U_LDIR + i] for i in range(3)]
    direct = _ggx_directional(ldir, n, v, alb, metal, rough)
    if vis is not None:
        direct = [d * vis for d in direct]
    return [direct[c] * u[U_LCOLOR + c] for c in range(3)]


def shade_pixels_reference(u, depth, world, n, alb, metal, rough, lights, ids, n_live, vis=None,
                           direct=True):
    """Deferred shading of tile pixels -> linear HDR, 3 planes [NT, P].

    u [32] uniforms; depth, metal, rough [NT, P]; world, n, alb 3-lists of
    [NT, P]; lights [>= L, 8]; ids [NT, S] light ids, the first n_live[t]
    of tile t live, ascending; vis [NT, P] or None.  Directional GGX (x vis;
    left out with direct False, for the deferred-directional split), the
    point-light loop in id order, ambient; 0 where depth is 1."""
    v = view_dirs(u, world)
    zero = torch.zeros_like(depth)
    if direct:
        acc = directional_radiance(u, n, v, alb, metal, rough, vis)
    else:
        acc = [zero] * 3
    ndv = torch.clamp(dot3(n, v), min=1e-4)
    alpha = torch.clamp(rough * rough, min=1e-3)
    a2 = alpha * alpha
    kk = (rough + 1.0) * (rough + 1.0) / 8.0
    g1 = ndv / (ndv * (1.0 - kk) + kk)
    f0 = [0.04 * (1.0 - metal) + alb[c] * metal for c in range(3)]
    inv_pi = 1.0 / math.pi
    n_slots = int(n_live.max()) if n_live.numel() and ids.shape[1] else 0
    for j in range(n_slots):
        lr = lights[ids[:, j].long()][:, None, :]  # [NT, 1, 8]
        ok = (j < n_live)[:, None]
        t = [lr[..., i] - world[i] for i in range(3)]
        dl2 = dot3(t, t)
        inv_d = torch.rsqrt(torch.clamp(dl2, min=1e-12))
        l = [c * inv_d for c in t]
        inv_r2 = 1.0 / (lr[..., 3] * lr[..., 3])
        q = dl2 * inv_r2
        wq = torch.clamp(1.0 - q * q, 0.0, 1.0)
        window = wq * wq
        atten = torch.where(ok, lr[..., 7] * window / (dl2 + 1.0), zero)
        h = [v[i] + l[i] for i in range(3)]
        ih = _rsqrt_guarded(dot3(h, h), 1e-38)
        h = [c * ih for c in h]
        ndl = torch.clamp(dot3(n, l), min=0.0)
        ndh = torch.clamp(dot3(n, h), min=0.0)
        vdh = torch.clamp(dot3(v, h), min=0.0)
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
            Fr = f0[c] + (1.0 - f0[c]) * f5
            spec = dg * Fr / spec_den
            diffuse = (1.0 - Fr) * (1.0 - metal) * alb[c] * inv_pi
            acc[c] = acc[c] + (diffuse + spec) * scale * lr[..., 4 + c]

    shaded = depth < 1.0
    return [torch.where(shaded, acc[c] + u[U_AMBIENT] * alb[c], zero) for c in range(3)]


def shade_tiles_reference(planes, lights, light_ids, light_counts, uniforms, *,
                          nty, ntx, tile_h, tile_w, gamma):
    """Plain version of the G-buffer lighting kernel.

    planes [9 or 10, Hp, Wp] f32 (gb0 rgba, gb1 rgba, depth, optional
    visibility; padding at depth 1), lights [>= 1, 8], light_ids [NT, Lk]
    int32, light_counts [NT] int32, uniforms [32] (the planes' rows start
    at frame row uniforms[U_Y0]).  Returns HDR [3, Hp, Wp]."""
    p = image_to_tiles(planes, nty, ntx, tile_h, tile_w)
    alb = [torch.pow(torch.clamp(p[P_AR + c], min=0.0), gamma) for c in range(3)]
    d = [p[P_NX + c] * 2.0 - 1.0 for c in range(3)]
    dlen = torch.sqrt(dot3(d, d))
    inv_dlen = 1.0 / torch.where(dlen == 0.0, torch.ones_like(dlen), dlen)
    n = [c * inv_dlen for c in d]
    depth = p[P_DEPTH]
    px, py = tile_pixels(nty, ntx, tile_h, tile_w, planes.device)
    world = world_from_depth(uniforms, px, py + uniforms[U_Y0], depth)
    hdr = shade_pixels_reference(
        uniforms, depth, world, n, alb, p[P_MET], p[P_RGH], lights, light_ids, light_counts,
        vis=p[P_VIS] if planes.shape[0] > P_VIS else None,
    )
    return tiles_to_image(torch.stack(hdr), nty, ntx, tile_h, tile_w)


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------


def shade_tiles(planes, lights, light_ids, light_counts, uniforms, *,
                nty, ntx, tile_h, tile_w, gamma):
    """G-buffer lighting: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see shade_tiles_reference for the contract)."""
    kw = dict(nty=nty, ntx=ntx, tile_h=tile_h, tile_w=tile_w, gamma=gamma)
    if planes.device.type == "cpu":
        return shade_tiles_reference(planes, lights, light_ids, light_counts, uniforms, **kw)
    from ..utils import cuda_build

    NT = nty * ntx
    Hp, Wp = nty * tile_h, ntx * tile_w
    cuda_build.check_tensors(
        planes.device,
        planes=(planes, F32, (None, Hp, Wp)),
        lights=(lights, F32, (None, 8)),
        light_ids=(light_ids, torch.int32, (NT, None)),
        light_counts=(light_counts, torch.int32, (NT,)),
        uniforms=(uniforms, F32, (U_SIZE,)),
    )
    if planes.shape[0] not in (P_DEPTH + 1, P_VIS + 1):
        raise ValueError(f"{planes.shape[0]} G-buffer planes: expected {P_DEPTH + 1} or {P_VIS + 1}")
    if tile_h * tile_w > 1024:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's 1024")
    if lights.shape[0] < 1 or light_ids.shape[1] < 1:
        raise ValueError("empty light table or light-id list")
    hdr = torch.empty((3, Hp, Wp), dtype=F32, device=planes.device)
    err = cuda_build.library().shade_tiles_launch(
        planes.data_ptr(), planes.shape[0], lights.data_ptr(), lights.shape[0],
        light_ids.data_ptr(), light_ids.shape[1], light_counts.data_ptr(), uniforms.data_ptr(),
        nty, ntx, tile_h, tile_w, gamma, hdr.data_ptr(),
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "shade_tiles")
    shade_tiles.launches += 1
    return hdr


shade_tiles.launches = 0


def gbuffer_planes(gb: GBuffer, Hp: int, Wp: int, shadow_visibility=None) -> torch.Tensor:
    """The G-buffer stacked into [9 or 10, Hp, Wp] planes, padded to whole
    tiles with background (depth 1, every other plane 0)."""
    H, W = gb.depth.shape
    planes = [gb.gb0[..., c] for c in range(4)] + [gb.gb1[..., c] for c in range(4)] + [gb.depth]
    if shadow_visibility is not None:
        planes.append(shadow_visibility)
    planes = F.pad(torch.stack(planes), (0, Wp - W, 0, Hp - H))
    if (Hp, Wp) != (H, W):
        planes[P_DEPTH, H:, :] = 1.0
        planes[P_DEPTH, :, W:] = 1.0
    return planes


def shade_pbr_tiled_kernel(
    gb: GBuffer, lights: Lights, cfg: RendererConfig, view_proj: torch.Tensor, eye: torch.Tensor,
    shadow_visibility: Optional[torch.Tensor] = None, return_overflow: bool = False,
    inv_vp: Optional[torch.Tensor] = None, y_offset: int = 0, full_height: Optional[int] = None,
):
    """Tiled-deferred PBR shading through the lighting kernel's wrapper ->
    linear HDR [H, W, 3] (the lighting.shade_pbr_tiled contract, inv_vp,
    y_offset and full_height included), and with return_overflow the int32
    count of tiles whose live lights exceeded min(L,
    cfg.max_live_lights_per_tile)."""
    H, W = gb.depth.shape
    FH = full_height or H
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    dev = gb.depth.device
    planes = gbuffer_planes(gb, nty * TH, ntx * TW, shadow_visibility)
    if inv_vp is None:
        inv_vp = inverse_view_proj(view_proj)
    L = lights.num_point
    if L:
        tl = cull_lights_to_tiles(
            gb.depth, lights, cfg, view_proj, tile=(TH, TW),
            max_per_tile=min(L, cfg.max_live_lights_per_tile), inv_vp=inv_vp,
            y_offset=y_offset, full_height=full_height,
        )
        ids, counts, overflow = tl.indices.reshape(NT, -1), tl.counts.reshape(NT), tl.overflow
    else:
        ids = torch.zeros((NT, 1), dtype=torch.int32, device=dev)
        counts = torch.zeros((NT,), dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    hdr = shade_tiles(
        planes, build_light_table(lights), ids, counts, make_uniforms(eye, lights, cfg, inv_vp, W, FH, y_offset),
        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=cfg.gamma,
    )
    hdr = hdr[:, :H, :W].permute(1, 2, 0)
    return (hdr, overflow) if return_overflow else hdr
