"""Deferred lighting: reference-parity Lambert, Cook-Torrance PBR, and the
per-tile light cull.

The counterpart of d3d12_deferred_renderer_tpu/ops/lighting.py.

- ``shade_lambert`` is lighting.hlsl:32-51: decode the quantized G-buffer,
  one directional light, Lambert diffuse + constant ambient, gamma out, on
  every pixel (the background shades the cleared G-buffer to black).
- ``shade_pbr`` is Cook-Torrance GGX over the same G-buffer with N point
  lights (windowed inverse-square falloff, zero at the radius) plus the
  directional light; world positions come from depth through the inverse
  view-projection.  Every light at every pixel: the oracle of the tiled path.
- ``cull_lights_to_tiles`` bounds each screen tile's covered pixels by two
  depth slabs (split at the world-depth midpoint), unprojects each slab's 8
  corners to a world AABB and keeps the lights whose influence sphere
  touches either box; the live ids compact in ascending order, as
  jax.lax.top_k over a 0/1 score leaves them (a stable sort here: torch.topk
  makes no promise about the order of ties).  Plain PyTorch on every device,
  as it is plain XLA in the JAX package.
- ``shade_pbr_tiled`` shades each 32x32 tile with its culled lights only:
  the plain path (cfg.use_pallas off); the kernel path is
  ops/lighting_cuda.py.

Sums of three or four terms are written in one fixed order; the results
agree with the JAX package to float32 rounding (tests/test_torch_lighting.py
states the tolerances).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import RendererConfig
from ..scene import Lights
from ..xmath import normalize_safe, powf
from .gbuffer import GBuffer, decode_gbuffer

F32 = torch.float32


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (length 3) of a * b, as (x + y) + z."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(v, v))


def shade_lambert(gb: GBuffer, lights: Lights, cfg: RendererConfig) -> torch.Tensor:
    """Reference lighting pass (lighting.hlsl:32-51) -> display-ready
    [H, W, 3] in [0, 1]."""
    d = decode_gbuffer(gb, cfg)
    L = normalize_safe(-lights.direction)
    brightness = torch.clamp(_dot(d.normal, L), 0.0, 1.0)
    color = d.albedo * (cfg.ambient + lights.color * brightness[..., None])
    return powf(torch.clamp(color, min=0.0), 1.0 / cfg.gamma)


def inverse_view_proj(view_proj: torch.Tensor) -> torch.Tensor:
    """The inverse view-projection.  One call per frame: the light cull and
    the lighting kernel's uniforms read the same inverse, so a light that
    grazes a tile's box is culled and shaded alike."""
    return torch.linalg.inv_ex(view_proj)[0]


def _unproject(x, y, z, inv_vp):
    """World xyz [..., 3] of NDC points (x, y, z, 1) through inv_vp (row-vector
    convention), each homogeneous coordinate summed in row order."""
    h = [((x * inv_vp[0, j] + y * inv_vp[1, j]) + z * inv_vp[2, j]) + inv_vp[3, j] for j in range(4)]
    return torch.stack(h[:3], dim=-1) / h[3][..., None]


def reconstruct_world_positions(
    depth: torch.Tensor, view_proj: torch.Tensor, cfg: RendererConfig,
    inv_vp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel world position [H, W, 3] from NDC depth: pixel centers at
    +0.5, y flipped, z the stored depth (the viewport transform inverted)."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, dtype=F32, device=dev) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (torch.arange(H, dtype=F32, device=dev) + 0.5) * (2.0 / H)
    if inv_vp is None:
        inv_vp = inverse_view_proj(view_proj)
    return _unproject(xs[None, :], ys[:, None], depth, inv_vp)


# ---------------------------------------------------------------------------
# Cook-Torrance GGX
# ---------------------------------------------------------------------------


def _ggx_brdf(n, v, l, albedo, metalness, roughness):
    """Cook-Torrance specular + energy-conserving Lambert diffuse, times
    NdotL; the caller multiplies by the light's color and attenuation."""
    h = normalize_safe(v + l)
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ndv = torch.clamp(_dot(n, v), min=1e-4)
    ndh = torch.clamp(_dot(n, h), min=0.0)
    vdh = torch.clamp(_dot(v, h), min=0.0)

    alpha = torch.clamp(roughness * roughness, min=1e-3)
    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / (math.pi * denom * denom)

    k = (roughness + 1.0) ** 2 / 8.0
    g1 = ndv / (ndv * (1.0 - k) + k)
    g2 = ndl / (ndl * (1.0 - k) + k + 1e-7)
    G = g1 * g2

    m = metalness[..., None]
    f0 = 0.04 * (1.0 - m) + albedo * m
    Fr = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)[..., None]

    spec = (D * G)[..., None] * Fr / (4.0 * ndv * ndl + 1e-4)[..., None]
    kd = (1.0 - Fr) * (1.0 - m)
    diffuse = kd * albedo / math.pi
    return (diffuse + spec) * ndl[..., None]


def _point_light_attenuation(dist, radius, intensity):
    """Windowed inverse-square falloff, zero at the influence radius (so the
    per-tile cull is exact, not an approximation)."""
    window = torch.clamp(1.0 - (dist / radius) ** 4, 0.0, 1.0) ** 2
    return intensity * window / (dist * dist + 1.0)


def _light_contrib(world, n, v, d, pos, color, radius, intensity):
    to_l = pos - world
    dist = _norm(to_l)
    l = to_l / torch.clamp(dist, min=1e-6)[..., None]
    atten = _point_light_attenuation(dist, radius, intensity)
    brdf = _ggx_brdf(n, v, l, d.albedo, d.metalness, d.roughness)
    return brdf * color * atten[..., None]


def _directional(gb, d, lights, cfg, view_proj, eye, shadow_visibility, inv_vp):
    world = reconstruct_world_positions(gb.depth, view_proj, cfg, inv_vp)
    v = normalize_safe(eye - world)
    ldir = normalize_safe(-lights.direction)
    direct = _ggx_brdf(d.normal, v, ldir, d.albedo, d.metalness, d.roughness)
    if shadow_visibility is not None:
        direct = direct * shadow_visibility[..., None]
    return world, v, direct * lights.color


def _finish(radiance, d, gb, cfg):
    out = radiance + cfg.ambient * d.albedo
    return torch.where((gb.depth < 1.0)[..., None], out, torch.zeros((), dtype=F32, device=out.device))


def shade_pbr(
    gb: GBuffer, lights: Lights, cfg: RendererConfig, view_proj: torch.Tensor,
    eye: torch.Tensor, shadow_visibility: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unculled PBR shading (every light at every pixel) -> linear HDR
    [H, W, 3]: the exact baseline the tiled paths are held to."""
    d = decode_gbuffer(gb, cfg)
    world, v, radiance = _directional(gb, d, lights, cfg, view_proj, eye, shadow_visibility, None)
    for i in range(lights.num_point):
        radiance = radiance + _light_contrib(
            world, d.normal, v, d, lights.point_position[i], lights.point_color[i],
            lights.point_radius[i], lights.point_intensity[i],
        )
    return _finish(radiance, d, gb, cfg)


# ---------------------------------------------------------------------------
# Per-tile light culling
# ---------------------------------------------------------------------------


class TileLights(NamedTuple):
    indices: torch.Tensor   # [ty, tx, K] int32 light ids, live ones first, ascending
    counts: torch.Tensor    # [ty, tx] int32 live ids per tile (clamped to K)
    overflow: torch.Tensor  # [] int32 tiles whose live count exceeded K


def cull_lights_to_tiles(
    depth: torch.Tensor, lights: Lights, cfg: RendererConfig, view_proj: torch.Tensor,
    tile=32, max_per_tile: Optional[int] = None, inv_vp: Optional[torch.Tensor] = None,
) -> TileLights:
    """Light sphere vs tile world-AABB culling, exact against the covered
    pixels of each tile (see the module docstring).  `tile` is a square size
    or a (tile_h, tile_w) pair; empty tiles cull every light."""
    H, W = depth.shape
    dev = depth.device
    K = max_per_tile or cfg.max_lights_per_tile
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    ty, tx = -(-H // th), -(-W // tw)
    # Pad to whole tiles with background depth: padded pixels are uncovered.
    if (ty * th, tx * tw) != (H, W):
        depth = F.pad(depth, (0, tx * tw - W, 0, ty * th - H), value=1.0)
    d_t = depth.reshape(ty, th, tx, tw)
    inf = torch.full((), math.inf, dtype=F32, device=dev)
    zmin = d_t.amin(dim=(1, 3))
    has_geo = zmin < 1.0
    covered_t = d_t < 1.0
    zmax = torch.where(covered_t, d_t, -inf).amax(dim=(1, 3))
    zmax = torch.where(has_geo, zmax, zmin)

    ax = torch.arange(tx, dtype=F32, device=dev)
    ay = torch.arange(ty, dtype=F32, device=dev)
    xs0 = ax * tw * (2.0 / W) - 1.0
    xs1 = (ax + 1) * tw * (2.0 / W) - 1.0
    ys0 = 1.0 - (ay * th) * (2.0 / H)
    ys1 = 1.0 - ((ay + 1) * th) * (2.0 / H)
    if inv_vp is None:
        inv_vp = inverse_view_proj(view_proj)
    pos = lights.point_position  # [L, 3]
    r2 = lights.point_radius * lights.point_radius

    def sphere_hits_slab(z0, z1, alive):
        corners = torch.stack([
            _unproject(x[None, :], y[:, None], z, inv_vp)
            for x in (xs0, xs1) for y in (ys0, ys1) for z in (z0, z1)
        ])  # [8, ty, tx, 3]
        bmin = corners.amin(0)[:, :, None, :]
        bmax = corners.amax(0)[:, :, None, :]
        delta = torch.clamp(torch.maximum(bmin - pos, pos - bmax), min=0.0)  # [ty, tx, L, 3]
        return (_dot(delta, delta) <= r2) & alive[..., None]

    # Split each tile's slab at the world-depth midpoint (z = A + B / w for
    # the D3D perspective projection): the union of the two slabs' boxes is
    # still conservative and much tighter on deep tiles.
    A = cfg.z_far / (cfg.z_far - cfg.z_near)
    B = -cfg.z_far * cfg.z_near / (cfg.z_far - cfg.z_near)
    w0 = B / torch.clamp(zmin - A, max=-1e-12)
    w1 = B / torch.clamp(zmax - A, max=-1e-12)
    zmid = A + B / (0.5 * (w0 + w1))
    zmid = torch.minimum(torch.maximum(zmid, zmin), zmax)

    zm = zmid[:, None, :, None]
    lo = covered_t & (d_t <= zm)
    hi = covered_t & (d_t > zm)
    zmin_lo = torch.where(lo, d_t, inf).amin(dim=(1, 3))
    zmax_lo = torch.where(lo, d_t, -inf).amax(dim=(1, 3))
    zmin_hi = torch.where(hi, d_t, inf).amin(dim=(1, 3))
    zmax_hi = torch.where(hi, d_t, -inf).amax(dim=(1, 3))
    has_lo = torch.isfinite(zmin_lo)
    has_hi = torch.isfinite(zmin_hi)
    zmin_lo = torch.where(has_lo, zmin_lo, zmin)
    zmax_lo = torch.where(has_lo, zmax_lo, zmin)
    zmin_hi = torch.where(has_hi, zmin_hi, zmax)
    zmax_hi = torch.where(has_hi, zmax_hi, zmax)
    affects = sphere_hits_slab(zmin_lo, zmax_lo, has_geo & has_lo) | sphere_hits_slab(
        zmin_hi, zmax_hi, has_geo & has_hi
    )  # [ty, tx, L]

    # Compact to the first k ids in ascending order: live ids, then the rest.
    L = affects.shape[-1]
    k = min(K, L)
    lid = torch.arange(L, device=dev)
    idx = torch.sort(torch.where(affects, lid, L + lid), dim=-1).values[..., :k] % L
    true_counts = affects.sum(-1)
    return TileLights(
        indices=idx.to(torch.int32),
        counts=torch.clamp(true_counts, max=k).to(torch.int32),
        overflow=(true_counts > k).sum().to(torch.int32),
    )


def shade_pbr_tiled(
    gb: GBuffer, lights: Lights, cfg: RendererConfig, view_proj: torch.Tensor,
    eye: torch.Tensor, tile: int = 32, shadow_visibility: Optional[torch.Tensor] = None,
    return_overflow: bool = False, inv_vp: Optional[torch.Tensor] = None,
):
    """PBR shading with per-tile light culling -> linear HDR [H, W, 3].
    Equals shade_pbr when no tile's live-light count exceeds
    cfg.max_lights_per_tile; a tile over the cap drops its excess lights and
    counts in the overflow (returned with return_overflow=True).  inv_vp is
    the frame's inverse view-projection (computed here when None)."""
    d = decode_gbuffer(gb, cfg)
    if inv_vp is None:
        inv_vp = inverse_view_proj(view_proj)
    world, v, radiance = _directional(gb, d, lights, cfg, view_proj, eye, shadow_visibility, inv_vp)
    overflow = torch.zeros((), dtype=torch.int32, device=gb.depth.device)
    if lights.num_point:
        H, W = gb.depth.shape
        ty, tx = -(-H // tile), -(-W // tile)
        Hp, Wp = ty * tile, tx * tile
        tl = cull_lights_to_tiles(gb.depth, lights, cfg, view_proj, tile, inv_vp=inv_vp)
        overflow = tl.overflow

        def tiled(a):  # [H, W, C] -> [ty, tx, tile, tile, C], zero-padded border
            a = F.pad(a, (0, 0, 0, Wp - W, 0, Hp - H))
            return a.reshape(ty, tile, tx, tile, -1).permute(0, 2, 1, 3, 4)

        dt = type(d)(
            albedo=tiled(d.albedo), metalness=tiled(d.metalness[..., None])[..., 0],
            normal=tiled(d.normal), roughness=tiled(d.roughness[..., None])[..., 0],
        )
        wld_t, v_t = tiled(world), tiled(v)
        acc = tiled(radiance)
        zero = torch.zeros((), dtype=F32, device=acc.device)
        # Slots past every tile's count add exactly zero: stop at the largest.
        for k in range(int(tl.counts.max())):
            lid = tl.indices[:, :, k].long()
            live = (k < tl.counts)[:, :, None, None, None]

            def per_tile(a):
                return a[lid][:, :, None, None]

            contrib = _light_contrib(
                wld_t, dt.normal, v_t, dt, per_tile(lights.point_position),
                per_tile(lights.point_color), per_tile(lights.point_radius),
                per_tile(lights.point_intensity),
            )
            acc = acc + torch.where(live, contrib, zero)
        radiance = acc.permute(0, 2, 1, 3, 4).reshape(Hp, Wp, 3)[:H, :W]
    out = _finish(radiance, d, gb, cfg)
    return (out, overflow) if return_overflow else out
