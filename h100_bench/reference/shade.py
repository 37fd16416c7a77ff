"""The reference's passes after the raster: G-buffer, procedural bump,
shadow map PCF, Cook-Torrance lighting with every light at every pixel,
and the post chain.

Frozen copies of the renderer's plain semantics (the D3D12 reference's
render-target quantization, lighting.hlsl's decode, the windowed
inverse-square falloff that is zero at a light's radius, bilinear PCF with
a LESS_EQUAL comparison, bloom, Reinhard, gamma and FXAA), without the
renderer's capacity caps, tiling or culling: every light is evaluated at
every pixel, so a capped light or a wrong cull shows as a difference.
``shade_pbr`` takes the dtype of its arithmetic: float32, as the
configurations state it, or a lower precision for the control.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .xmath import divf, normalize, normalize_safe, powf, rsqrtf, sinf, matmul4_fma, look_at_lh

F32 = torch.float32


# ---- G-buffer (R8G8B8A8 / R10G10B10A2 round trip) ----

def quantize_unorm(x, bits: int):
    scale = float((1 << bits) - 1)
    return divf(torch.round(torch.clamp(x, 0.0, 1.0) * scale), scale)


def gbuffer(normal, mesh_id, albedo, metalness, roughness, quantize: bool):
    """(gb0 [H, W, 4], gb1 [H, W, 4]): albedo + metalness, encoded normal +
    roughness, 0 on the background."""
    covered = (mesh_id >= 0)[..., None]
    mid = torch.clamp(mesh_id, min=0).long()
    n = normalize_safe(normal)
    gb0 = torch.cat([albedo[mid], metalness[mid][..., None]], dim=-1)
    gb1 = torch.cat([n * 0.5 + 0.5, roughness[mid][..., None]], dim=-1)
    zero = torch.zeros((), dtype=F32, device=gb0.device)
    gb0 = torch.where(covered, gb0, zero)
    gb1 = torch.where(covered, gb1, zero)
    if quantize:
        gb0 = quantize_unorm(gb0, 8)
        gb1 = torch.cat([quantize_unorm(gb1[..., :3], 10), quantize_unorm(gb1[..., 3:], 2)], dim=-1)
    return gb0, gb1


def world_positions(depth, inv_vp):
    """World position [H, W, 3] of each pixel centre at its depth."""
    H, W = depth.shape
    dev = depth.device
    xs = (torch.arange(W, dtype=F32, device=dev) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (torch.arange(H, dtype=F32, device=dev) + 0.5) * (2.0 / H)
    x, y = xs[None, :], ys[:, None]
    h = [((x * inv_vp[0, j] + y * inv_vp[1, j]) + depth * inv_vp[2, j]) + inv_vp[3, j] for j in range(4)]
    return torch.stack(h[:3], dim=-1) / h[3][..., None]


# ---- procedural bump (screen-space derivatives inside tile_h x tile_w blocks) ----

def _ddx(a):
    d = a[..., :, 1:] - a[..., :, :-1]
    return torch.cat([d, d[..., :, -1:]], dim=-1)


def _ddy(a):
    d = a[..., 1:, :] - a[..., :-1, :]
    return torch.cat([d, d[..., -1:, :]], dim=-2)


def _inv_len(x2, small):
    guard = x2 == 0.0 if small == 0.0 else x2 < small
    return torch.where(guard, torch.ones_like(x2), rsqrtf(torch.clamp(x2, min=1e-38)))


def _bump_blocks(world, uv, n, mid, strength, freq):
    wx, wy, wz = world
    u, v = uv
    nx, ny, nz = n
    dp_dx = (_ddx(wx), _ddx(wy), _ddx(wz))
    dp_dy = (_ddy(wx), _ddy(wy), _ddy(wz))
    du_dx, dv_dx, du_dy, dv_dy = _ddx(u), _ddx(v), _ddy(u), _ddy(v)
    det = du_dx * dv_dy - dv_dx * du_dy
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    T = tuple((dp_dx[i] * dv_dy - dp_dy[i] * dv_dx) * inv for i in range(3))
    B = tuple((dp_dy[i] * du_dx - dp_dx[i] * du_dy) * inv for i in range(3))
    w = 2.0 * math.pi * freq
    s_sum, s_dif = sinf(w * (v + u)), sinf(w * (v - u))
    dh_du, dh_dv = 0.5 * (s_sum + s_dif), 0.5 * (s_sum - s_dif)
    inv_nlen = _inv_len(nx * nx + ny * ny + nz * nz, 0.0)
    nu = (nx * inv_nlen, ny * inv_nlen, nz * inv_nlen)

    def tangentize(t):
        dot = t[0] * nu[0] + t[1] * nu[1] + t[2] * nu[2]
        t = tuple(t[i] - dot * nu[i] for i in range(3))
        inv_t = _inv_len(t[0] * t[0] + t[1] * t[1] + t[2] * t[2], 1e-24)
        return tuple(c * inv_t for c in t)

    Tt, Bt = tangentize(T), tangentize(B)
    pert = tuple(nu[i] - strength * (dh_du * Tt[i] + dh_dv * Bt[i]) for i in range(3))
    inv_pn = _inv_len(pert[0] * pert[0] + pert[1] * pert[1] + pert[2] * pert[2], 0.0)
    pert = tuple(c * inv_pn for c in pert)
    sx = mid[..., :, 1:] == mid[..., :, :-1]
    sy = mid[..., 1:, :] == mid[..., :-1, :]
    same_x = torch.cat([sx, sx[..., :, -1:]], dim=-1)
    same_y = torch.cat([sy, sy[..., -1:, :]], dim=-2)
    ok = (mid >= 0.0) & same_x & same_y & (torch.abs(det) >= 1e-12)
    return tuple(torch.where(ok, pert[i], n[i]) for i in range(3))


def bump(normal, uv, mesh_id, world, block_h, block_w, strength, freq):
    """Normals [H, W, 3] perturbed by the height field sin(2 pi f u)
    sin(2 pi f v) / (2 pi f), derivatives clamped at block edges; pixels
    whose taps cross meshes or the background keep their normal."""
    H, W = mesh_id.shape
    nby, nbx = -(-H // block_h), -(-W // block_w)
    Hp, Wp = nby * block_h, nbx * block_w

    def blocks(a, fill):
        a = F.pad(a, (0, Wp - W, 0, Hp - H), value=fill)
        return a.reshape(nby, block_h, nbx, block_w).transpose(1, 2)

    def unblocks(a):
        return a.transpose(1, 2).reshape(Hp, Wp)[:H, :W]

    out = _bump_blocks(tuple(blocks(world[..., i], 0.0) for i in range(3)),
                       tuple(blocks(uv[..., i], 0.0) for i in range(2)),
                       tuple(blocks(normal[..., i], 0.0) for i in range(3)),
                       blocks(mesh_id.to(F32), -1.0), strength, freq)
    return torch.stack([unblocks(c) for c in out], dim=-1)


# ---- shadow map and PCF ----

@functools.lru_cache(maxsize=None)
def _ortho(extent: float, z_near: float, z_far: float, device) -> torch.Tensor:
    zr = 1.0 / (z_far - z_near)
    m = torch.zeros((4, 4), dtype=F32)
    m[0, 0] = 2.0 / extent
    m[1, 1] = 2.0 / extent
    m[2, 2] = zr
    m[3, 2] = -z_near * zr
    m[3, 3] = 1.0
    return m.to(device)


def light_view_proj(direction, extent: float = 24.0, distance: float = 30.0):
    """Orthographic view-projection of a box around the origin seen along
    the light direction; up is +x where the light is within ~8 degrees of
    vertical."""
    dev = direction.device
    center = torch.zeros((3,), dtype=F32, device=dev)
    d = normalize(direction)
    eye = center - d * distance
    up = torch.tensor((1.0, 0.0, 0.0) if abs(float(d[1])) > 0.99 else (0.0, 1.0, 0.0), dtype=F32, device=dev)
    return matmul4_fma(look_at_lh(eye, center, up), _ortho(extent, 0.1, distance * 2.0, dev))


def pcf_visibility(depth, inv_vp, shadow_depth, light_vp, bias: float = 2e-3):
    """Visibility [H, W] of the directional light: at each pixel's
    light-space position the LESS_EQUAL comparison at the 2x2 bilinear
    footprint (CLAMP addressing), weighted bilinearly; 1 outside the light
    frustum."""
    H, W = depth.shape
    dev = depth.device
    M = matmul4_fma(inv_vp, light_vp)
    xs = (torch.arange(W, dtype=F32, device=dev) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (torch.arange(H, dtype=F32, device=dev) + 0.5) * (2.0 / H)
    x, y = xs[None, :], ys[:, None]
    lc = [((x * M[0, j] + y * M[1, j]) + depth * M[2, j]) + M[3, j] for j in range(4)]
    w = torch.clamp(lc[3], min=1e-8)
    nx, ny, z = lc[0] / w, lc[1] / w, lc[2] / w
    Ht, Wt = shadow_depth.shape
    fx = (nx + 1.0) * 0.5 * Wt - 0.5
    fy = (1.0 - ny) * 0.5 * Ht - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0

    def texel(f, n):
        return torch.clamp(torch.nan_to_num(f, nan=0.0), -1.0, float(n - 1)).long()

    xi, yi = texel(x0, Wt), texel(y0, Ht)
    xs_ = (torch.clamp(xi, 0, Wt - 1), torch.clamp(xi + 1, 0, Wt - 1))
    ys_ = (torch.clamp(yi, 0, Ht - 1), torch.clamp(yi + 1, 0, Ht - 1))
    c = [(z <= shadow_depth[yy, xx] + bias).to(F32) for yy in ys_ for xx in xs_]
    top = c[0] + (c[1] - c[0]) * tx
    bot = c[2] + (c[3] - c[2]) * tx
    vis = top + (bot - top) * ty
    inside = (nx >= -1.0) & (nx <= 1.0) & (ny >= -1.0) & (ny <= 1.0) & (z >= 0.0) & (z <= 1.0)
    return torch.where(inside, vis, torch.ones((), dtype=F32, device=dev))


# ---- Cook-Torrance lighting ----

def _dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _ggx(n, v, l, albedo, metalness, roughness, unit=normalize_safe):
    h = unit(v + l)
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ndv = torch.clamp(_dot(n, v), min=1e-4)
    ndh = torch.clamp(_dot(n, h), min=0.0)
    vdh = torch.clamp(_dot(v, h), min=0.0)
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / (math.pi * denom * denom)
    k = (roughness + 1.0) ** 2 / 8.0
    G = (ndv / (ndv * (1.0 - k) + k)) * (ndl / (ndl * (1.0 - k) + k + 1e-7))
    m = metalness[..., None]
    f0 = 0.04 * (1.0 - m) + albedo * m
    Fr = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)[..., None]
    spec = (D * G)[..., None] * Fr / (4.0 * ndv * ndl + 1e-4)[..., None]
    diffuse = (1.0 - Fr) * (1.0 - m) * albedo / math.pi
    return (diffuse + spec) * ndl[..., None]


def shade_pbr(gb0, gb1, depth, world, eye, lights: dict, cfg, visibility=None, dtype=F32):
    """Linear HDR [H, W, 3] float32: ambient + the directional light (times
    the visibility) + every point light, each GGX, on the decoded G-buffer;
    0 on the background.  The arithmetic runs in `dtype`."""
    cast = lambda a: a.to(dtype)  # noqa: E731
    unit = lambda a: cast(normalize_safe(a))  # noqa: E731  (its lengths round through float64)
    albedo = cast(powf(torch.clamp(gb0[..., :3], min=0.0), cfg.gamma))
    metal, rough = cast(gb0[..., 3]), cast(gb1[..., 3])
    n = unit(gb1[..., :3] * 2.0 - 1.0)
    world = cast(world)
    v = unit(cast(eye) - world)
    ldir = unit(cast(-lights["lights.direction"]))
    direct = _ggx(n, v, ldir, albedo, metal, rough, unit)
    if visibility is not None:
        direct = direct * cast(visibility)[..., None]
    radiance = direct * cast(lights["lights.color"])
    pos, col = cast(lights["lights.point_position"]), cast(lights["lights.point_color"])
    rad, inten = cast(lights["lights.point_radius"]), cast(lights["lights.point_intensity"])
    for i in range(pos.shape[0]):
        to_l = pos[i] - world
        dist = torch.sqrt(_dot(to_l, to_l))
        l = to_l / torch.clamp(dist, min=1e-6)[..., None]
        window = torch.clamp(1.0 - (dist / rad[i]) ** 4, 0.0, 1.0) ** 2
        atten = inten[i] * window / (dist * dist + 1.0)
        radiance = radiance + _ggx(n, v, l, albedo, metal, rough, unit) * col[i] * atten[..., None]
    out = (radiance + cfg.ambient * albedo).to(F32)
    return torch.where((depth < 1.0)[..., None], out, torch.zeros((), dtype=F32, device=out.device))


# ---- post chain ----

@functools.lru_cache(maxsize=None)
def _gaussian(sigma: float, radius: int) -> tuple:
    x = torch.arange(-radius, radius + 1, dtype=F32)
    k = torch.exp((-0.5 * (x / sigma) ** 2).double()).float()
    s = k[0]
    for t in k[1:]:
        s = s + t
    return tuple(float(w) for w in k / s)


def bloom(hdr, threshold: float, strength: float, sigma: float = 4.0, radius: int = 8, down: int = 4):
    """Threshold, 4x point downsample, separable gaussian (edge-clamped),
    nearest upsample, additive blend; [H, W, 3]."""
    H, W = hdr.shape[0], hdr.shape[1]
    img = torch.clamp(hdr - threshold, min=0.0)[::down, ::down]
    k = _gaussian(sigma, radius)
    for dim in (0, 1):
        n = img.shape[dim]
        idx = torch.clamp(torch.arange(-radius, n + radius, device=img.device), 0, n - 1)
        x = img.index_select(dim, idx)
        acc = None
        for i, w in enumerate(k):
            t = x.narrow(dim, i, n) * w
            acc = t if acc is None else acc + t
        img = acc
    up = img.repeat_interleave(down, 0).repeat_interleave(down, 1)
    return hdr + strength * up[:H, :W]


def fxaa(color, threshold: float = 0.0312, relative_threshold: float = 0.125):
    """Luma edge detect, then a blend toward the 4-neighbour average along
    the edge; edge-clamped taps."""
    def shift(a, dy, dx):
        H, W = a.shape[0], a.shape[1]
        ys = torch.clamp(torch.arange(H, device=a.device) - dy, 0, H - 1)
        xs = torch.clamp(torch.arange(W, device=a.device) - dx, 0, W - 1)
        return a.index_select(0, ys).index_select(1, xs)

    lum = color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114
    lN, lS, lW, lE = shift(lum, 1, 0), shift(lum, -1, 0), shift(lum, 0, 1), shift(lum, 0, -1)
    lmin = torch.minimum(lum, torch.minimum(torch.minimum(lN, lS), torch.minimum(lW, lE)))
    lmax = torch.maximum(lum, torch.maximum(torch.maximum(lN, lS), torch.maximum(lW, lE)))
    contrast = lmax - lmin
    edge = contrast >= torch.clamp(relative_threshold * lmax, min=threshold)
    cN, cS, cW, cE = shift(color, 1, 0), shift(color, -1, 0), shift(color, 0, 1), shift(color, 0, -1)
    avg = divf((((color + cN) + cS) + cW) + cE, 5.0)
    blend = torch.clamp(contrast / torch.clamp(lmax, min=1e-5), 0.0, 0.75)
    return torch.where(edge[..., None], color + (avg - color) * blend[..., None], color)


def post(hdr, cfg):
    """HDR [H, W, 3] -> uint8 [H, W, 3]: bloom, Reinhard, gamma, FXAA, round."""
    x = hdr
    if cfg.bloom:
        x = bloom(x, cfg.bloom_threshold, cfg.bloom_strength)
    if cfg.tonemap == "reinhard":
        x = x / (1.0 + x)
    x = powf(torch.clamp(x, min=0.0), 1.0 / cfg.gamma)
    if cfg.fxaa:
        x = fxaa(x)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
