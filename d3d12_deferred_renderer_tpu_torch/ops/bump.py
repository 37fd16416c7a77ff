"""Procedural normal mapping (BASELINE config 4).

The counterpart of d3d12_deferred_renderer_tpu/ops/bump.py: screen-space
derivative bump mapping (Mikkelsen, "Bump Mapping Unparametrized Surfaces
on the GPU") with an analytic height field of uv.  Tangent and bitangent
come per pixel from forward differences of the world position and uv,
taken inside (tile_h, tile_w) screen blocks and clamped at block edges (the
last column and row reuse the previous difference), so the fused tile
renderer computes the same normals from its own tile alone.

- ``bump_planar`` is the per-block body, in plain PyTorch over [..., h, w]
  planes; csrc/bump.cuh is its device version, which the bump kernel
  (csrc/bump.cu) and the fused tile renderer (csrc/fused.cu) include.
- ``bump_tiles`` is the bump kernel's wrapper (csrc/bump.cu; plain version
  ``bump_tiles_reference``): with cfg.use_pallas the staged frame and the
  staged band run it on the tile raster's planes, in place, before they
  are cropped to fragments (raster_tiles.rasterize_binned), world
  position from depth per tile, the fused renderer's sequence.  Its band
  mode takes the band's first row y0; the frame's width and height stay
  the full frame's.
- ``apply_normal_mapping`` perturbs a frame's fragment normals in the
  block form over the given world positions (the JAX package's CPU path).

sin and rsqrt are taken in float64 and rounded once (xmath.sinf,
xmath.rsqrtf) in the plain versions; the kernels take sin the same way and
rsqrt correctly rounded in float32, which equals the float64 route on every
float32 input (``rsqrt_mismatches`` counts the inputs where it does not, on
the card).  XLA's float32 sin and rsqrt are within 1 ULP of them, so the
normals agree with the JAX package to a few float32 ULP
(tests/test_torch_bump.py states the bounds).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import RendererConfig
from ..xmath import rsqrtf, sinf
from .lighting_cuda import U_H, U_INV_VP, U_SIZE, U_W, world_from_depth
from .raster_ref import FragmentPlanes
from .raster_tiles import (
    NUM_PLANES, PLANE_DEPTH, PLANE_MID, PLANE_NX, PLANE_NZ, PLANE_U, PLANE_V, check_band_rows, image_to_tiles,
    tile_pixels, tiles_to_image,
)

F32 = torch.float32


def _ddx_p(a):
    """Forward difference along the last axis, edge-clamped; [..., h, w]."""
    d = a[..., :, 1:] - a[..., :, :-1]
    return torch.cat([d, d[..., :, -1:]], dim=-1)


def _ddy_p(a):
    d = a[..., 1:, :] - a[..., :-1, :]
    return torch.cat([d, d[..., -1:, :]], dim=-2)


def procedural_height_gradient(u, v, freq: float = 24.0):
    """dh/du, dh/dv of h(u, v) = sin(2 pi f u) sin(2 pi f v) / (2 pi f), by
    the product-to-sum identity (two sines a pixel)."""
    w = 2.0 * math.pi * freq
    s_sum = sinf(w * (v + u))
    s_dif = sinf(w * (v - u))
    return 0.5 * (s_sum + s_dif), 0.5 * (s_sum - s_dif)


def _inv_len(x2, small):
    """1 / sqrt(x2), 1 where x2 is below `small` (0: exactly zero)."""
    guard = x2 == 0.0 if small == 0.0 else x2 < small
    return torch.where(guard, torch.ones_like(x2), rsqrtf(torch.clamp(x2, min=1e-38)))


def bump_planar(world, uv, n, mid, strength: float, freq: float):
    """Perturb normals within one derivative block (channel-planar form).

    world = (wx, wy, wz), uv = (u, v), n = (nx, ny, nz): [..., h, w] planes,
    (h, w) the derivative block; ``mid`` the mesh id as a float, -1 for
    background.  Returns the perturbed (nx, ny, nz); pixels whose
    derivative taps cross meshes or background, or whose uv mapping is
    degenerate, keep their geometric normal."""
    wx, wy, wz = world
    u, v = uv
    nx, ny, nz = n
    dp_dx = (_ddx_p(wx), _ddx_p(wy), _ddx_p(wz))
    dp_dy = (_ddy_p(wx), _ddy_p(wy), _ddy_p(wz))
    du_dx, dv_dx = _ddx_p(u), _ddx_p(v)
    du_dy, dv_dy = _ddy_p(u), _ddy_p(v)

    # Tangents T = d world / d u and B = d world / d v from the 2x2 system.
    det = du_dx * dv_dy - dv_dx * du_dy
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    T = tuple((dp_dx[i] * dv_dy - dp_dy[i] * dv_dx) * inv for i in range(3))
    B = tuple((dp_dy[i] * du_dx - dp_dx[i] * du_dy) * inv for i in range(3))
    dh_du, dh_dv = procedural_height_gradient(u, v, freq)

    inv_nlen = _inv_len(nx * nx + ny * ny + nz * nz, 0.0)
    nu = (nx * inv_nlen, ny * inv_nlen, nz * inv_nlen)

    def tangentize(t):  # off the normal, then unit length
        dot = t[0] * nu[0] + t[1] * nu[1] + t[2] * nu[2]
        t = tuple(t[i] - dot * nu[i] for i in range(3))
        inv_t = _inv_len(t[0] * t[0] + t[1] * t[1] + t[2] * t[2], 1e-24)
        return tuple(c * inv_t for c in t)

    Tt, Bt = tangentize(T), tangentize(B)
    pert = tuple(nu[i] - strength * (dh_du * Tt[i] + dh_dv * Bt[i]) for i in range(3))
    inv_pn = _inv_len(pert[0] * pert[0] + pert[1] * pert[1] + pert[2] * pert[2], 0.0)
    pert = tuple(c * inv_pn for c in pert)

    # Same mesh under every derivative tap; the edge replicates the last
    # comparison, as the differences replicate the last difference.
    sx = mid[..., :, 1:] == mid[..., :, :-1]
    sy = mid[..., 1:, :] == mid[..., :-1, :]
    same_x = torch.cat([sx, sx[..., :, -1:]], dim=-1)
    same_y = torch.cat([sy, sy[..., -1:, :]], dim=-2)
    ok = (mid >= 0.0) & same_x & same_y & (torch.abs(det) >= 1e-12)
    return tuple(torch.where(ok, pert[i], n[i]) for i in range(3))


# --------------------------------------------------------------------------
# The bump kernel: plain version and wrapper
# --------------------------------------------------------------------------


def bump_tiles_reference(planes, inv_vp, *, width, height, y0=0, tile_h, tile_w, strength, freq):
    """Plain version of the bump kernel: the normals of the tile raster's
    planes perturbed in place.

    planes [8, Hp, Wp] f32 in the tile raster's layout (raster_tiles.PLANE_*:
    depth, normal xyz, u, v, mesh id, pad) on tile_h x tile_w tiles: rows
    [y0, y0 + Hp) of a width x height frame; inv_vp [4, 4] the frame's
    inverse view-projection.  Per tile: world position from depth, pixels
    outside the frame as background, bump_planar; the normal planes take
    the result, and a pixel that is not perturbed keeps its normal.
    Returns planes."""
    _, Hp, Wp = planes.shape
    nty, ntx = Hp // tile_h, Wp // tile_w
    p = image_to_tiles(planes[: PLANE_MID + 1], nty, ntx, tile_h, tile_w).reshape(PLANE_MID + 1, -1, tile_h, tile_w)
    px, py = (a.reshape(-1, tile_h, tile_w) for a in tile_pixels(nty, ntx, tile_h, tile_w, planes.device, y0))
    u = torch.zeros((U_SIZE,), dtype=F32, device=planes.device)
    u[U_INV_VP : U_INV_VP + 16] = inv_vp.reshape(-1)
    u[U_W], u[U_H] = float(width), float(height)
    world = world_from_depth(u, px, py, p[PLANE_DEPTH])
    inside = (px < u[U_W]) & (py < u[U_H])
    mid = torch.where(inside, p[PLANE_MID], torch.full_like(p[PLANE_MID], -1.0))
    out = bump_planar(world, (p[PLANE_U], p[PLANE_V]), tuple(p[PLANE_NX : PLANE_NZ + 1]), mid, strength, freq)
    planes[PLANE_NX : PLANE_NZ + 1] = tiles_to_image(torch.stack(out).reshape(3, -1, tile_h * tile_w),
                                                     nty, ntx, tile_h, tile_w)
    return planes


def bump_tiles(planes, inv_vp, *, width, height, y0=0, tile_h, tile_w, strength, freq):
    """Bump kernel: perturbs the normals of the tile raster's planes in
    place and returns planes; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see bump_tiles_reference for the contract)."""
    kw = dict(width=width, height=height, y0=y0, tile_h=tile_h, tile_w=tile_w, strength=strength, freq=freq)
    if planes.device.type == "cpu":
        return bump_tiles_reference(planes, inv_vp, **kw)
    from ..utils import cuda_build

    cuda_build.check_tensors(planes.device, planes=(planes, F32, (NUM_PLANES, None, None)))
    if inv_vp.device != planes.device or inv_vp.dtype != F32 or inv_vp.shape != (4, 4):
        raise ValueError(f"inv_vp must be a float32 [4, 4] tensor on {planes.device}")
    _, Hp, Wp = planes.shape
    if Hp % tile_h or Wp % tile_w:
        raise ValueError(f"planes of {Hp}x{Wp} are not whole {tile_h}x{tile_w} tiles")
    if tile_h * tile_w > 1024:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's 1024")
    if tile_h < 2 or tile_w < 2:
        raise ValueError("the bump kernel needs tiles of at least 2 x 2 pixels")
    check_band_rows(y0, Hp)
    err = cuda_build.library().bump_tiles_launch(
        planes.data_ptr(), inv_vp.data_ptr(), inv_vp.stride(0), inv_vp.stride(1), Hp // tile_h, Wp // tile_w,
        tile_h, tile_w, y0, float(width), float(height), float(strength), 2.0 * math.pi * freq,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "bump_tiles")
    bump_tiles.launches += 1
    return planes


bump_tiles.launches = 0


def rsqrt_mismatches(device) -> int:
    """The bump kernels' rsqrt (csrc/bump.cuh: the correctly rounded float32
    one) against the plain versions' xmath.rsqrtf (float64 1 / sqrt, rounded
    once), on the CUDA `device`: the count of float32 inputs, over every bit
    pattern with the sign bit clear (zero, subnormals, normals, inf, NaN),
    whose two results differ in their bits (a NaN matches a NaN).  The
    kernels' normals equal the plain versions' only where it is 0."""
    from ..utils import cuda_build

    count = torch.zeros((1,), dtype=torch.int64, device=device)
    err = cuda_build.library().bump_rsqrt_check_launch(
        0, 1 << 31, count.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    cuda_build.raise_on_error(err, "bump_rsqrt_check")
    return int(count)


def apply_normal_mapping(
    frags: FragmentPlanes, world_pos, cfg: RendererConfig, strength: float = 0.35, freq: float = 24.0,
) -> FragmentPlanes:
    """Perturb the fragment normals with the procedural height field: the
    block form over world_pos [H, W, 3] (the JAX package's CPU path; the
    kernel path bumps the tile raster's planes, bump_tiles).  Out-of-frame
    padding is background, so a pixel on a partial block's frame edge
    keeps its normal."""
    H, W = frags.depth.shape
    bh, bw = cfg.tile_h, cfg.tile_w
    nby, nbx = -(-H // bh), -(-W // bw)
    Hp, Wp = nby * bh, nbx * bw

    def blocks(a, fill):  # [H, W] -> [nby, nbx, bh, bw]
        a = F.pad(a, (0, Wp - W, 0, Hp - H), value=fill)
        return a.reshape(nby, bh, nbx, bw).transpose(1, 2)

    def unblocks(a):
        return a.transpose(1, 2).reshape(Hp, Wp)[:H, :W]

    world = tuple(blocks(world_pos[..., i], 0.0) for i in range(3))
    uv = tuple(blocks(frags.uv[..., i], 0.0) for i in range(2))
    n = tuple(blocks(frags.normal[..., i], 0.0) for i in range(3))
    mid = blocks(frags.mesh_id.to(F32), -1.0)
    out = bump_planar(world, uv, n, mid, strength, freq)
    return frags._replace(normal=torch.stack([unblocks(c) for c in out], dim=-1))
