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
- ``apply_normal_mapping`` perturbs a frame's fragment normals: through the
  bump kernel's wrapper ``bump_tiles`` with cfg.use_pallas and the inverse
  view-projection (world position from depth per tile, the fused
  renderer's sequence), else the block form over the given world
  positions (the JAX package's CPU path).

sin and rsqrt are taken in float64 and rounded once (xmath.sinf,
xmath.rsqrtf), in the plain versions and in the kernels alike; XLA's float32
sin and rsqrt are within 1 ULP of them, so the normals agree with the JAX
package to a few float32 ULP (tests/test_torch_bump.py states the bounds).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import RendererConfig
from ..xmath import rsqrtf, sinf
from .lighting_cuda import U_H, U_SIZE, U_W, _uniform_tail, world_from_depth
from .raster_ref import FragmentPlanes
from .raster_tiles import image_to_tiles, tile_pixels, tiles_to_image

F32 = torch.float32

# Input planes of the bump kernel (leading dim).
B_DEPTH, B_NX, B_U, B_MID = 0, 1, 4, 6
NUM_BUMP_PLANES = 7


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


def bump_tiles_reference(planes, uniforms, *, nty, ntx, tile_h, tile_w, strength, freq):
    """Plain version of the bump kernel.

    planes [7, Hp, Wp] f32: depth, normal xyz, u, v, mesh id (padding at
    depth 1, mesh id -1); uniforms [32] (the inverse view-projection and the
    frame size are read).  Per tile: world position from depth, pixels
    outside the frame count as background, bump_planar.  Returns the
    normals [3, Hp, Wp]."""
    p = image_to_tiles(planes, nty, ntx, tile_h, tile_w).reshape(NUM_BUMP_PLANES, -1, tile_h, tile_w)
    px, py = (a.reshape(-1, tile_h, tile_w) for a in tile_pixels(nty, ntx, tile_h, tile_w, planes.device))
    world = world_from_depth(uniforms, px, py, p[B_DEPTH])
    inside = (px < uniforms[U_W]) & (py < uniforms[U_H])
    mid = torch.where(inside, p[B_MID], torch.full_like(p[B_MID], -1.0))
    out = bump_planar(world, (p[B_U], p[B_U + 1]), (p[B_NX], p[B_NX + 1], p[B_NX + 2]), mid,
                      strength, freq)
    return tiles_to_image(torch.stack(out).reshape(3, -1, tile_h * tile_w), nty, ntx, tile_h, tile_w)


def bump_tiles(planes, uniforms, *, nty, ntx, tile_h, tile_w, strength, freq):
    """Bump kernel: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see bump_tiles_reference for the contract)."""
    kw = dict(nty=nty, ntx=ntx, tile_h=tile_h, tile_w=tile_w, strength=strength, freq=freq)
    if planes.device.type == "cpu":
        return bump_tiles_reference(planes, uniforms, **kw)
    from ..utils import cuda_build

    Hp, Wp = nty * tile_h, ntx * tile_w
    cuda_build.check_tensors(
        planes.device,
        planes=(planes, F32, (NUM_BUMP_PLANES, Hp, Wp)),
        uniforms=(uniforms, F32, (U_SIZE,)),
    )
    if tile_h * tile_w > 1024:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's 1024")
    if tile_h < 2 or tile_w < 2:
        raise ValueError("the bump kernel needs tiles of at least 2 x 2 pixels")
    out = torch.empty((3, Hp, Wp), dtype=F32, device=planes.device)
    err = cuda_build.library().bump_tiles_launch(
        planes.data_ptr(), uniforms.data_ptr(), nty, ntx, tile_h, tile_w,
        float(strength), 2.0 * math.pi * freq, out.data_ptr(),
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "bump_tiles")
    bump_tiles.launches += 1
    return out


bump_tiles.launches = 0


def bump_uniforms(inv_vp: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The [32] uniforms the bump kernel reads: the inverse view-projection
    and the frame size (every other field zero)."""
    z = torch.zeros((9,), dtype=F32, device=inv_vp.device)
    return torch.cat([inv_vp.reshape(-1), z, _uniform_tail(0.0, width, height, 0.0, inv_vp.device)])


def bump_planes(frags: FragmentPlanes, Hp: int, Wp: int) -> torch.Tensor:
    """The bump kernel's input planes [7, Hp, Wp] from a frame's fragments,
    padded to whole tiles with background (depth 1, mesh id -1, the rest 0)."""
    H, W = frags.depth.shape
    planes = torch.stack([frags.depth, *frags.normal.unbind(-1), *frags.uv.unbind(-1),
                          frags.mesh_id.to(F32)])
    planes = F.pad(planes, (0, Wp - W, 0, Hp - H))
    if (Hp, Wp) != (H, W):
        for p, fill in ((B_DEPTH, 1.0), (B_MID, -1.0)):
            planes[p, H:, :] = fill
            planes[p, :, W:] = fill
    return planes


def apply_normal_mapping(
    frags: FragmentPlanes, world_pos, cfg: RendererConfig, strength: float = 0.35,
    freq: float = 24.0, inv_vp=None,
) -> FragmentPlanes:
    """Perturb the fragment normals with the procedural height field.

    With cfg.use_pallas and the frame's inverse view-projection ``inv_vp``
    the bump kernel runs: world positions from depth per tile, as the fused
    renderer computes them (world_pos is not read).  Otherwise the block
    form over world_pos [H, W, 3]; out-of-frame padding is background either
    way, so a pixel on a partial block's frame edge keeps its normal."""
    H, W = frags.depth.shape
    bh, bw = cfg.tile_h, cfg.tile_w
    nby, nbx = -(-H // bh), -(-W // bw)
    Hp, Wp = nby * bh, nbx * bw
    if cfg.use_pallas and inv_vp is not None:
        out = bump_tiles(bump_planes(frags, Hp, Wp), bump_uniforms(inv_vp, W, H), nty=nby, ntx=nbx,
                         tile_h=bh, tile_w=bw, strength=strength, freq=freq)
        return frags._replace(normal=out[:, :H, :W].permute(1, 2, 0))

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
