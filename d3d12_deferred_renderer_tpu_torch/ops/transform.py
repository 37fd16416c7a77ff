"""Vertex transform and triangle setup — the fixed-function front of the frame.

What D3D12 does in the input assembler, vertex shader and primitive setup
(geometry.hlsl:27-40; rasterizer state main.cpp:725-766): transform every
triangle corner to clip space and its normal to world space, clip against the
near plane into two static slots, divide by w, apply the viewport (y flipped,
pixel centers at +0.5), cull back faces (FrontCounterClockwise=TRUE), make the
winding positive and pack one 32-float record per slot.  The counterpart of
d3d12_deferred_renderer_tpu/ops/transform.py (the face-vertex column path).

``setup_triangles_reference`` is the plain PyTorch version of the setup
kernel (csrc/setup.cu); ``setup_frame_triangles`` goes through the wrapper in
setup_cuda.py, which runs the kernel on a CUDA tensor and this plain version
on a CPU tensor.  Every sum below is written in a fixed order, and the kernel
repeats that order with FMA contraction off, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import xmath
from ..config import RendererConfig
from ..scene import SceneState

# Packed triangle-record layout (float32 fields of one [TRI_STRIDE] row).
TRI_X0, TRI_Y0, TRI_X1, TRI_Y1, TRI_X2, TRI_Y2 = 0, 1, 2, 3, 4, 5
TRI_Z0, TRI_Z1, TRI_Z2 = 6, 7, 8
TRI_RW0, TRI_RW1, TRI_RW2 = 9, 10, 11
TRI_N0 = 12  # 12-14: normal0 * rw0
TRI_N1 = 15  # 15-17
TRI_N2 = 18  # 18-20
TRI_UV0 = 21  # 21-22: uv0 * rw0
TRI_UV1 = 23  # 23-24
TRI_UV2 = 25  # 25-26
TRI_MESH_ID = 27
TRI_VALID = 28
TRI_AREA = 29  # canonical (positive) doubled area
TRI_STRIDE = 32

CULL_MODES = ("none", "back", "front")


class TriSetup(NamedTuple):
    packed: torch.Tensor  # [2T, TRI_STRIDE] f32; slots 2t, 2t+1 from triangle t
    aabb: torch.Tensor    # [2T, 4] f32: minx, miny, maxx, maxy, clipped to the screen
    valid: torch.Tensor   # [2T] bool


def camera_matrices(state: SceneState, cfg: RendererConfig):
    """View and projection matrices from the scene camera (main.cpp:214-224)."""
    cam = state.camera
    view = xmath.look_at_lh(cam.eye, cam.at, cam.up)
    proj = xmath.perspective_fov_lh(
        cfg.fov_y, cfg.aspect, cfg.z_near, cfg.z_far, device=cam.eye.device
    )
    return view, proj


def _fv_transform_cols(pos_cols, nrm_cols, tri_mesh_id, mvp, model):
    """Clip positions [3, 4, T] and world normals [3, 3, T] of every corner,
    with each triangle's matrices selected by its mesh id.
    Row-vector convention: clip[c] = sum_k pos_h[k] * mvp[k, c], pos_h[3] = 1;
    normals go through the model matrix, not its inverse-transpose (a
    reference quirk, geometry.hlsl:37).  Without normals (nrm_cols None,
    depth-only passes) the normals come back None."""
    idx = tri_mesh_id.long()
    sC = mvp.reshape(mvp.shape[0], 16)[idx].T.reshape(4, 4, -1)
    p = pos_cols
    c = (
        p[:, 0, None, :] * sC[0][None]
        + p[:, 1, None, :] * sC[1][None]
        + p[:, 2, None, :] * sC[2][None]
        + sC[3][None]
    )
    if nrm_cols is None:
        return c, None
    sN = model[:, :3, :3].reshape(model.shape[0], 9)[idx].T.reshape(3, 3, -1)
    nr = nrm_cols
    n = (
        nr[:, 0, None, :] * sN[0][None]
        + nr[:, 1, None, :] * sN[1][None]
        + nr[:, 2, None, :] * sN[2][None]
    )
    return c, n


def _clip_near_plane_stack(c, n, uv):
    """Clip against the near plane (clip z = 0) into EXACTLY two output slots
    per triangle: fully inside -> (itself, degenerate); one vertex inside ->
    (clipped triangle, degenerate); two inside -> the two triangles of the
    clipped quad; none inside -> two degenerates.  A cyclic vertex rotation
    keeps the winding; attributes lerp in clip space.

    Inputs [3, C, T]; outputs [3, C, 2T] with slot pairs interleaved.  `n`
    and `uv` may be None (depth-only passes) and come back None."""
    z0, z1, z2 = c[0, 2], c[1, 2], c[2, 2]
    in0, in1, in2 = z0 >= 0.0, z1 >= 0.0, z2 >= 0.0
    n_in = in0.int() + in1.int() + in2.int()
    T = z0.shape[0]

    def pick3(m0, m1):
        return torch.where(m0, 0, torch.where(m1, 1, 2))

    first_in = pick3(in0, in1)
    first_out = pick3(~in0, ~in1)
    r = torch.where(n_in == 1, first_in, torch.where(n_in == 2, (first_out + 1) % 3, 0))

    def rot(a):  # rotated[v] = a[(v + r) % 3]
        if a is None:
            return None
        a1 = torch.cat([a[1:], a[:1]], 0)
        a2 = torch.cat([a[2:], a[:2]], 0)
        return torch.where(r == 0, a, torch.where(r == 1, a1, a2))

    c, n, uv = rot(c), rot(n), rot(uv)
    zA, zB, zC = c[0, 2], c[1, 2], c[2, 2]

    def lerp_t(za, zb):
        d = za - zb
        return za / torch.where(d == 0.0, torch.ones_like(d), d)

    tAB, tAC, tBC = lerp_t(zA, zB), lerp_t(zA, zC), lerp_t(zB, zC)
    sel1, sel2, sel3 = n_in == 1, n_in == 2, n_in == 3

    def clip_attr(a):
        if a is None:
            return None
        A, B, C = a[0], a[1], a[2]
        AB = A + (B - A) * tAB
        AC = A + (C - A) * tAC
        BC = B + (C - B) * tBC
        # n_in 3: (A,B,C); 2: (A,B,BC)+(A,BC,AC); 1: (A,AB,AC); 0: (A,A,A)
        s0v1 = torch.where(sel3 | sel2, B, torch.where(sel1, AB, A))
        s0v2 = torch.where(sel3, C, torch.where(sel2, BC, torch.where(sel1, AC, A)))
        s1v1 = torch.where(sel2, BC, A)
        s1v2 = torch.where(sel2, AC, A)
        s0 = torch.stack([A, s0v1, s0v2])
        s1 = torch.stack([A, s1v1, s1v2])
        return torch.stack([s0, s1], -1).reshape(3, a.shape[1], 2 * T)

    return clip_attr(c), clip_attr(n), clip_attr(uv)


def _setup_cols(c, n, uv, tri_mesh_id, width, height, cull="back"):
    """Near clip, viewport, cull, canonical winding and record packing over
    stacked columns: c [3, 4, T], n [3, 3, T], uv [3, 2, T].  With n and uv
    None (depth-only passes: the shadow map) record fields 12-26 are zero."""
    if cull not in CULL_MODES:
        raise ValueError(f"unknown cull mode {cull!r}")
    W, H = width, height
    c, n, uv = _clip_near_plane_stack(c, n, uv)
    mesh_id = tri_mesh_id.repeat_interleave(2)

    w = c[:, 3]  # [3, 2T]
    w_ok = (w[0] > 1e-6) & (w[1] > 1e-6) & (w[2] > 1e-6)
    rw = 1.0 / torch.where(w == 0.0, torch.ones_like(w), w)
    sx = (c[:, 0] * rw + 1.0) * (W * 0.5)  # D3D viewport (main.cpp:90): y flips
    sy = (1.0 - c[:, 1] * rw) * (H * 0.5)
    sz = c[:, 2] * rw

    # Signed doubled area in y-down render-target space.
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    front = area2 < 0.0  # FrontCounterClockwise=TRUE (main.cpp:728)
    keep = {"back": front, "front": ~front, "none": torch.ones_like(front)}[cull]
    valid = w_ok & keep & (area2 != 0.0)

    minx = torch.minimum(torch.minimum(sx[0], sx[1]), sx[2])
    maxx = torch.maximum(torch.maximum(sx[0], sx[1]), sx[2])
    miny = torch.minimum(torch.minimum(sy[0], sy[1]), sy[2])
    maxy = torch.maximum(torch.maximum(sy[0], sy[1]), sy[2])
    on_screen = (maxx >= 0.0) & (minx < W) & (maxy >= 0.0) & (miny < H)
    z_ok = (torch.maximum(torch.maximum(sz[0], sz[1]), sz[2]) >= 0.0) & (
        torch.minimum(torch.minimum(sz[0], sz[1]), sz[2]) <= 1.0
    )
    valid = valid & on_screen & z_ok

    # Canonical positive winding: swap v1 <-> v2 when the area is negative.
    swap = area2 < 0.0

    def pick(a):
        return (a[0], torch.where(swap, a[2], a[1]), torch.where(swap, a[1], a[2]))

    psx, psy, pz, prw = pick(sx), pick(sy), pick(sz), pick(rw)
    area_c = torch.abs(area2)
    zero = torch.zeros_like(area_c)
    rows = [psx[0], psy[0], psx[1], psy[1], psx[2], psy[2], *pz, *prw]
    if n is None:
        rows += [zero] * 15
    else:
        pn, puv = pick(n), pick(uv)
        rows += [pn[v][j] * prw[v] for v in range(3) for j in range(3)]
        rows += [puv[v][k] * prw[v] for v in range(3) for k in range(2)]
    rows += [mesh_id.to(torch.float32), valid.to(torch.float32), area_c, zero, zero]
    packed = torch.stack(rows, 1)
    aabb = torch.stack([
        torch.clamp(minx, 0.0, W),
        torch.clamp(miny, 0.0, H),
        torch.clamp(maxx, 0.0, W),
        torch.clamp(maxy, 0.0, H),
    ], 1)
    return TriSetup(packed=packed, aabb=aabb, valid=valid)


def setup_triangles_reference(
    pos_cols, nrm_cols, uv_cols, tri_mesh_id, mvp, model, width, height,
    cull="back",
) -> TriSetup:
    """Plain PyTorch version of the setup kernel: same inputs, same records."""
    c, n = _fv_transform_cols(pos_cols, nrm_cols, tri_mesh_id, mvp, model)
    return _setup_cols(c, n, uv_cols, tri_mesh_id, width, height, cull)


def setup_depth_reference(pos_cols, tri_mesh_id, mvp, width, height, cull="none") -> TriSetup:
    """Plain PyTorch version of the depth-only setup kernel (the shadow
    map's light-view pass): the clip transform alone, no normal or uv, and
    record fields 12-26 zero."""
    c, _ = _fv_transform_cols(pos_cols, None, tri_mesh_id, mvp, None)
    return _setup_cols(c, None, None, tri_mesh_id, width, height, cull)


def frame_matrices(state: SceneState, cfg: RendererConfig):
    """(model [M, 4, 4], view_proj [4, 4], mvp [M, 4, 4]) for this frame."""
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    view, proj = camera_matrices(state, cfg)
    view_proj = xmath.matmul4(view, proj)
    return model, view_proj, xmath.matmul4(model, view_proj)


def setup_frame_triangles(
    state: SceneState, cfg: RendererConfig, cull: str = "back"
):
    """Vertex transform + triangle setup -> (TriSetup, view_proj), through
    the setup kernel's wrapper."""
    from .setup_cuda import setup_triangles

    model, view_proj, mvp = frame_matrices(state, cfg)
    geo = state.geometry
    tris = setup_triangles(
        geo.fv_pos_cols, geo.fv_nrm_cols, geo.fv_uv_cols, geo.tri_mesh_id,
        mvp, model, cfg.width, cfg.height, cull=cull,
    )
    return tris, view_proj
