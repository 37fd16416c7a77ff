"""Reference rasterizer: every triangle over the whole frame, in order.

The semantics-defining geometry pass (the D3D12 hardware rasterizer +
geometry.hlsl), the counterpart of d3d12_deferred_renderer_tpu/ops/
raster_ref.py.  Rules (D3D11/12 functional spec):

- sample at pixel centers (x + 0.5, y + 0.5);
- top-left fill rule for centers exactly on an edge;
- depth test LESS against a buffer cleared to 1.0 (main.cpp:194, 763), so the
  first triangle in submission order wins a tie;
- per-pixel depth clip to [0, 1] (DepthClipEnable=TRUE, main.cpp:735);
- perspective-correct attributes: attr/w interpolated, divided by the
  interpolated 1/w.

The edge functions and the interpolations round as the reference's compiled
rasterizer does, which contracts a*b + c into one fused multiply-add in
fixed places: C = fma(ax, by, -(bx*ay)), e = fma(A, px, B*py) + C and
sum_v b_v * a_v = fma(b2, a2, fma(b0, a0, b1*a1)).  Near-silhouette pixels
lose most of e's bits to cancellation, and a depth near 1 maps a small
depth change to a large world-space one, so the rounding of these few
operations shows in the shaded frame; elsewhere every operation rounds once.

The fused tile renderer's plain version (ops/fused.py) applies the same
per-pixel arithmetic, in the same order, to each tile's binned records.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..xmath import fma
from .transform import (
    TRI_AREA, TRI_MESH_ID, TRI_N0, TRI_RW0, TRI_UV0, TRI_VALID, TRI_X0, TRI_Z0,
)


class FragmentPlanes(NamedTuple):
    depth: torch.Tensor    # [H, W] f32, cleared to 1.0
    normal: torch.Tensor   # [H, W, 3] world-space, unnormalized interpolant
    uv: torch.Tensor       # [H, W, 2]
    mesh_id: torch.Tensor  # [H, W] int32, -1 where no fragment


def _sum3(b, a0, a1, a2):
    return fma(b[2], a2, fma(b[0], a0, b[1] * a1))


def edge_coeffs(ax, ay, bx, by):
    """Edge function e(p) = A*px + B*py + C = cross2d(b - a, p - a) for the
    directed edge a->b, and its top-left tie flag: with positive-area winding
    e > 0 strictly inside, and e == 0 counts on a top edge (dy == 0, dx > 0)
    or a left edge (dy < 0) in y-down render-target space."""
    A = ay - by
    B = bx - ax
    C = fma(ax, by, -(bx * ay))
    dx = bx - ax
    dy = by - ay
    return A, B, C, ((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)


def triangle_fragments(rec, px, py):
    """Coverage, depth and barycentrics of records `rec` (last axis the 32
    fields, leading axes broadcasting against px/py): returns (covered, z,
    (b0, b1, b2))."""
    def f(i):
        return rec[..., i : i + 1]

    x = [f(TRI_X0 + 2 * v) for v in range(3)]
    y = [f(TRI_X0 + 2 * v + 1) for v in range(3)]
    es, covered = [], None
    for a, b in ((1, 2), (2, 0), (0, 1)):
        A, B, C, tl = edge_coeffs(x[a], y[a], x[b], y[b])
        e = fma(A, px, B * py) + C
        cov = (e > 0.0) | ((e == 0.0) & tl)
        covered = cov if covered is None else covered & cov
        es.append(e)
    inv_area = 1.0 / f(TRI_AREA)
    bs = [e * inv_area for e in es]
    z = _sum3(bs, f(TRI_Z0), f(TRI_Z0 + 1), f(TRI_Z0 + 2))
    return covered, z, bs


def perspective_attr(rec, bs, offset, step):
    """Perspective-correct attribute: (sum_v b_v * (attr_v / w_v)) / (1/w)."""
    def f(i):
        return rec[..., i : i + 1]

    rw = _sum3(bs, f(TRI_RW0), f(TRI_RW0 + 1), f(TRI_RW0 + 2))
    inv_rw = 1.0 / torch.where(rw == 0.0, torch.ones_like(rw), rw)
    a = _sum3(bs, f(offset), f(offset + step), f(offset + 2 * step))
    return a * inv_rw


def rasterize_packed(packed: torch.Tensor, height: int, width: int, y_offset: int = 0) -> FragmentPlanes:
    """Rasterize the [T, 32] records over a height x width grid, in order:
    pixel rows y_offset .. y_offset + height - 1 of the frame (a band of a
    taller frame with y_offset > 0)."""
    dev = packed.device
    py = ((y_offset + torch.arange(height, dtype=torch.float32, device=dev)) + 0.5)[:, None]
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py, px = py.expand(height, width).reshape(1, -1), px.expand(height, width).reshape(1, -1)
    n = height * width
    depth = torch.ones((1, n), dtype=torch.float32, device=dev)
    normal = torch.zeros((3, n), dtype=torch.float32, device=dev)
    uv = torch.zeros((2, n), dtype=torch.float32, device=dev)
    mesh_id = torch.full((1, n), -1, dtype=torch.int32, device=dev)
    # Records that are not valid (culled, clipped away) never pass: skip them.
    for t in torch.nonzero(packed[:, TRI_VALID] > 0.0).flatten().tolist():
        rec = packed[t : t + 1]
        covered, z, bs = triangle_fragments(rec, px, py)
        passes = covered & (rec[:, TRI_VALID : TRI_VALID + 1] > 0.0) & (z < depth) & (z >= 0.0) & (z <= 1.0)
        depth = torch.where(passes, z, depth)
        for j in range(3):
            normal[j : j + 1] = torch.where(passes, perspective_attr(rec, bs, TRI_N0 + j, 3), normal[j : j + 1])
        for k in range(2):
            uv[k : k + 1] = torch.where(passes, perspective_attr(rec, bs, TRI_UV0 + k, 2), uv[k : k + 1])
        mesh_id = torch.where(passes, rec[:, TRI_MESH_ID : TRI_MESH_ID + 1].to(torch.int32), mesh_id)
    return FragmentPlanes(
        depth=depth.reshape(height, width),
        normal=normal.T.reshape(height, width, 3),
        uv=uv.T.reshape(height, width, 2),
        mesh_id=mesh_id.reshape(height, width),
    )


def rasterize(tris, cfg) -> FragmentPlanes:
    """The whole frame of a TriSetup's records on cfg's width x height grid."""
    return rasterize_packed(tris.packed, cfg.height, cfg.width)
