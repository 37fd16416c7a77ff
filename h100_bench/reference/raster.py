"""Plain rasterizer of the reference: every valid record over the pixel
centres of its box, depth LESS with the first record in submission order
winning a tie.

Rules (D3D11/12 functional spec, as the renderer states them): samples at
pixel centres, top-left fill rule, depth test LESS against 1.0, depth clip
to [0, 1], perspective-correct attributes.  The per-pixel arithmetic (the
edge functions, the barycentric depth and the attribute interpolation,
with their fused multiply-adds) is the renderer's.  The order is not: the
records' candidate pixels are evaluated in bulk, each pixel keeps the least
(depth, record index) key of the records that pass it, which is what a walk
in submission order under LESS keeps, and the winner's attributes are
evaluated once more at its pixels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .setup import TRI_AREA, TRI_MESH_ID, TRI_N0, TRI_RW0, TRI_UV0, TRI_VALID, TRI_X0, TRI_Z0
from .xmath import fma

# Candidate (record, pixel) pairs evaluated at once.
CHUNK = 1 << 22
# Pixels added around a record's box: a centre just outside the box can
# pass an edge function by its rounding.
BOX_MARGIN = 2
EMPTY = (0x3F800000 << 32) | 0xFFFFFFFF  # the key of depth 1.0 and no record


class Fragments(NamedTuple):
    depth: torch.Tensor    # [H, W] f32, 1.0 where no record passed
    normal: torch.Tensor   # [H, W, 3] world normal interpolant, unnormalized
    uv: torch.Tensor       # [H, W, 2]
    mesh_id: torch.Tensor  # [H, W] int32, -1 where no record passed


def _sum3(b, a0, a1, a2):
    return fma(b[2], a2, fma(b[0], a0, b[1] * a1))


def _edge(ax, ay, bx, by, px, py):
    A = ay - by
    B = bx - ax
    C = fma(ax, by, -(bx * ay))
    tl = ((by - ay == 0.0) & (bx - ax > 0.0)) | (by - ay < 0.0)
    e = fma(A, px, B * py) + C
    return e, (e > 0.0) | ((e == 0.0) & tl)


def _fragments(rec, px, py):
    """(covered, z, barycentrics) of records rec [N, 32] at pixels (px, py) [N]."""
    x = [rec[:, TRI_X0 + 2 * v] for v in range(3)]
    y = [rec[:, TRI_X0 + 2 * v + 1] for v in range(3)]
    es, covered = [], None
    for a, b in ((1, 2), (2, 0), (0, 1)):
        e, cov = _edge(x[a], y[a], x[b], y[b], px, py)
        covered = cov if covered is None else covered & cov
        es.append(e)
    inv_area = 1.0 / rec[:, TRI_AREA]
    bs = [e * inv_area for e in es]
    z = _sum3(bs, rec[:, TRI_Z0], rec[:, TRI_Z0 + 1], rec[:, TRI_Z0 + 2])
    return covered, z, bs


def _attr(rec, bs, offset, step):
    rw = _sum3(bs, rec[:, TRI_RW0], rec[:, TRI_RW0 + 1], rec[:, TRI_RW0 + 2])
    inv_rw = 1.0 / torch.where(rw == 0.0, torch.ones_like(rw), rw)
    return _sum3(bs, rec[:, offset], rec[:, offset + step], rec[:, offset + 2 * step]) * inv_rw


def _boxes(packed, height, width):
    """Valid record ids and their candidate pixel boxes (x0, y0, w, h)."""
    ids = torch.nonzero(packed[:, TRI_VALID] > 0.0).flatten()
    rec = packed[ids]
    xs, ys = rec[:, TRI_X0:TRI_X0 + 6:2], rec[:, TRI_X0 + 1:TRI_X0 + 6:2]

    def span(lo, hi, n):
        a = torch.clamp(torch.floor(lo - 0.5) - BOX_MARGIN, 0, n - 1)
        b = torch.clamp(torch.ceil(hi - 0.5) + BOX_MARGIN, 0, n - 1)
        ok = torch.isfinite(lo) & torch.isfinite(hi) & (hi >= 0.0) & (lo <= n)
        return a.long(), torch.where(ok, (b - a + 1).long(), torch.zeros_like(a.long()))

    x0, w = span(xs.amin(1), xs.amax(1), width)
    y0, h = span(ys.amin(1), ys.amax(1), height)
    return ids, x0, y0, w, h


def winners(packed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per pixel [H * W] int64: (depth bits << 32) | record id of the record
    a LESS walk in submission order keeps, EMPTY where none passes."""
    dev = packed.device
    keys = torch.full((height * width,), EMPTY, dtype=torch.int64, device=dev)
    ids, x0, y0, w, h = _boxes(packed, height, width)
    area = w * h
    ends = torch.cumsum(area, 0)
    starts = ends - area
    total = int(ends[-1]) if ends.numel() else 0
    first = 0
    while first < total:
        last = min(total, first + CHUNK)
        pair = torch.arange(first, last, device=dev)
        r = torch.searchsorted(ends, pair, right=True)
        local = pair - starts[r]
        px = x0[r] + local % w[r]
        py = y0[r] + local // w[r]
        rec = packed[ids[r]]
        covered, z, _ = _fragments(rec, px.float() + 0.5, py.float() + 0.5)
        ok = covered & (z >= 0.0) & (z < 1.0)
        zbits = torch.where(z == 0.0, torch.zeros_like(z), z).view(torch.int32).long()
        key = (zbits << 32) | ids[r]
        keys.scatter_reduce_(0, (py * width + px)[ok], key[ok], "amin")
        first = last
    return keys


def rasterize(packed: torch.Tensor, height: int, width: int, depth_only: bool = False) -> Fragments:
    """The fragments of records packed [R, 32] on a height x width grid."""
    dev = packed.device
    keys = winners(packed, height, width)
    hit = torch.nonzero(keys != EMPTY).flatten()
    r = keys[hit] & 0xFFFFFFFF
    rec = packed[r]
    px = (hit % width).float() + 0.5
    py = (hit // width).float() + 0.5
    _, z, bs = _fragments(rec, px, py)
    n = height * width
    depth = torch.ones((n,), dtype=torch.float32, device=dev)
    depth[hit] = z
    if depth_only:
        return Fragments(depth.reshape(height, width), None, None, None)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    mesh_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for j in range(3):
        normal[hit, j] = _attr(rec, bs, TRI_N0 + j, 3)
    for k in range(2):
        uv[hit, k] = _attr(rec, bs, TRI_UV0 + k, 2)
    mesh_id[hit] = rec[:, TRI_MESH_ID].to(torch.int32)
    return Fragments(depth.reshape(height, width), normal.reshape(height, width, 3),
                     uv.reshape(height, width, 2), mesh_id.reshape(height, width))
