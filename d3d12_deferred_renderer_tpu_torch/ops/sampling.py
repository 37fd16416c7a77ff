"""Texture sampling with D3D texel addressing: texel i covers [i, i + 1),
centers at i + 0.5, CLAMP addressing.

The counterpart of d3d12_deferred_renderer_tpu/ops/sampling.py.  The JAX
package reads the comparison sampler's 2x2 footprint with one row gather of
a quad-packed copy of the map (``pack_cmp_quads``), a layout for the TPU's
gather engine; four clamped element reads give the same texels, so this
module reads them directly.  The same holds for the 4x4 windows of the
window-gather PCF: ``pack_cmp_windows`` builds JAX's table (its layout,
pinned by the tests), and ``window_texels`` reads any of its rows without
building it.  Plain PyTorch on every device, as it is XLA in the JAX
package.
"""
from __future__ import annotations

import torch


def _texel_index(f: torch.Tensor, n: int) -> torch.Tensor:
    """Integer texel coordinate of float coordinate f, clamped to [-1, n - 1]
    before the conversion (the clamp the JAX sampler applies after it; a NaN
    coordinate reads texel 0)."""
    return torch.clamp(torch.nan_to_num(f, nan=0.0), -1.0, float(n - 1)).long()


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """tex [Ht, Wt, C] or [Ht, Wt]; uv [..., 2] in [0, 1] -> [..., C] / [...]."""
    Ht, Wt = tex.shape[0], tex.shape[1]
    x = torch.clamp(_texel_index(torch.floor(uv[..., 0] * Wt), Wt), 0, Wt - 1)
    y = torch.clamp(_texel_index(torch.floor(uv[..., 1] * Ht), Ht), 0, Ht - 1)
    return tex[y, x]


def footprint_base(Ht: int, Wt: int, uv: torch.Tensor):
    """Top-left texel of uv's bilinear footprint on an Ht x Wt map: column
    xi and row yi, each clamped to [-1, n - 1] (clamping the base instead
    of each tap reads the same texels: the edge texels repeat), and the
    weights (tx, ty)."""
    fx = uv[..., 0] * Wt - 0.5
    fy = uv[..., 1] * Ht - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    return _texel_index(x0, Wt), _texel_index(y0, Ht), tx, ty


def _footprint(Ht: int, Wt: int, uv: torch.Tensor):
    """Bilinear footprint of uv: clamped texel rows (y0, y1), columns
    (x0, x1) and the weights (tx, ty)."""
    xi, yi, tx, ty = footprint_base(Ht, Wt, uv)
    xs = (torch.clamp(xi, 0, Wt - 1), torch.clamp(xi + 1, 0, Wt - 1))
    ys = (torch.clamp(yi, 0, Ht - 1), torch.clamp(yi + 1, 0, Ht - 1))
    return ys, xs, tx, ty


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear filtering with CLAMP addressing (D3D11 functional-spec
    weights).  tex [Ht, Wt, C] or [Ht, Wt]; uv [..., 2] -> [..., C] / [...]."""
    ys, xs, tx, ty = _footprint(tex.shape[0], tex.shape[1], uv)
    c00, c10 = tex[ys[0], xs[0]], tex[ys[0], xs[1]]
    c01, c11 = tex[ys[1], xs[0]], tex[ys[1], xs[1]]
    if tex.dim() == 3:
        tx, ty = tx[..., None], ty[..., None]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_bilinear_cmp(tex: torch.Tensor, uv: torch.Tensor, ref: torch.Tensor,
                        bias: float = 0.0) -> torch.Tensor:
    """D3D comparison sampler (SampleCmp, LESS_EQUAL, linear filter):
    compare ``ref <= texel + bias`` at each of the 2x2 footprint texels,
    then weight the binary results bilinearly (percentage-closer
    filtering).  tex [Ht, Wt]; uv [..., 2]; ref [...] -> visibility [...]."""
    ys, xs, tx, ty = _footprint(tex.shape[0], tex.shape[1], uv)
    c = [(ref <= tex[y, x] + bias).to(torch.float32) for y in ys for x in xs]
    top = c[0] + (c[1] - c[0]) * tx
    bot = c[2] + (c[3] - c[2]) * tx
    return top + (bot - top) * ty


def pack_cmp_windows(tex: torch.Tensor) -> torch.Tensor:
    """Window-packed depth map [(Ht + 1) * (Wt + 1), 16]: row
    (y0 + 1) * (Wt + 1) + (x0 + 1) holds the 4x4 CLAMP-addressed texel
    window at base (x0, y0), x0 in [-1, Wt - 1], y0 in [-1, Ht - 1]; lane
    4 * i + j is texel (y0 + i, x0 + j), the edges replicated."""
    Ht, Wt = tex.shape
    rows = torch.clamp(torch.arange(-1, Ht + 3, device=tex.device), 0, Ht - 1)
    cols = torch.clamp(torch.arange(-1, Wt + 3, device=tex.device), 0, Wt - 1)
    p = tex[rows][:, cols]
    wins = torch.stack([p[i : i + Ht + 1, j : j + Wt + 1] for i in range(4) for j in range(4)], dim=-1)
    return wins.reshape(-1, 16)


def window_texels(tex: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor, n: int = 4) -> torch.Tensor:
    """The n x n CLAMP-addressed texels at bases (xi, yi) [...] -> [..., n, n]:
    element (i, j) is texel (yi + i, xi + j).  With n = 4 the rows of
    pack_cmp_windows(tex) at those bases (lane 4 * i + j), with n = 2 the
    bilinear footprints (c00, c10 / c01, c11), read straight from the map."""
    Ht, Wt = tex.shape
    off = torch.arange(n, device=tex.device)
    rows = torch.clamp(yi[..., None] + off, 0, Ht - 1)
    cols = torch.clamp(xi[..., None] + off, 0, Wt - 1)
    return tex[rows[..., :, None], cols[..., None, :]]


def cmp_blend(taps: torch.Tensor, ref: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
              bias: float) -> torch.Tensor:
    """The comparison sampler's filter on given footprint taps [..., 4]
    (c00, c10, c01, c11): compare ``ref <= texel + bias``, then blend the
    results in sample_bilinear_cmp's order of operations."""
    c = (ref[..., None] <= taps + bias).to(torch.float32)
    top = c[..., 0] + (c[..., 1] - c[..., 0]) * tx
    bot = c[..., 2] + (c[..., 3] - c[..., 2]) * tx
    return top + (bot - top) * ty
