"""Texture sampling with D3D texel addressing: texel i covers [i, i + 1),
centers at i + 0.5, CLAMP addressing.

The counterpart of d3d12_deferred_renderer_tpu/ops/sampling.py.  The JAX
package reads the comparison sampler's 2x2 footprint with one row gather of
a quad-packed copy of the map (``pack_cmp_quads``), a layout for the TPU's
gather engine; four clamped element reads give the same texels, so this
module reads them directly.  Plain PyTorch on every device, as it is XLA in
the JAX package.
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


def _footprint(Ht: int, Wt: int, uv: torch.Tensor):
    """Bilinear footprint of uv: clamped texel rows (y0, y1), columns
    (x0, x1) and the weights (tx, ty)."""
    fx = uv[..., 0] * Wt - 0.5
    fy = uv[..., 1] * Ht - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    xi, yi = _texel_index(x0, Wt), _texel_index(y0, Ht)
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
