"""Post-processing: tonemap, gamma, bloom, FXAA and the final uint8
quantization.

The counterpart of d3d12_deferred_renderer_tpu/ops/post.py.  The reference's
only post-processing is the gamma encode at the end of the lighting shader
(pow 1/2.2, lighting.hlsl:48) and the RGBA8 store into the swapchain
(main.cpp:444); the PBR configs add Reinhard, and BASELINE config 4 bloom
and FXAA.  Plain PyTorch on every device, as it is XLA in the JAX package,
with every sum in the JAX package's order: the results are bit-equal to
its (tests/test_torch_bump.py).
"""
from __future__ import annotations

import functools

import torch

from ..config import RendererConfig
from ..xmath import divf, powf

# Bloom filter shape (the JAX package's constants).
BLOOM_SIGMA = 4.0
BLOOM_RADIUS = 8
BLOOM_DOWNSAMPLE = 4


def reinhard(hdr: torch.Tensor) -> torch.Tensor:
    """Reinhard tonemap x / (1 + x), per channel."""
    return hdr / (1.0 + hdr)


def gamma_encode(linear: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return powf(torch.clamp(linear, min=0.0), 1.0 / gamma)


def to_uint8(color: torch.Tensor) -> torch.Tensor:
    """Final RGBA8-style quantization to displayable uint8 (swapchain store)."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float, radius: int) -> tuple:
    """The normalized (2r + 1)-tap gaussian as float32 values: exp taken in
    float64 and rounded once, and the sum taken tap by tap, which is how
    XLA rounds the JAX package's weights."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp((-0.5 * (x / sigma) ** 2).double()).float()
    s = k[0]
    for t in k[1:]:
        s = s + t
    return tuple(float(w) for w in k / s)


def _edge_pad(a: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """Pad `dim` by r on both sides with the edge values."""
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=a.device), 0, n - 1)
    return a.index_select(dim, idx)


def _blur_separable(img: torch.Tensor, sigma: float, radius: int, hdim: int, wdim: int) -> torch.Tensor:
    """Separable gaussian blur along dims hdim then wdim, each as the sum of
    2r + 1 weighted shifted slices in tap order (edge-clamped)."""
    k = _gaussian_kernel1d(sigma, radius)
    for dim in (hdim, wdim):
        n = img.shape[dim]
        x = _edge_pad(img, dim, radius)
        acc = None
        for i, w in enumerate(k):
            t = x.narrow(dim, i, n) * w
            acc = t if acc is None else acc + t
        img = acc
    return img


def _bloom(hdr, threshold, strength, sigma, radius, downsample, hdim, wdim):
    H, W = hdr.shape[hdim], hdr.shape[wdim]
    bright = torch.clamp(hdr - threshold, min=0.0)
    sl = [slice(None)] * hdr.dim()
    sl[hdim] = sl[wdim] = slice(None, None, downsample)
    blurred = _blur_separable(bright[tuple(sl)], sigma, radius, hdim, wdim)
    up = blurred.repeat_interleave(downsample, hdim).repeat_interleave(downsample, wdim)
    return hdr + strength * up.narrow(hdim, 0, H).narrow(wdim, 0, W)


def bloom(hdr: torch.Tensor, threshold: float, strength: float, sigma: float = BLOOM_SIGMA,
          radius: int = BLOOM_RADIUS, downsample: int = BLOOM_DOWNSAMPLE) -> torch.Tensor:
    """Threshold -> downsample -> gaussian blur -> upsample -> additive
    blend, on [H, W, 3]."""
    return _bloom(hdr, threshold, strength, sigma, radius, downsample, 0, 1)


def bloom_chw(hdr: torch.Tensor, threshold: float, strength: float, sigma: float = BLOOM_SIGMA,
              radius: int = BLOOM_RADIUS, downsample: int = BLOOM_DOWNSAMPLE) -> torch.Tensor:
    """bloom on channel-first [3, H, W] planes (the fused frame's layout):
    the same taps in the same order, so the same values."""
    return _bloom(hdr, threshold, strength, sigma, radius, downsample, 1, 2)


def fxaa(color: torch.Tensor, threshold: float = 0.0312, relative_threshold: float = 0.125) -> torch.Tensor:
    """Compact FXAA on the gamma-encoded [H, W, 3] image: luma edge detect,
    then a blend toward the 4-neighbour average along the edge; taps are
    edge-clamped."""

    def shift(a, dy, dx):  # out[y, x] = a[clamp(y - dy), clamp(x - dx)]
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


def apply_post(hdr: torch.Tensor, cfg: RendererConfig) -> torch.Tensor:
    """HDR linear [H, W, 3] -> display [0, 1]: bloom -> tonemap -> gamma ->
    FXAA."""
    x = hdr
    if cfg.bloom:
        x = bloom(x, cfg.bloom_threshold, cfg.bloom_strength)
    if cfg.tonemap == "reinhard":
        x = reinhard(x)
    x = gamma_encode(x, cfg.gamma)
    if cfg.fxaa:
        x = fxaa(x)
    return x
