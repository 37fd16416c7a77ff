"""G-buffer render-target quantization (geometry.hlsl:51-52, main.cpp:476-488).

The reference stores albedo + metalness as RGBA8_UNORM and the encoded normal
+ roughness as R10G10B10A2_UNORM between its two passes; parity needs the same
float -> UNORM -> float round trip.  D3D rounds to nearest, ties to even, as
torch.round does.  The fused frame uses only this function of
d3d12_deferred_renderer_tpu/ops/gbuffer.py.
"""
from __future__ import annotations

import torch


def quantize_unorm(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float -> UNORM(bits) -> float round trip."""
    scale = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * scale) / scale
