"""Post-processing: tonemap, gamma and the final uint8 quantization.

The counterpart of d3d12_deferred_renderer_tpu/ops/post.py.  The reference's
only post-processing is the gamma encode at the end of the lighting shader
(pow 1/2.2, lighting.hlsl:48) and the RGBA8 store into the swapchain
(main.cpp:444); the PBR configs add Reinhard.  Bloom and FXAA (BASELINE
config 4) are not ported yet: apply_post raises for them (ROADMAP.md Queue 1
item 7).
"""
from __future__ import annotations

import torch

from ..config import RendererConfig
from ..xmath import powf


def reinhard(hdr: torch.Tensor) -> torch.Tensor:
    """Reinhard tonemap x / (1 + x), per channel."""
    return hdr / (1.0 + hdr)


def gamma_encode(linear: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return powf(torch.clamp(linear, min=0.0), 1.0 / gamma)


def to_uint8(color: torch.Tensor) -> torch.Tensor:
    """Final RGBA8-style quantization to displayable uint8 (swapchain store)."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


def apply_post(hdr: torch.Tensor, cfg: RendererConfig) -> torch.Tensor:
    """HDR linear -> display [0, 1]: tonemap, then gamma."""
    if cfg.bloom or cfg.fxaa:
        raise NotImplementedError(
            "bloom and FXAA are not ported to the PyTorch package yet (ROADMAP.md Queue 1 item 7)"
        )
    x = reinhard(hdr) if cfg.tonemap == "reinhard" else hdr
    return gamma_encode(x, cfg.gamma)
