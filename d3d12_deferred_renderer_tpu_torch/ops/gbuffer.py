"""G-buffer encode/decode with the reference's render-target quantization.

The counterpart of d3d12_deferred_renderer_tpu/ops/gbuffer.py.  The
reference's geometry pass writes two render targets (main.cpp:476-488,
720-722):

  GB0 = R8G8B8A8_UNORM     : albedo.rgb + metalness.a        (geometry.hlsl:51)
  GB1 = R10G10B10A2_UNORM  : worldNormal*0.5+0.5 + roughness (geometry.hlsl:52)
  depth = D32_FLOAT        : NDC z, cleared to 1.0           (main.cpp:509, 194)

and parity needs the same float -> UNORM -> float round trip between the
passes.  D3D rounds to nearest, ties to even, as torch.round does.  The
material constants are gathered per pixel by mesh id (the JAX package's CPU
branch; its one-hot contraction exists only for the TPU's matrix unit).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RendererConfig
from ..scene import Materials
from ..xmath import normalize_safe, powf
from .raster_ref import FragmentPlanes


class GBuffer(NamedTuple):
    gb0: torch.Tensor    # [H, W, 4] albedo.rgb + metalness (unorm8-quantized)
    gb1: torch.Tensor    # [H, W, 4] encoded normal + roughness (unorm10/2)
    depth: torch.Tensor  # [H, W] f32 NDC depth


class DecodedGBuffer(NamedTuple):
    albedo: torch.Tensor     # [H, W, 3] linear (sRGB-decoded)
    metalness: torch.Tensor  # [H, W]
    normal: torch.Tensor     # [H, W, 3] unit
    roughness: torch.Tensor  # [H, W]


def quantize_unorm(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float -> UNORM(bits) -> float round trip."""
    scale = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * scale) / scale


def encode_gbuffer(frags: FragmentPlanes, materials: Materials, cfg: RendererConfig) -> GBuffer:
    """The pixel-shader tail of the geometry pass (geometry.hlsl:42-55): the
    interpolated normal renormalized and encoded n*0.5+0.5, the material
    constants by mesh id; background pixels keep the cleared 0."""
    covered = (frags.mesh_id >= 0)[..., None]
    mid = torch.clamp(frags.mesh_id, min=0).long()
    n = normalize_safe(frags.normal)
    gb0 = torch.cat([materials.albedo[mid], materials.metalness[mid][..., None]], dim=-1)
    gb1 = torch.cat([n * 0.5 + 0.5, materials.roughness[mid][..., None]], dim=-1)
    zero = torch.zeros((), dtype=gb0.dtype, device=gb0.device)
    gb0 = torch.where(covered, gb0, zero)
    gb1 = torch.where(covered, gb1, zero)
    if cfg.quantize_gbuffer:
        gb0 = quantize_unorm(gb0, 8)
        gb1 = torch.cat([quantize_unorm(gb1[..., :3], 10), quantize_unorm(gb1[..., 3:], 2)], dim=-1)
    return GBuffer(gb0=gb0, gb1=gb1, depth=frags.depth)


def decode_gbuffer(gb: GBuffer, cfg: RendererConfig) -> DecodedGBuffer:
    """The decode prologue of the lighting pass (lighting.hlsl:34-40):
    albedo sRGB -> linear by pow gamma, normal *2-1 then normalize."""
    return DecodedGBuffer(
        albedo=powf(torch.clamp(gb.gb0[..., :3], min=0.0), cfg.gamma),
        metalness=gb.gb0[..., 3],
        normal=normalize_safe(gb.gb1[..., :3] * 2.0 - 1.0),
        roughness=gb.gb1[..., 3],
    )
