"""Multi-device rendering by screen-row bands over a torch.distributed group.

The counterpart of the row-band half of d3d12_deferred_renderer_tpu/
parallel/sharded.py (``render_sharded`` and its helpers, in their
structure and names).  The scene state is small and every rank holds all
of it; rank i of n renders rows [i * H / n, (i + 1) * H / n) of the frame:
triangle setup of the whole stream, binning of its band's tiles only, the
band modes of the raster, light cull, PCF and shading, and the band's post.
The G-buffer never leaves a rank.  What crosses ranks:

- bloom: the 4x-downsampled thresholded bright field, all-gathered, so
  every rank blurs the whole field as the single-device frame does and
  keeps its rows;
- FXAA: the first and last row of every band (a tiny all-gather), from
  which a band takes its neighbours' boundary rows;
- the assembled uint8 frame, gathered to every rank (JAX's sharded output
  assembles the same frame), and the overflow count, summed over the bands
  (JAX's psum).

Both filters are exact across bands: a band's rows equal the same rows of
the single-device frame's filter.  The branches follow the JAX package: the
fused tile renderer's band mode when frame._fused_eligible(cfg) and the
band is a multiple of tile_h; otherwise the staged band, through the
kernels (tile raster, lighting kernel) with cfg.use_pallas and the plain
chain (reference raster, 32-pixel-tile lighting) without.  On the CPU every
kernel's wrapper runs its plain version.  The staged band's bump is the
bump kernel on the band's raster planes with cfg.use_pallas (its row
offset the band's first row), else the block form over the band's world
positions, as JAX's band path runs it.

Not yet ported (ROADMAP.md Queue 1 item 6): the triangle-sharded path
(render_tri_sharded, _composite_tri), the batch-sharded entry points and
dryrun.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import RendererConfig
from ..frame import _fused_eligible, check_ported
from ..ops import post
from ..ops.bump import apply_normal_mapping
from ..ops.fused import render_fused
from ..ops.gbuffer import encode_gbuffer
from ..ops.lighting import (
    inverse_view_proj, reconstruct_world_positions, shade_lambert, shade_pbr_tiled,
)
from ..ops.lighting_cuda import shade_pbr_tiled_kernel
from ..ops.raster_ref import rasterize_packed
from ..ops.raster_tiles import rasterize_binned
from ..ops.shadows import render_shadow_map, shadow_visibility
from ..ops.transform import setup_frame_triangles
from ..scene import SceneState


class BandGroup(NamedTuple):
    """The band axis: a process group, this rank's band index and the band
    count (the counterpart of BandAxes, with one axis).  Ranks of a gloo
    group pass CUDA tensors through host memory (``staged``): gloo's CUDA
    support varies across torch versions, and the tensors are small."""

    group: object  # a torch.distributed process group; None is the default group
    index: int
    total: int
    staged: bool

    @staticmethod
    def of(group=None) -> "BandGroup":
        return BandGroup(group, dist.get_rank(group), dist.get_world_size(group),
                         dist.get_backend(group) == "gloo")

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.staged else x.contiguous()

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Every band's x, concatenated along dim 0 in band order."""
        if self.total == 1:
            return x
        src = self._send(x)
        parts = [torch.empty_like(src) for _ in range(self.total)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(x.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the bands."""
        if self.total == 1:
            return x
        y = self._send(x).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(x.device)


def _bloom_band(hdr: torch.Tensor, cfg: RendererConfig, g: BandGroup) -> torch.Tensor:
    """post.bloom of the whole frame, evaluated for this band [bh, W, 3]:
    the downsampled bright field is all-gathered, blurred whole and this
    band's rows kept; equal to post.bloom's rows (band % downsample == 0
    makes the bands' [::d] rows those of the frame's)."""
    d = post.BLOOM_DOWNSAMPLE
    bh, W, _ = hdr.shape
    bright = torch.clamp(hdr - cfg.bloom_threshold, min=0.0)
    ds = bright[::d, ::d]
    blurred = post._blur_separable(g.all_gather_tiled(ds), post.BLOOM_SIGMA, post.BLOOM_RADIUS, 0, 1)
    n = ds.shape[0]
    mine = blurred[g.index * n : (g.index + 1) * n]
    up = mine.repeat_interleave(d, 0).repeat_interleave(d, 1)[:bh, :W]
    return hdr + cfg.bloom_strength * up


def _fxaa_band(color: torch.Tensor, g: BandGroup) -> torch.Tensor:
    """post.fxaa for this band, its one-row footprint across band edges
    filled by the neighbours' boundary rows: every band's first and last
    rows are all-gathered ([2n, W, 3], band b at 2b and 2b + 1); the frame's
    top and bottom bands repeat their own edge row, as post.fxaa clamps."""
    n = g.total
    if n == 1:
        return post.fxaa(color)
    i = g.index
    edges = g.all_gather_tiled(torch.cat([color[:1], color[-1:]]))
    top = edges[max(2 * i - 1, 0)][None]
    bot = edges[min(2 * i + 2, 2 * n - 1)][None]
    return post.fxaa(torch.cat([top, color, bot]))[1:-1]


def _post_band(hdr: torch.Tensor, cfg: RendererConfig, g: BandGroup) -> torch.Tensor:
    """post.apply_post (bloom, tonemap, gamma, FXAA) for one band, the two
    filters exact across bands; tonemap and gamma are per pixel."""
    x = hdr
    if cfg.bloom:
        x = _bloom_band(x, cfg, g)
    if cfg.tonemap == "reinhard":
        x = post.reinhard(x)
    x = post.gamma_encode(x, cfg.gamma)
    if cfg.fxaa:
        x = _fxaa_band(x, g)
    return x


def _render_band(state: SceneState, cfg: RendererConfig, y0: int, band_h: int, g: BandGroup):
    """Rows [y0, y0 + band_h) of the frame -> (uint8 [band_h, W, 3], this
    band's int32 overflow count)."""
    if _fused_eligible(cfg) and band_h % cfg.tile_h == 0:
        hdr, overflow = render_fused(state, cfg, return_overflow=True, band_h=band_h, y_offset=y0)
        return post.to_uint8(_post_band(hdr, cfg, g)), overflow

    tris, view_proj = setup_frame_triangles(state, cfg)
    inv_vp = inverse_view_proj(view_proj)
    if cfg.use_pallas:  # the tile raster, and with normal mapping the bump, on the band
        frags, overflow = rasterize_binned(tris.packed, tris.aabb, tris.valid, cfg, return_overflow=True,
                                           band_h=band_h, y_offset=y0, inv_vp=inv_vp)
    else:
        frags = rasterize_packed(tris.packed, band_h, cfg.width, y0)
        overflow = torch.zeros((), dtype=torch.int32, device=tris.packed.device)
    color, s_overflow = _shade_band(frags, state, cfg, view_proj, inv_vp, y0, g)
    return color, overflow + s_overflow


def _shade_band(frags, state: SceneState, cfg: RendererConfig, view_proj, inv_vp, y0: int, g: BandGroup):
    """The block-form bump without cfg.use_pallas (with it the raster's
    planes were bumped), G-buffer encode, shading and post for the band in
    `frags` (rows [y0, y0 + band_h) of the frame) -> (uint8 band, the
    shading's overflow count)."""
    band_h, W = frags.depth.shape
    rows = dict(y_offset=y0, full_height=cfg.height)
    overflow = torch.zeros((), dtype=torch.int32, device=frags.depth.device)
    if cfg.normal_mapping and not cfg.use_pallas:
        world = reconstruct_world_positions(frags.depth, view_proj, cfg, inv_vp, **rows)
        frags = apply_normal_mapping(frags, world, cfg, cfg.bump_strength, cfg.bump_frequency)
    gb = encode_gbuffer(frags, state.materials, cfg)
    if cfg.shading == "lambert":
        color = shade_lambert(gb, state.lights, cfg)
        if cfg.fxaa:
            color = _fxaa_band(color, g)
        return post.to_uint8(color), overflow
    vis = None
    if cfg.shadows:
        # The shadow map is the frame's: every rank renders all of it.
        shadow_depth, light_vp, s_overflow = render_shadow_map(state, cfg, return_overflow=True)
        vis, v_overflow = shadow_visibility(gb.depth, view_proj, shadow_depth, light_vp, cfg,
                                            return_overflow=True, inv_vp=inv_vp, **rows)
        overflow = overflow + s_overflow + v_overflow
    if cfg.use_pallas:
        hdr, l_overflow = shade_pbr_tiled_kernel(gb, state.lights, cfg, view_proj, state.camera.eye,
                                                 shadow_visibility=vis, return_overflow=True,
                                                 inv_vp=inv_vp, **rows)
    else:
        # The plain cull's square tile must divide the band and the width.
        hdr, l_overflow = shade_pbr_tiled(gb, state.lights, cfg, view_proj, state.camera.eye,
                                          tile=math.gcd(32, band_h, W), shadow_visibility=vis,
                                          return_overflow=True, inv_vp=inv_vp, **rows)
    return post.to_uint8(_post_band(hdr, cfg, g)), overflow + l_overflow


def _check_band_safe(cfg: RendererConfig, band: int) -> None:
    """Refuse, loudly, a band height that a cross-pixel filter cannot take
    exactly: bloom's downsample and the bump's tile_h blocks must not
    straddle bands, and PCF with a downsampled visibility is band-local."""
    if cfg.bloom and band % post.BLOOM_DOWNSAMPLE:
        raise ValueError(
            f"bloom needs band height divisible by its {post.BLOOM_DOWNSAMPLE}x downsample, got "
            f"{band}: choose a band count so height/bands % {post.BLOOM_DOWNSAMPLE} == 0"
        )
    if cfg.normal_mapping and band % cfg.tile_h:
        raise ValueError(
            f"normal mapping needs band height divisible by the tile_h={cfg.tile_h} block grid, got "
            f"{band}: blocks must not straddle band boundaries"
        )
    if cfg.shadows and max(1, cfg.shadow_vis_downsample) > 1:
        raise ValueError(
            "shadow_vis_downsample > 1 is band-local (the coarse visibility upsample cannot see "
            "neighboring bands' samples) and would silently diverge from the single-device render: "
            "use shadow_vis_downsample=1 on the sharded path"
        )


def render_sharded(state: SceneState, cfg: RendererConfig, group=None, return_stats: bool = False):
    """One frame, screen rows split over the ranks of `group` (the default
    process group when None) -> uint8 [H, W, 3], the whole frame on every
    rank; with return_stats also {"overflow": the int32 overflow count
    summed over the bands} (the single-device render_stats signal).  Every
    rank of the group calls it with the same state and config."""
    g = BandGroup.of(group)
    if cfg.height % g.total:
        raise ValueError(f"height {cfg.height} not divisible by {g.total} bands")
    band = cfg.height // g.total
    _check_band_safe(cfg, band)
    check_ported(cfg)
    frame, overflow = _render_band(state, cfg, g.index * band, band, g)
    frame = g.all_gather_tiled(frame)
    overflow = g.sum(overflow)
    return (frame, {"overflow": overflow}) if return_stats else frame
