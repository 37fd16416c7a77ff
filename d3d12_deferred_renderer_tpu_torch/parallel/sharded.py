"""Multi-device rendering over torch.distributed: screen-row bands x frame
batches x triangle shards over a rank mesh (parallel/mesh.py).

The counterpart of d3d12_deferred_renderer_tpu/parallel/sharded.py, in its
structure and names.  The scene state is small and every rank holds all of
it.  Three kinds of split compose:

- row bands (``render_sharded``): rank i of n renders rows [i * H / n,
  (i + 1) * H / n) of the frame: triangle setup of the whole stream,
  binning of its band's tiles only, the band modes of the raster, light
  cull, PCF and shading, and the band's post.  The G-buffer never leaves a
  rank;
- triangle shards (``render_tri_sharded``, sort-last compositing): each
  rank of the "tri" axis rasterizes a contiguous slice of the setup's
  record stream over its band; the partial fragment planes composite by
  depth, the first slice winning a tie, and land each rank its sub-band of
  band / n_tri rows, which it shades;
- frame batches (``render_frames_batch_sharded``,
  ``render_frames_batch_tri_sharded``): each rank of the "frame" axis
  renders its share of the batch, each frame at its own clock.

What crosses ranks:

- bloom: the 4x-downsampled thresholded bright field, all-gathered, so
  every rank blurs the whole field as the single-device frame does and
  keeps its rows;
- FXAA: the first and last row of every band (a tiny all-gather), from
  which a band takes its neighbours' boundary rows;
- the triangle shards' composite: the depth plane and the winner's rank
  (two all-reduces by minimum over the "tri" axis), then the seven
  fragment planes, each rank's masked by where it won, summed and
  scattered to the sub-bands (a reduce-scatter);
- the assembled uint8 frames, gathered to every rank (JAX's sharded
  output assembles the same frames), and the overflow count, summed over
  every axis (JAX's psum).

Every cross-band collective goes through a band handle: ``BandGroup`` for
one axis, ``BandAxes`` for the composed (rows, tri) bands.  BandAxes takes
the band index major -> minor (rows, then tri) and nests one-axis gathers
minor axis first, so the band order is the same for every order in which
the mesh declares its axes (the JAX package's round-4 defect flattened
them in declaration order and scrambled the FXAA halo and the bloom
gather).

Both filters are exact across bands: a band's rows equal the same rows of
the single-device frame's filter.  The branches follow the JAX package: the
fused tile renderer's band mode when frame._fused_eligible(cfg) and the
band is a multiple of tile_h; otherwise the staged band, through the
kernels (tile raster, lighting kernel) with cfg.use_pallas and the plain
chain (reference raster, 32-pixel-tile lighting) without.  The triangle
shards are always staged: the composite needs the fragment planes between
the raster and the shading.  On the CPU every kernel's wrapper runs its
plain version.  The bump runs on a band's planes once they are whole: the
bump kernel on the raster planes of a row band, and on the composited
sub-band of the triangle shards (it reads neighbouring pixels, which one
slice's partial coverage does not hold), with cfg.use_pallas; else the
block form over the band's world positions, as JAX's band path runs it.

The composite keeps every bit of the winner's planes: the masked ranks
add -0.0, the one value whose sum leaves every float unchanged (-0.0 as
well), where JAX's psum of +0.0 makes a -0.0 depth or attribute +0.0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..config import RendererConfig
from ..frame import _fused_eligible
from ..ops import post
from ..ops.bump import apply_normal_mapping, bump_tiles
from ..ops.fused import render_fused
from ..ops.gbuffer import encode_gbuffer
from ..ops.lighting import (
    inverse_view_proj, reconstruct_world_positions, shade_lambert, shade_pbr_tiled,
)
from ..ops.lighting_cuda import shade_pbr_tiled_kernel
from ..ops.raster_ref import FragmentPlanes, rasterize_packed
from ..ops.raster_tiles import NUM_PLANES, fragments_from_planes, rasterize_binned
from ..ops.shadows import render_shadow_map, shadow_visibility
from ..ops.transform import setup_frame_triangles
from ..scene import SceneState, _mod, default_device
from ..xmath import XM_2PI
from .mesh import Mesh

# The bytes this rank has put into collectives since the last reset (each
# collective's input buffer counted once): what crosses ranks.
bytes_sent = 0


def _count(x: torch.Tensor) -> None:
    global bytes_sent
    bytes_sent += x.numel() * x.element_size()


class BandGroup(NamedTuple):
    """One axis of ranks: its process group, this rank's index on it and
    the axis size (the counterpart of BandAxes with one axis).  Ranks of a
    gloo group pass CUDA tensors through host memory (``staged``): gloo's
    CUDA support varies across torch versions."""

    group: object  # a torch.distributed process group; None is the default group
    index: int
    total: int
    staged: bool

    @staticmethod
    def of(group=None) -> "BandGroup":
        return BandGroup(group, dist.get_rank(group), dist.get_world_size(group),
                         dist.get_backend(group) == "gloo")

    @staticmethod
    def of_axis(mesh: Mesh, name: str) -> "BandGroup":
        """The line of ranks along mesh axis `name` through this rank."""
        ax = mesh.axis(name)
        return BandGroup(mesh.groups[ax], mesh.coords[ax], mesh.sizes[ax], mesh.staged)

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        _count(x)
        return x.cpu() if self.staged else x.contiguous()

    def all_gather_tiled(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x, concatenated along `dim` in axis order."""
        if self.total == 1:
            return x
        src = self._send(x)
        parts = [torch.empty_like(src) for _ in range(self.total)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim).to(x.device)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.total == 1:
            return x
        y = self._send(x).clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the axis."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum of x over the axis."""
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def sum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the axis, cut along dim 0 into `total` equal parts:
        this rank's part (a tiled reduce-scatter)."""
        if self.total == 1:
            return x
        src = self._send(x)
        parts = list(src.chunk(self.total))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.group)
        return out.to(x.device)


class BandAxes(NamedTuple):
    """Flat screen bands over several mesh axes, named major -> minor in
    the band-to-row order (rows major, tri minor): band index rows_idx *
    n_tri + tri_idx, whatever the mesh's declaration order.  Gathers nest
    one-axis gathers, minor axis first, so every rank gathers the bands in
    that order; sums cover every axis."""

    axes: Tuple[BandGroup, ...]  # major -> minor

    @staticmethod
    def of(mesh: Mesh, names) -> "BandAxes":
        return BandAxes(tuple(BandGroup.of_axis(mesh, n) for n in names))

    @property
    def index(self) -> int:
        idx = 0
        for a in self.axes:
            idx = idx * a.total + a.index
        return idx

    @property
    def total(self) -> int:
        return math.prod(a.total for a in self.axes)

    def all_gather_tiled(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every band's x, concatenated along `dim` in band order."""
        for a in reversed(self.axes):
            x = a.all_gather_tiled(x, dim)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over every band axis."""
        for a in self.axes:
            x = a.sum(x)
        return x


def _bloom_band(hdr: torch.Tensor, cfg: RendererConfig, g) -> torch.Tensor:
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


def _fxaa_band(color: torch.Tensor, g) -> torch.Tensor:
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


def _post_band(hdr: torch.Tensor, cfg: RendererConfig, g) -> torch.Tensor:
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


def band_branch(cfg: RendererConfig, band_h: int) -> str:
    """"fused" where a row band renders through the fused tile renderer's
    band mode (frame._fused_eligible and whole tile rows), else "staged"."""
    return "fused" if _fused_eligible(cfg) and band_h % cfg.tile_h == 0 else "staged"


def _render_band(state: SceneState, cfg: RendererConfig, y0: int, band_h: int, g):
    """Rows [y0, y0 + band_h) of the frame -> (uint8 [band_h, W, 3], this
    band's int32 overflow count)."""
    if band_branch(cfg, band_h) == "fused":
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
    color, s_overflow = _shade_band(frags, state, cfg, view_proj, inv_vp, y0, g, bumped=cfg.use_pallas)
    return color, overflow + s_overflow


def _bump_band(frags: FragmentPlanes, cfg: RendererConfig, view_proj, inv_vp, y0: int) -> FragmentPlanes:
    """The bump of a band's whole fragment planes (rows [y0, y0 + band_h)):
    with cfg.use_pallas the bump kernel's band mode on the planes laid out
    as the tile raster writes them (whole tile rows: _check_band_safe; the
    columns past the frame padded as background, which the kernel masks),
    else the block form over the band's world positions."""
    if not cfg.use_pallas:
        world = reconstruct_world_positions(frags.depth, view_proj, cfg, inv_vp, y_offset=y0,
                                            full_height=cfg.height)
        return apply_normal_mapping(frags, world, cfg, cfg.bump_strength, cfg.bump_frequency)
    bh, W = frags.depth.shape
    Wp = -(-W // cfg.tile_w) * cfg.tile_w
    planes = torch.zeros((NUM_PLANES, bh, Wp), dtype=torch.float32, device=frags.depth.device)
    planes[0] = 1.0
    planes[6] = -1.0
    planes[:7, :, :W] = _stack_planes(frags).permute(2, 0, 1)
    bump_tiles(planes, inv_vp, width=cfg.width, height=cfg.height, y0=y0, tile_h=cfg.tile_h,
               tile_w=cfg.tile_w, strength=cfg.bump_strength, freq=cfg.bump_frequency)
    return fragments_from_planes(planes, bh, W)


def _shade_band(frags, state: SceneState, cfg: RendererConfig, view_proj, inv_vp, y0: int, g, bumped: bool):
    """With cfg.normal_mapping the bump unless the planes are `bumped`
    already (_bump_band), then G-buffer encode, shading and post for the
    band in `frags` (rows [y0, y0 + band_h) of the frame) -> (uint8 band,
    the shading's overflow count)."""
    band_h, W = frags.depth.shape
    rows = dict(y_offset=y0, full_height=cfg.height)
    overflow = torch.zeros((), dtype=torch.int32, device=frags.depth.device)
    if cfg.normal_mapping and not bumped:
        frags = _bump_band(frags, cfg, view_proj, inv_vp, y0)
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
    frame, overflow = _render_band(state, cfg, g.index * band, band, g)
    frame = g.all_gather_tiled(frame)
    overflow = g.sum(overflow)
    return (frame, {"overflow": overflow}) if return_stats else frame


# ---------------------------------------------------------------------------
# Triangle shards: sort-last compositing
# ---------------------------------------------------------------------------


def _stack_planes(frags: FragmentPlanes) -> torch.Tensor:
    """[H, W, 7] float32: depth, normal xyz, u, v and the mesh id (exact as
    a float; -1 for background)."""
    return torch.cat([frags.depth[..., None], frags.normal, frags.uv,
                      frags.mesh_id.to(torch.float32)[..., None]], -1)


def _unstack_planes(p: torch.Tensor) -> FragmentPlanes:
    return FragmentPlanes(depth=p[..., 0], normal=p[..., 1:4], uv=p[..., 4:6], mesh_id=p[..., 6].to(torch.int32))


def _raster_band_tri_slice(state: SceneState, cfg: RendererConfig, tri: BandGroup, y0: int, band_h: int):
    """Rasterize this rank's contiguous slice of the triangle stream over
    rows [y0, y0 + band_h) -> (FragmentPlanes, view_proj, inv_vp, the
    raster's overflow count).  The whole stream is set up, padded to
    n_tri * ceil(T / n_tri) records with invalid ones (valid False,
    TRI_VALID 0: they never win a pixel) and cut into n_tri slices.  With
    cfg.use_pallas the tile raster's band mode over the slice's binned
    records, else the reference raster.  No bump here: it reads
    neighbouring pixels, which one slice's partial coverage does not hold
    (_shade_band bumps the composited sub-band)."""
    tris, view_proj = setup_frame_triangles(state, cfg)
    inv_vp = inverse_view_proj(view_proj)
    T = tris.packed.shape[0]
    per = -(-T // tri.total)
    lo, hi = tri.index * per, min((tri.index + 1) * per, T)
    packed, aabb, valid = tris.packed[lo:hi], tris.aabb[lo:hi], tris.valid[lo:hi]
    if hi - lo < per:  # the last slices: padding records
        pad = per - max(hi - lo, 0)
        packed = torch.cat([packed, packed.new_zeros((pad, packed.shape[1]))])
        aabb = torch.cat([aabb, aabb.new_zeros((pad, 4))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    if cfg.use_pallas:
        frags, overflow = rasterize_binned(packed, aabb, valid, cfg, return_overflow=True,
                                           band_h=band_h, y_offset=y0)
    else:
        frags = rasterize_packed(packed, band_h, cfg.width, y0)
        overflow = torch.zeros((), dtype=torch.int32, device=packed.device)
    return frags, view_proj, inv_vp, overflow


def _composite_tri(frags: FragmentPlanes, tri: BandGroup) -> FragmentPlanes:
    """Sort-last composite of the tri axis's partial fragment planes -> this
    rank's sub-band (band_h / n_tri rows, sub-band tri.index) of the merged
    planes.

    The single-device raster is depth-LESS first-wins: a pixel's winner is
    the (depth, submission index) minimum.  Each rank holds a contiguous
    slice of the stream, so its own winner is its slice's minimum, and the
    merged winner is the minimum over ranks of (depth, rank): an all-reduce
    by minimum of the depth, then of the rank among those that hold it
    (-0.0 == +0.0: the first slice wins, as the first triangle does).
    Every plane then merges by one masked sum scattered to the sub-bands:
    exactly one rank contributes a pixel, and the others add -0.0, so the
    winner's bits come through unchanged (its depth's sign of zero too).
    Background pixels (depth 1.0 on every rank) resolve to rank 0, whose
    cleared planes equal everyone's."""
    planes = _stack_planes(frags)
    depth = planes[..., 0]
    won = depth == tri.min(depth)
    rank = tri.min(torch.where(won, tri.index, tri.total).to(torch.int32))
    win = (won & (rank == tri.index))[..., None]
    contrib = torch.where(win, planes, torch.full((), -0.0, dtype=planes.dtype, device=planes.device))
    return _unstack_planes(tri.sum_scatter(contrib))


def _shade_axes(mesh: Mesh, rows_axis, tri_axis: str) -> BandAxes:
    """The shading's band handle: bands over rows major, tri minor, which
    matches y0 = rows_idx * band_h + tri_idx * sub_h for any order of the
    mesh's declaration."""
    return BandAxes.of(mesh, (rows_axis, tri_axis) if rows_axis else (tri_axis,))


class _TriPlan(NamedTuple):
    tri: BandGroup
    axes: BandAxes  # (rows, tri), major -> minor
    y0_band: int    # the first row of this rank's rows-axis band
    band: int       # rows of a rows-axis band
    sub: int        # rows a rank shades: band / n_tri


def _tri_plan(cfg: RendererConfig, mesh: Mesh, tri_axis: str, rows_axis) -> _TriPlan:
    """The triangle shards' split of the frame, its refusals raised before
    any collective: the height by the rows axis, each band by the tri axis
    (the shading's sub-bands), and _check_band_safe of the sub-band."""
    tri = BandGroup.of_axis(mesh, tri_axis)
    rows = BandGroup.of_axis(mesh, rows_axis) if rows_axis else BandGroup(None, 0, 1, mesh.staged)
    n_t, n_r = tri.total, rows.total
    if cfg.height % n_r:
        raise ValueError(f"height {cfg.height} not divisible by {n_r} bands")
    band = cfg.height // n_r
    if band % n_t:
        raise ValueError(f"band height {band} not divisible by {n_t} triangle shards (shading sub-bands)")
    sub = band // n_t
    _check_band_safe(cfg, sub)
    return _TriPlan(tri, _shade_axes(mesh, rows_axis, tri_axis), rows.index * band, band, sub)


def _render_tri_band(state: SceneState, cfg: RendererConfig, plan: _TriPlan):
    """This rank's shaded sub-band -> (uint8 [sub, W, 3], the overflow of
    its slice's raster and its sub-band's shading, the composited planes of
    its sub-band)."""
    frags, view_proj, inv_vp, r_overflow = _raster_band_tri_slice(state, cfg, plan.tri, plan.y0_band, plan.band)
    merged = _composite_tri(frags, plan.tri)
    color, s_overflow = _shade_band(merged, state, cfg, view_proj, inv_vp, plan.y0_band + plan.tri.index * plan.sub,
                                    plan.axes, bumped=False)
    return color, r_overflow + s_overflow, merged


def render_tri_sharded(state: SceneState, cfg: RendererConfig, mesh: Mesh, tri_axis: str = "tri",
                       rows_axis: str | None = None, return_stats: bool = False):
    """One frame with the triangle stream split over mesh axis `tri_axis`
    (sort-last compositing), and with `rows_axis` its rows in bands too ->
    uint8 [H, W, 3], the whole frame on every rank; with return_stats also
    {"overflow": the int32 count summed over both axes}.

    Each rank rasterizes its slice of the records over its band, the slices
    composite (_composite_tri), and each rank shades a sub-band of band /
    n_tri rows through the row-band machinery, the (rows, tri) bands one
    flat band axis to every filter.  Always the staged chain (the composite
    needs the planes between raster and shading): on the card it equals the
    single-device staged frame (cfg.fused=False).  Every rank of the mesh
    calls it with the same state and config; ranks on other axes render
    the same frame."""
    plan = _tri_plan(cfg, mesh, tri_axis, rows_axis)
    color, overflow, _ = _render_tri_band(state, cfg, plan)
    frame = plan.axes.all_gather_tiled(color)
    overflow = plan.axes.sum(overflow)
    return (frame, {"overflow": overflow}) if return_stats else frame


# ---------------------------------------------------------------------------
# Frame batches
# ---------------------------------------------------------------------------


def _with_time(state: SceneState, t) -> SceneState:
    """The state with its animation clock set to t: every mesh's yaw = t
    (main.cpp:200-207)."""
    t = torch.as_tensor(t, dtype=torch.float32).to(state.time.device)
    orientation = state.orientation.clone()
    orientation[:, 1] = t
    return dataclasses.replace(state, time=t, orientation=orientation)


def animation_times(start_time: float, num_frames: int, yaw_per_frame: float = 0.01, device=None) -> torch.Tensor:
    """The reference's animation clock for `num_frames` consecutive frames
    after `start_time` -> float32 [num_frames] on `device` (the CUDA device
    when None), wrapped to [0, 2 pi) by the floored float modulo (the exact
    fmod, as scene.animate and jnp.mod take it)."""
    dev = default_device() if device is None else torch.device(device)
    t = start_time + yaw_per_frame * (1 + torch.arange(num_frames, dtype=torch.float32, device=dev))
    return _mod(t, XM_2PI)


def _frame_share(times: torch.Tensor, frames: BandGroup):
    B = times.shape[0]
    per = B // frames.total
    return times[frames.index * per : (frames.index + 1) * per]


def render_frames_batch_sharded(state: SceneState, times: torch.Tensor, cfg: RendererConfig, mesh: Mesh,
                                frame_axis: str = "frame", rows_axis: str = "rows", return_stats: bool = False):
    """Frames at animation clocks `times` [B] -> uint8 [B, H, W, 3] on every
    rank: the frames split over mesh axis `frame_axis` (B / n_frame a rank,
    each at its own clock), the rows of each in bands over `rows_axis`
    (render_sharded's branches).  With return_stats also {"overflow": the
    count summed over every band of every frame}."""
    frames, rows = BandGroup.of_axis(mesh, frame_axis), BandGroup.of_axis(mesh, rows_axis)
    if times.shape[0] % frames.total or cfg.height % rows.total:
        raise ValueError("batch/height not divisible by mesh axes")
    band = cfg.height // rows.total
    _check_band_safe(cfg, band)
    out, overflow = [], torch.zeros((), dtype=torch.int32, device=state.time.device)
    for t in _frame_share(times, frames):
        color, ovf = _render_band(_with_time(state, t), cfg, rows.index * band, band, rows)
        out.append(color)
        overflow = overflow + ovf
    batch = frames.all_gather_tiled(rows.all_gather_tiled(torch.stack(out), dim=1))
    overflow = frames.sum(rows.sum(overflow))
    return (batch, {"overflow": overflow}) if return_stats else batch


def render_frames_batch_tri_sharded(state: SceneState, times: torch.Tensor, cfg: RendererConfig, mesh: Mesh,
                                    frame_axis: str = "frame", tri_axis: str = "tri", rows_axis: str | None = None,
                                    return_stats: bool = False):
    """Frames at clocks `times` [B] -> uint8 [B, H, W, 3] on every rank:
    frames over `frame_axis`, the triangle stream over `tri_axis` and, with
    `rows_axis`, rows in bands: the three axes composed (render_tri_sharded
    for each of a rank's frames).  With return_stats also {"overflow": the
    count summed over every axis}."""
    frames = BandGroup.of_axis(mesh, frame_axis)
    if times.shape[0] % frames.total:
        raise ValueError("batch/height not divisible by mesh axes")
    plan = _tri_plan(cfg, mesh, tri_axis, rows_axis)
    out, overflow = [], torch.zeros((), dtype=torch.int32, device=state.time.device)
    for t in _frame_share(times, frames):
        color, ovf, _ = _render_tri_band(_with_time(state, t), cfg, plan)
        out.append(color)
        overflow = overflow + ovf
    batch = frames.all_gather_tiled(plan.axes.all_gather_tiled(torch.stack(out), dim=1))
    overflow = frames.sum(plan.axes.sum(overflow))
    return (batch, {"overflow": overflow}) if return_stats else batch
