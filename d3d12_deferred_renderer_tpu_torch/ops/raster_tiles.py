"""Tile rasterizer: binned records -> the 8 fragment planes of the staged frame.

The counterpart of d3d12_deferred_renderer_tpu/ops/raster_pallas.py's
``rasterize_binned`` and its kernels ``_raster_kernel_stream`` /
``_raster_kernel_indirect``.  Each screen tile (tile_h x tile_w pixels)
rasterizes its segment ``stream[offs[t] : offs[t] + counts[t]]`` of the
binned record stream in submission order, with the rules of
ops/raster_ref.py (pixel centers, top-left fill, [0, 1] depth clip, strict
depth LESS so the first triangle wins a tie, perspective-correct
attributes), and writes the planes in the order of the JAX package's
``_RASTER_CHANNELS``: depth (cleared to 1), normal xyz, u, v (cleared to 0),
mesh id (a float, -1 for background) and a zero pad plane.

``raster_tile_pixels`` is the raster loop itself, in plain PyTorch over
[tiles, pixels] tensors: the plain version of the tile raster that the fused
tile kernel and this module's kernels share (csrc/raster.cuh).
``raster_tiles_reference`` lays its output out as planes; ``raster_tiles``
is the wrapper that runs the CUDA kernel (csrc/raster.cu) on CUDA tensors and
the plain version on CPU tensors.  ``raster_depth`` / ``raster_depth_reference``
are the same pair for the depth-only raster (the JAX package's
``rasterize_depth`` kernels: the shadow map, on 16 x 128 tiles of up to 2048
pixels), bit-equal to the full raster's depth plane.  Both kernels cut each
tile's records into work items of at most ``records_per_block``, one block
each.  The depth kernel merges them with an atomic minimum (the depth is
order-free), which equals the serial walk of the plain version under
torch.equal (-0.0 comes out as +0.0).  The planes kernel merges them in a
visibility buffer: the atomic minimum of (depth, stream row) keys picks
each pixel's winning record, which a last pass evaluates again at the
pixel, so all 8 planes are bit-equal to the serial walk's, the depth's sign
included.  The stream variant serves every scene: the port's binning always
builds the stream.

Band mode (the screen-row band path, parallel/sharded.py): with ``y_offset``
(the kernels' ``y0``) the tile grid covers rows [y_offset, y_offset +
band_h) of a taller frame; tile row ty's pixel centres are y_offset + ty *
tile_h + 0.5 + row, exact in float32 for rows below 2^24, so a band's planes
are bit-equal to the same rows of the full frame's.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..config import RendererConfig
from .binning import bin_triangles
from .raster_ref import FragmentPlanes, perspective_attr, triangle_fragments
from .transform import TRI_MESH_ID, TRI_N0, TRI_STRIDE, TRI_UV0, TRI_VALID

F32 = torch.float32

PLANE_DEPTH, PLANE_NX, PLANE_NY, PLANE_NZ = 0, 1, 2, 3
PLANE_U, PLANE_V, PLANE_MID, PLANE_PAD = 4, 5, 6, 7
NUM_PLANES = 8


class TileFragments(NamedTuple):
    """Raster output per tile pixel, each [NT, P] (tiles row-major, pixels
    row-major inside a tile)."""

    depth: torch.Tensor
    normal: List[torch.Tensor]  # 3 planes
    uv: List[torch.Tensor]      # 2 planes, empty when not asked for
    mesh_id: torch.Tensor       # float, -1 where no fragment


def tile_pixels(nty: int, ntx: int, tile_h: int, tile_w: int, device, y0: int = 0):
    """Pixel-center coordinates (px, py), each [NT, P], of every tile of a
    grid whose first pixel row is y0."""
    i = torch.arange(tile_h * tile_w, device=device)
    row = (i // tile_w).to(F32)
    col = (i % tile_w).to(F32)
    ty = torch.arange(nty, device=device).repeat_interleave(ntx).to(F32)[:, None]
    tx = torch.arange(ntx, device=device).repeat(nty).to(F32)[:, None]
    py = ((ty * tile_h + y0) + 0.5) + row[None, :]
    px = (tx * tile_w + 0.5) + col[None, :]
    return px, py


def tiles_to_image(a: torch.Tensor, nty: int, ntx: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., NT, P] per-tile pixels -> [..., Hp, Wp] image rows."""
    lead = a.shape[:-2]
    return (
        a.reshape(*lead, nty, ntx, tile_h, tile_w)
        .transpose(-3, -2)
        .reshape(*lead, nty * tile_h, ntx * tile_w)
    )


def image_to_tiles(a: torch.Tensor, nty: int, ntx: int, tile_h: int, tile_w: int) -> torch.Tensor:
    """[C, Hp, Wp] image rows -> [C, NT, P] per-tile pixels."""
    C = a.shape[0]
    return (
        a.reshape(C, nty, tile_h, ntx, tile_w)
        .transpose(2, 3)
        .reshape(C, nty * ntx, tile_h * tile_w)
    )


def raster_tile_pixels(counts, offs, stream, px, py, uv: bool = True,
                       attrs: bool = True) -> TileFragments:
    """Plain version of the tile raster: one list slot at a time over every
    tile.  counts [NT] int32, offs [NT + 1] int32, stream [R, 32] f32,
    px/py [NT, P] pixel centers.  With attrs False only the depth is
    rasterized (normal and uv lists empty, mesh id None)."""
    dev = stream.device
    NT, P = px.shape
    uv = uv and attrs
    depth = torch.ones((NT, P), dtype=F32, device=dev)
    nrm = [torch.zeros((NT, P), dtype=F32, device=dev) for _ in range(3 if attrs else 0)]
    tex = [torch.zeros((NT, P), dtype=F32, device=dev) for _ in range(2 if uv else 0)]
    mid = torch.full((NT, P), -1.0, dtype=F32, device=dev)
    base = offs[:-1].long()
    n_slots = int(counts.max()) if NT else 0
    for k in range(n_slots):
        rows = torch.clamp(base + k, max=stream.shape[0] - 1)
        rec = stream[rows]  # [NT, 32]
        covered, z, bs = triangle_fragments(rec, px, py)
        ok = (rec[:, TRI_VALID : TRI_VALID + 1] > 0.0) & (k < counts)[:, None]
        passes = covered & ok & (z >= 0.0) & (z <= 1.0) & (z < depth)
        depth = torch.where(passes, z, depth)
        if not attrs:
            continue
        for j in range(3):
            nrm[j] = torch.where(passes, perspective_attr(rec, bs, TRI_N0 + j, 3), nrm[j])
        for j in range(len(tex)):
            tex[j] = torch.where(passes, perspective_attr(rec, bs, TRI_UV0 + j, 2), tex[j])
        mid = torch.where(passes, rec[:, TRI_MESH_ID : TRI_MESH_ID + 1], mid)
    return TileFragments(depth=depth, normal=nrm, uv=tex, mesh_id=mid if attrs else None)


def raster_tiles_reference(counts, offs, stream, *, nty, ntx, tile_h, tile_w, y0: int = 0) -> torch.Tensor:
    """Plain version of the tile raster kernel -> planes [8, Hp, Wp] f32 of
    the grid whose first pixel row is y0."""
    px, py = tile_pixels(nty, ntx, tile_h, tile_w, stream.device, y0)
    f = raster_tile_pixels(counts, offs, stream, px, py, uv=True)
    planes = torch.stack([f.depth, *f.normal, *f.uv, f.mesh_id, torch.zeros_like(f.depth)])
    return tiles_to_image(planes, nty, ntx, tile_h, tile_w)


# Records of a tile's segment that one block of the tile raster kernel
# rasterizes; a tile with more splits over several blocks, merged in a
# visibility buffer (csrc/raster.cu).  The fastest of 16, 32, 64 and 128 on
# the staged flagship on an H100 (PERF.md).
TILE_RECORDS_PER_BLOCK = 32


def raster_tiles(counts, offs, stream, *, nty, ntx, tile_h, tile_w, y0: int = 0,
                 records_per_block: int = TILE_RECORDS_PER_BLOCK) -> torch.Tensor:
    """Tile raster: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see raster_tiles_reference for the contract).
    records_per_block (tests force it small) cuts the kernel's work items;
    the planes do not depend on it."""
    if stream.device.type == "cpu":
        return raster_tiles_reference(counts, offs, stream, nty=nty, ntx=ntx,
                                      tile_h=tile_h, tile_w=tile_w, y0=y0)
    from ..utils import cuda_build

    NT = nty * ntx
    cuda_build.check_tensors(
        stream.device,
        counts=(counts, torch.int32, (NT,)),
        offs=(offs, torch.int32, (NT + 1,)),
        stream=(stream, F32, (None, TRI_STRIDE)),
    )
    if tile_h * tile_w > 1024:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's 1024")
    check_band_rows(y0, nty * tile_h)
    if records_per_block < 1:
        raise ValueError(f"records_per_block must be positive, got {records_per_block}")
    Hp, Wp = nty * tile_h, ntx * tile_w
    planes = torch.empty((NUM_PLANES, Hp, Wp), dtype=F32, device=stream.device)
    keys = torch.empty((Hp * Wp,), dtype=torch.int64, device=stream.device)  # the visibility buffer
    err = cuda_build.library().raster_tiles_launch(
        counts.data_ptr(), offs.data_ptr(), stream.data_ptr(), stream.shape[0], nty, ntx, tile_h, tile_w,
        y0, records_per_block, keys.data_ptr(), planes.data_ptr(),
        torch.cuda.current_stream(stream.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "raster_tiles")
    raster_tiles.launches += 1
    return planes


raster_tiles.launches = 0


def check_band_rows(y0: int, rows: int) -> None:
    """The kernels take the band's first row as an int and compute pixel
    centres in float32: every row must stay below 2^24 to be exact."""
    if y0 < 0 or y0 + rows > 1 << 24:
        raise ValueError(f"band rows [{y0}, {y0 + rows}) outside [0, 2^24)")


# The depth-only kernel runs 256 threads of up to 8 pixels a tile: the
# shadow map's 16 x 128 tiles.
DEPTH_MAX_TILE_PIXELS = 2048
# Records of a tile's segment that one block of the depth-only kernel
# rasterizes (a multiple of the kernel's 64-record chunk); a tile with more
# splits over several blocks, merged by an atomic minimum (csrc/raster.cu).
# The fastest of 64, 128 and 256 on the flagship's shadow map on an H100
# (PERF.md).
DEPTH_RECORDS_PER_BLOCK = 64


def raster_depth_reference(counts, offs, stream, *, nty, ntx, tile_h, tile_w, y0: int = 0) -> torch.Tensor:
    """Plain version of the depth-only tile raster kernel -> depth [Hp, Wp]
    f32, cleared to 1: the depth plane of raster_tiles_reference."""
    px, py = tile_pixels(nty, ntx, tile_h, tile_w, stream.device, y0)
    f = raster_tile_pixels(counts, offs, stream, px, py, attrs=False)
    return tiles_to_image(f.depth, nty, ntx, tile_h, tile_w)


def raster_depth(counts, offs, stream, *, nty, ntx, tile_h, tile_w, y0: int = 0,
                 records_per_block: int = DEPTH_RECORDS_PER_BLOCK) -> torch.Tensor:
    """Depth-only tile raster: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see raster_depth_reference for the contract).
    records_per_block (tests force it small) cuts the kernel's work items;
    the depth does not depend on it."""
    if stream.device.type == "cpu":
        return raster_depth_reference(counts, offs, stream, nty=nty, ntx=ntx,
                                      tile_h=tile_h, tile_w=tile_w, y0=y0)
    from ..utils import cuda_build

    NT = nty * ntx
    cuda_build.check_tensors(
        stream.device,
        counts=(counts, torch.int32, (NT,)),
        offs=(offs, torch.int32, (NT + 1,)),
        stream=(stream, F32, (None, TRI_STRIDE)),
    )
    if tile_h * tile_w > DEPTH_MAX_TILE_PIXELS:
        raise ValueError(f"tile of {tile_h}x{tile_w} pixels exceeds the kernel's {DEPTH_MAX_TILE_PIXELS}")
    check_band_rows(y0, nty * tile_h)
    if records_per_block < 1:
        raise ValueError(f"records_per_block must be positive, got {records_per_block}")
    depth = torch.empty((nty * tile_h, ntx * tile_w), dtype=F32, device=stream.device)
    err = cuda_build.library().raster_depth_launch(
        counts.data_ptr(), offs.data_ptr(), stream.data_ptr(), stream.shape[0], nty, ntx, tile_h,
        tile_w, y0, records_per_block, depth.data_ptr(), torch.cuda.current_stream(stream.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "raster_depth")
    raster_depth.launches += 1
    return depth


raster_depth.launches = 0


def rasterize_depth(packed, aabb, valid, cfg: RendererConfig, return_overflow: bool = False,
                    band_h: int | None = None, y_offset: int = 0):
    """Bin the [T, 32] records onto the cfg tile grid and rasterize depth
    only -> depth [H, W] (cleared to 1; bit-equal to rasterize_binned's
    depth), and with return_overflow the binning's int32 overflow count.
    The frame size comes from cfg: the shadow map passes a config of its
    own size (shadows.shadow_bin_config).  With band_h, rows [y_offset,
    y_offset + band_h) of the frame only -> depth [band_h, W]."""
    H = band_h or cfg.height
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-cfg.width // TW)
    binned = bin_triangles(packed, aabb, valid, cfg, band_h, y_offset)
    depth = raster_depth(binned.counts, binned.offs, binned.stream,
                         nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, y0=y_offset)[:H, : cfg.width]
    return (depth, binned.overflow) if return_overflow else depth


def fragments_from_planes(planes: torch.Tensor, height: int, width: int) -> FragmentPlanes:
    """The [8, Hp, Wp] planes cropped to the frame, as FragmentPlanes."""
    p = planes[:, :height, :width]
    return FragmentPlanes(
        depth=p[PLANE_DEPTH],
        normal=p[PLANE_NX : PLANE_NZ + 1].permute(1, 2, 0),
        uv=p[PLANE_U : PLANE_V + 1].permute(1, 2, 0),
        mesh_id=p[PLANE_MID].to(torch.int32),
    )


def rasterize_binned(packed, aabb, valid, cfg: RendererConfig, return_overflow: bool = False,
                     band_h: int | None = None, y_offset: int = 0, inv_vp=None):
    """Bin the [T, 32] records onto the cfg tile grid and rasterize every
    tile -> FragmentPlanes (the raster_ref.rasterize_packed contract), and
    with return_overflow the binning's int32 overflow count (tiles that lost
    triangles at a capacity cap).  With band_h, rows [y_offset, y_offset +
    band_h) of the frame only (any band height: a partial last tile row is
    rasterized and cropped).  With cfg.normal_mapping and the frame's
    inverse view-projection inv_vp, the bump kernel perturbs the planes'
    normals in place before they are cropped (ops/bump.bump_tiles): the
    staged frame's and the staged band's raster and bump, with no copy of
    the planes between them."""
    H = band_h or cfg.height
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-cfg.width // TW)
    binned = bin_triangles(packed, aabb, valid, cfg, band_h, y_offset)
    planes = raster_tiles(binned.counts, binned.offs, binned.stream,
                          nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, y0=y_offset)
    if cfg.normal_mapping and inv_vp is not None:
        from .bump import bump_tiles  # ops/bump builds on this module's tile helpers

        bump_tiles(planes, inv_vp, width=cfg.width, height=cfg.height, y0=y_offset, tile_h=TH, tile_w=TW,
                   strength=cfg.bump_strength, freq=cfg.bump_frequency)
    frags = fragments_from_planes(planes, H, cfg.width)
    return (frags, binned.overflow) if return_overflow else frags
