"""PyTorch port: the two exactness arguments of the depth raster's redesign
(csrc/raster.cuh, csrc/raster.cu), checked on the CPU where no kernel runs.

1. The per-warp record rejection is conservative.  ``record_box`` mirrors
   raster.cuh's ``record_box`` operation for operation in float32, and
   ``group_rects`` the rectangles of a warp's pixel centres; a (record,
   group) pair the kernel skips must hold no pixel that the raster's edge
   tests cover (raster_ref.triangle_fragments, the arithmetic of the
   kernel and of its plain version).  Run on random records (sub-pixel,
   sliver, degenerate, pixel-aligned, huge and near-plane-clipped sizes,
   at the largest screen and shadow-map coordinates) and on a small
   flagship frame and its shadow map, where most pairs must be skipped.
2. The depth kernel's split is exact.  A plain model of it rasterizes each
   work item of at most R records with raster_tile_pixels, turns -0.0 into
   +0.0 and merges by a minimum of the bits as unsigned ints from 1.0; it
   equals the serial raster_depth_reference under torch.equal at R = 8, on
   a shadow map whose densest tile starts with records at z = -0.0, and the
   same merge without the canonicalisation does not.
"""
import dataclasses

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import raster_tiles, shadows
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import triangle_fragments
from d3d12_deferred_renderer_tpu_torch.ops.transform import (
    TRI_AREA, TRI_STRIDE, TRI_VALID, TRI_Z0, setup_frame_triangles,
)
from d3d12_deferred_renderer_tpu_torch.xmath import fma

F32 = torch.float32
INF = float("inf")
# raster.cuh kThreads.  K2's 512 threads of 2 pixels cut a tile into the
# same 32-pixel groups, only owned by other warps.
THREADS = 256
ONE_BITS = 0x3F800000


def record_box(rec: torch.Tensor, px_max: float, py_max: float) -> torch.Tensor:
    """raster.cuh record_box over [N, 32] records -> [N, 4] (x lo, x hi,
    y lo, y hi): fminf/fmaxf are torch.fmin/fmax (a NaN operand drops)."""
    x0, y0, x1, y1, x2, y2 = (rec[:, i] for i in range(6))
    xmin, xmax = torch.fmin(torch.fmin(x0, x1), x2), torch.fmax(torch.fmax(x0, x1), x2)
    ymin, ymax = torch.fmin(torch.fmin(y0, y1), y2), torch.fmax(torch.fmax(y0, y1), y2)
    w, h = xmax - xmin, ymax - ymin
    p, q = (x1 - x0) * (y2 - y0), (x2 - x0) * (y1 - y0)
    area_lo = (p - q) - 2.0**-21 * (p.abs() + q.abs())
    err = torch.zeros_like(x0)
    for a, b in ((1, 2), (2, 0), (0, 1)):
        ax, ay, bx, by = rec[:, 2 * a], rec[:, 2 * a + 1], rec[:, 2 * b], rec[:, 2 * b + 1]
        bxay = bx * ay
        c = fma(ax, by, -bxay)
        err = torch.fmax(err, (2.0 * (ay - by).abs() * px_max + 3.0 * (bx - ax).abs() * py_max)
                         + (bxay.abs() + c.abs()))
    m = torch.fmax(torch.ones_like(err), 2.0 * (2.0**-22 * err) * torch.fmax(w, h) / area_lo)
    box = torch.stack([xmin - m, xmax + m, ymin - m, ymax + m], 1)
    keep_all = ~((area_lo > 0.0) & (w * h <= 4096.0) & (m < 1e30))
    box[keep_all] = torch.tensor([-INF, INF, -INF, INF])
    box[~(rec[:, TRI_VALID] > 0.0)] = torch.tensor([INF, -INF, INF, -INF])
    return box


def group_rects(ty: int, tx: int, tile_h: int, tile_w: int):
    """The rectangle of pixel centres (x lo, x hi, y lo, y hi) of each warp
    group of a tile, as raster.cuh's warp_groups takes them: group (warp,
    j) holds pixels 32 warp + THREADS j + lane.  -> ([G, 4], pixel index
    [G, 32] with -1 past the tile)."""
    P = tile_h * tile_w
    NP = -(-P // THREADS)
    lane = torch.arange(32)
    idx = torch.stack([32 * w + THREADS * j + lane for j in range(NP) for w in range(THREADS // 32)])
    inb = idx < P
    px = (tx * tile_w + 0.5) + (idx % tile_w).to(F32)
    py = (ty * tile_h + 0.5) + (idx // tile_w).to(F32)
    rect = torch.stack([torch.where(inb, px, INF).amin(1), torch.where(inb, px, -INF).amax(1),
                        torch.where(inb, py, INF).amin(1), torch.where(inb, py, -INF).amax(1)], 1)
    return rect, torch.where(inb, idx, -1)


def skipped_and_covered(rec, ty, tx, tile_h, tile_w):
    """For records [N, 32] in tile (ty, tx): the (record, group) pairs the
    kernel skips, and those with a covered pixel, each [N, G]."""
    rect, gidx = group_rects(ty, tx, tile_h, tile_w)
    box = record_box(rec, float((tx + 1) * tile_w), float((ty + 1) * tile_h))
    b = box[:, None, :]
    miss = (rect[None, :, 1] < b[..., 0]) | (rect[None, :, 0] > b[..., 1]) \
        | (rect[None, :, 3] < b[..., 2]) | (rect[None, :, 2] > b[..., 3])
    px, py = raster_tiles.tile_pixels(1, 1, tile_h, tile_w, "cpu")
    covered, _, _ = triangle_fragments(rec, px + tx * tile_w, py + ty * tile_h)
    covered = covered & (rec[:, TRI_VALID : TRI_VALID + 1] > 0.0)
    cov_g = (covered[:, gidx.clamp(min=0)] & (gidx >= 0)).any(-1)
    return miss, cov_g


def random_records(rng, n, cx, cy):
    """[n, 32] records around (cx, cy) in six size regimes, with positive
    winding as the setup canonicalises it (a few left negative)."""
    kind = rng.integers(0, 6, n)
    scale = np.array([0.7, 4.0, 40.0, 3.0, 3.0, 1e5])[kind]
    v = rng.uniform(-1, 1, (n, 3, 2)) * scale[:, None, None]
    v += np.array([cx, cy]) + rng.uniform(-20, 20, (n, 1, 2))
    sliver = kind == 3  # nearly collinear: v2 near the line v0 -> v1
    v[sliver, 2] = v[sliver, 0] + (v[sliver, 1] - v[sliver, 0]) * rng.uniform(-2, 3, (sliver.sum(), 1)) \
        + rng.uniform(-1e-3, 1e-3, (sliver.sum(), 2))
    snap = kind == 4  # vertices on pixel centres and edges: top-left ties
    v[snap] = np.round(v[snap] * 2) / 2
    v[:6:2, 1] = v[:6:2, 0]  # exactly degenerate
    near = kind == 5  # near-plane clipped: one vertex far away
    v[near, 0] = [cx, cy]
    v = v.astype(np.float32)
    area = (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1]) \
        - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0])
    swap = (area < 0) & (rng.uniform(size=n) < 0.95)
    v[swap, 1], v[swap, 2] = v[swap, 2].copy(), v[swap, 1].copy()
    rec = np.zeros((n, TRI_STRIDE), np.float32)
    rec[:, 0:6] = v.reshape(n, 6)
    rec[:, TRI_Z0 : TRI_Z0 + 3] = rng.uniform(0, 1, (n, 3))
    rec[:, TRI_VALID] = 1.0
    rec[:, TRI_AREA] = np.abs(area)
    return torch.from_numpy(rec)


# (tile_h, tile_w, ty, tx): the display grid's first and last tiles at
# 1920x1080 and the 1024^2 shadow map's first and last.
RANDOM_TILES = [(8, 128, 0, 0), (8, 128, 134, 14), (16, 128, 0, 0), (16, 128, 63, 7)]


@pytest.mark.parametrize("tile", RANDOM_TILES, ids=[f"{h}x{w}_t{ty}_{tx}" for h, w, ty, tx in RANDOM_TILES])
def test_rejection_is_conservative_on_random_records(tile):
    tile_h, tile_w, ty, tx = tile
    rng = np.random.default_rng(ty * 100 + tx + tile_h)
    rec = random_records(rng, 3000, tx * tile_w + tile_w / 2, ty * tile_h + tile_h / 2)
    miss, cov_g = skipped_and_covered(rec, ty, tx, tile_h, tile_w)
    assert not bool((miss & cov_g).any())
    assert int(cov_g.any(1).sum()) > 500  # many records cover pixels
    assert float(miss.double().mean()) > 0.3  # and many pairs are skipped


@pytest.fixture(scope="module")
def flagship_small():
    """A small flagship frame (256x64) and its 256^2 shadow map on the CPU:
    (frame binning, frame config, shadow binning, shadow config)."""
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True, shadows=True,
                              shadow_map_size=256)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.animate(tp.make_scene(geo, cfg, lights=tp.random_point_lights(8, cfg=cfg, device="cpu"),
                                     placement="grid", device="cpu"), cfg.yaw_per_frame, cfg)
    tris, _ = setup_frame_triangles(state, cfg)
    scfg = shadows.shadow_bin_config(cfg, geo.num_triangles)
    stris = shadows.setup_light_view_triangles(state, scfg, shadows.light_view_proj(state.lights.direction))
    return (bin_triangles(tris.packed, tris.aabb, tris.valid, cfg), cfg,
            bin_triangles(stris.packed, stris.aabb, stris.valid, scfg), scfg)


@pytest.mark.parametrize("which", ["frame", "shadow_map"])
def test_rejection_is_conservative_on_a_frame(flagship_small, which):
    b, cfg = flagship_small[:2] if which == "frame" else flagship_small[2:]
    ntx = -(-cfg.width // cfg.tile_w)
    skipped = pairs = 0
    for t in range(b.counts.numel()):
        n = int(b.counts[t])
        if n == 0:
            continue
        rec = b.stream[int(b.offs[t]) : int(b.offs[t]) + n]
        miss, cov_g = skipped_and_covered(rec, t // ntx, t % ntx, cfg.tile_h, cfg.tile_w)
        assert not bool((miss & cov_g).any()), f"tile {t}"
        skipped += int(miss.sum())
        pairs += miss.numel()
    assert pairs > 0 and skipped / pairs > 0.5


def split_depth_model(counts, offs, stream, *, nty, ntx, tile_h, tile_w, R, canonical=True):
    """Plain model of the depth kernel's split: every work item of at most R
    records rasterized alone (raster_tile_pixels), its depth with -0.0 made
    +0.0 (unless canonical is False), merged into 1.0 by the minimum of the
    bits as unsigned ints -> depth [Hp, Wp]."""
    NT, P = nty * ntx, tile_h * tile_w
    items = [(t, k0) for t in range(NT) for k0 in range(0, int(counts[t]), R)]
    tile = torch.tensor([t for t, _ in items], dtype=torch.long)
    k0 = torch.tensor([k for _, k in items], dtype=torch.int32)
    icounts = torch.minimum(counts[tile] - k0, torch.tensor(R, dtype=torch.int32))
    ioffs = torch.cat([offs[tile] + k0, offs[-1:]])
    px, py = raster_tiles.tile_pixels(nty, ntx, tile_h, tile_w, "cpu")
    d = raster_tiles.raster_tile_pixels(icounts, ioffs, stream, px[tile], py[tile], attrs=False).depth
    if canonical:
        d = d + 0.0
    bits = d.view(torch.int32).long() & 0xFFFFFFFF  # the unsigned value of the bits
    bits = torch.where(d < 1.0, bits, ONE_BITS)
    out = torch.full((NT, P), ONE_BITS, dtype=torch.long)
    out.scatter_reduce_(0, tile[:, None].expand(-1, P), bits, reduce="amin")
    depth = out.to(torch.int32).view(F32)
    return raster_tiles.tiles_to_image(depth, nty, ntx, tile_h, tile_w)


def test_split_depth_model_equals_serial_walk(flagship_small):
    b, scfg = flagship_small[2:]
    R = 8
    assert int(b.counts.max()) > 4 * R  # the densest tiles split into several items
    stream = b.stream.clone()
    row = int(b.offs[int(torch.argmax(b.counts))])
    stream[row : row + 4, TRI_Z0 : TRI_Z0 + 3] = -0.0
    kw = dict(nty=-(-scfg.height // scfg.tile_h), ntx=-(-scfg.width // scfg.tile_w),
              tile_h=scfg.tile_h, tile_w=scfg.tile_w)
    serial = raster_tiles.raster_depth_reference(b.counts, b.offs, stream, **kw)
    neg_zero = serial.view(torch.int32) == torch.iinfo(torch.int32).min
    assert bool(neg_zero.any())
    split = split_depth_model(b.counts, b.offs, stream, R=R, **kw)
    assert torch.equal(split, serial)
    assert not bool((split.view(torch.int32) == torch.iinfo(torch.int32).min).any())
    # Without the canonicalisation -0.0's bits sort above 1.0 and lose.
    raw = split_depth_model(b.counts, b.offs, stream, R=R, canonical=False, **kw)
    assert not torch.equal(raw, serial) and bool((raw[neg_zero] > 0.0).all())
