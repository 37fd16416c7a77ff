"""Screen-tile binning: which triangles each tile rasterizes, in submission order.

The counterpart of the binning half of d3d12_deferred_renderer_tpu/ops/
raster_pallas.py (``BinnedTriangles``, ``bin_triangles_flat``,
``bin_triangles``).  Binning was plain XLA there and is plain PyTorch here.

Output format: a compacted RECORD STREAM.  Tile t's triangles are the rows
``stream[offs[t] : offs[t] + counts[t]]``, in submission order — the order
the depth-LESS "first equal wins" rule needs.  The fused tile kernel reads
exactly that segment.

Two paths with identical semantics:

* ``bin_triangles_flat`` — the O(tiles * T) overlap matrix; small scenes, and
  the oracle the sort path is tested against.
* the sort path of ``bin_triangles`` — each live triangle's tile rectangle is
  expanded into (tile, triangle) keys through four compacted footprint tiers
  (small / medium / large rects, then grid-wide "big" triangles), with
  area-scaled budgets; one sort of the unique int64 key tile * T2 + tri
  groups the pairs per tile in submission order, and ``searchsorted`` gives
  the segment bounds.

Every capacity cap (K triangles per tile, each tier budget, the stream
capacity) adds to ``overflow`` instead of dropping work silently.

Band mode (``band_h``, ``y_offset``: the screen-row band path,
parallel/sharded.py) bins the tiles of rows [y_offset, y_offset + band_h)
of the full frame only; tile row ty starts at pixel row y_offset + ty *
tile_h.  The tier budgets still scale with the full frame's area: a
triangle's tile span is not clipped by a band, so a band's footprints are
the full frame's and a band-area scale would under-budget the tiers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RendererConfig

# Above this many tile x triangle cells bin_triangles takes the sort path.
FLAT_CELLS = 1_000_000

# Rows per light chunk / triangle chunk in the TPU kernels: still the
# granularity of the live-light slot budget (ops/fused.py).
CHUNK = 16

I32 = torch.int32


class BinnedTriangles(NamedTuple):
    counts: torch.Tensor    # [NT] int32 triangles per tile (after every cap)
    overflow: torch.Tensor  # [] int32 loud capacity-overflow count
    idx: torch.Tensor | None = None     # [NT, K] int32 triangle ids (flat oracle)
    stream: torch.Tensor | None = None  # [R, 32] f32 record stream
    offs: torch.Tensor | None = None    # [NT + 1] int32 segment offsets


def _grid(cfg: RendererConfig, band_h: int | None = None):
    nty = -(-(band_h or cfg.height) // cfg.tile_h)
    ntx = -(-cfg.width // cfg.tile_w)
    return nty, ntx


def bin_triangles_flat(aabb, valid, cfg: RendererConfig, band_h: int | None = None,
                       y_offset: int = 0) -> BinnedTriangles:
    """Overlap-matrix binning: tile (ty, tx) takes every valid triangle whose
    AABB satisfies minx < x0 + TW, maxx >= x0 (and likewise in y, y0 =
    y_offset + ty * TH); the first K in submission order are kept."""
    nty, ntx = _grid(cfg, band_h)
    TH, TW = cfg.tile_h, cfg.tile_w
    T = aabb.shape[0]
    K = min(cfg.max_tris_per_tile, T)
    dev = aabb.device
    y0s = y_offset + torch.arange(nty, dtype=torch.float32, device=dev) * TH
    x0s = torch.arange(ntx, dtype=torch.float32, device=dev) * TW
    minx, miny, maxx, maxy = aabb.unbind(1)
    ox = (minx[None, :] < x0s[:, None] + TW) & (maxx[None, :] >= x0s[:, None])
    oy = (miny[None, :] < y0s[:, None] + TH) & (maxy[None, :] >= y0s[:, None])
    overlap = (oy[:, None, :] & ox[None, :, :] & valid[None, None, :]).reshape(nty * ntx, T)
    ids = torch.arange(T, device=dev)
    idx = torch.sort(torch.where(overlap, ids, T + ids), dim=1).values[:, :K] % T
    true_counts = overlap.sum(1)
    counts = torch.clamp(true_counts, max=K).to(I32)
    overflow = (true_counts > K).sum().to(I32)
    return BinnedTriangles(counts=counts, overflow=overflow, idx=idx.to(I32))


def with_stream(binned: BinnedTriangles, packed, cap: int) -> BinnedTriangles:
    """The record stream of a flat binning: tile segments back to back,
    capacity `cap` rows; rows past the cap clamp the tail tiles' counts and
    add one to overflow."""
    NT, K = binned.idx.shape
    counts = binned.counts
    zero = torch.zeros(1, dtype=I32, device=counts.device)
    offs_raw = torch.cat([zero, torch.cumsum(counts, 0).to(I32)])
    offs = torch.clamp(offs_raw, max=cap)
    scounts = torch.minimum(counts, offs[1:] - offs[:-1])
    j = torch.arange(cap, dtype=I32, device=counts.device)
    t = torch.clamp(torch.searchsorted(offs[:-1], j, right=True) - 1, 0, NT - 1)
    local = j - offs[t]
    live = local < scounts[t]
    flat = t * K + torch.clamp(local, max=K - 1)
    src = torch.where(live, binned.idx.reshape(-1)[flat], 0)
    overflow = binned.overflow + (offs_raw[NT] > cap).to(I32)
    return binned._replace(
        counts=scounts, overflow=overflow, stream=packed[src.long()], offs=offs
    )


def bin_triangles(packed, aabb, valid, cfg: RendererConfig, band_h: int | None = None,
                  y_offset: int = 0) -> BinnedTriangles:
    """Bin the [T, 32] triangle records onto the cfg tile grid, or with
    band_h onto the band's (see module docstring) -> counts, overflow, the
    record stream and its offsets."""
    nty, ntx = _grid(cfg, band_h)
    NT = nty * ntx
    T = packed.shape[0]
    K = min(cfg.max_tris_per_tile, T)
    TH, TW = cfg.tile_h, cfg.tile_w
    dev = packed.device

    if T * NT <= FLAT_CELLS:
        return with_stream(bin_triangles_flat(aabb, valid, cfg, band_h, y_offset), packed,
                           cfg.bin_stream_cap)

    # Tier budgets scale with the full framebuffer's area (base 1080p), in
    # band mode too: at 4K a triangle's tile footprint quadruples.
    area_scale = max(1, round((cfg.height * cfg.width) / (1920 * 1080)))
    E = max(1, cfg.bin_expand * area_scale)
    EM = max(E + 1, cfg.bin_expand_medium * area_scale)
    MB = min(cfg.bin_max_medium * area_scale, T)
    EL = max(EM + 1, cfg.bin_expand_large * area_scale)
    ML = min(cfg.bin_max_large * area_scale, T)
    B = min(cfg.bin_max_big * area_scale, T)
    LS = T if cfg.bin_max_small < 0 else min(cfg.bin_max_small * area_scale, T)
    # When the large tier's rect already covers the grid no footprint exceeds
    # it, and the grid-wide big tier would emit only sentinels.
    has_big = EL < NT

    # Tile-index rectangle per triangle: tx in [floor(minx/TW), floor(maxx/TW)]
    # is exactly the flat path's overlap condition.
    minx, miny, maxx, maxy = aabb.unbind(1)
    tx0 = torch.floor(minx / TW).to(I32)
    tx1 = torch.floor(maxx / TW).to(I32)
    ty0 = torch.floor((miny - y_offset) / TH).to(I32)
    ty1 = torch.floor((maxy - y_offset) / TH).to(I32)
    live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
    tx0, tx1 = tx0.clamp(0, ntx - 1), tx1.clamp(0, ntx - 1)
    ty0, ty1 = ty0.clamp(0, nty - 1), ty1.clamp(0, nty - 1)
    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1
    footprint = w * h

    small = live & (footprint <= E)
    medium = live & (footprint > E) & (footprint <= EM)
    if has_big:
        large = live & (footprint > EM) & (footprint <= EL)
        big = live & (footprint > EL)
    else:
        large = live & (footprint > EM)
        big = torch.zeros_like(live)
    tier = torch.full((T,), 4, dtype=I32, device=dev)
    for code, mask in ((3, big), (2, large), (1, medium), (0, small)):
        tier = torch.where(mask, code, tier)
    n_small, n_med, n_lrg, n_big = (m.sum().to(I32) for m in (small, medium, large, big))

    # One sort by (tier, submission index) compacts every tier into a
    # contiguous prefix in ascending id order.
    key1 = tier.long() * T + torch.arange(T, device=dev)
    key1_s, perm = torch.sort(key1)
    tier_sorted = (key1_s // T).to(I32)
    idx_sorted = (key1_s % T).to(I32)
    w_s, h_s, ty0_s, tx0_s = w[perm], h[perm], ty0[perm], tx0[perm]

    def tier_slice(start, L):
        """The L-slot budget window of one tier starting at sorted row
        `start` (clamped to T - L); the tier code masks rows of other tiers."""
        rows = torch.clamp(start, 0, T - L) + torch.arange(L, device=dev)
        return (idx_sorted[rows], w_s[rows], h_s[rows], ty0_s[rows], tx0_s[rows],
                tier_sorted[rows])

    def expand_rect(start, L, Ek, code):
        ids, w_, h_, ty0_, tx0_, ts = tier_slice(start, L)
        e = torch.arange(Ek, dtype=I32, device=dev)
        dy = e[None, :] // w_[:, None]
        dx = e[None, :] % w_[:, None]
        tile = (ty0_[:, None] + dy) * ntx + (tx0_[:, None] + dx)
        ok = (ts == code)[:, None] & (e[None, :] < (w_ * h_)[:, None])
        tile = torch.where(ok, tile, NT)
        return tile.reshape(-1), ids[:, None].expand(L, Ek).reshape(-1)

    zero = torch.zeros((), dtype=I32, device=dev)
    parts = [
        expand_rect(zero, LS, E, 0),
        expand_rect(n_small, MB, EM, 1),
        expand_rect(n_small + n_med, ML, EL, 2),
    ]
    if has_big:
        bids, bw, bh, bty0, btx0, bts = tier_slice(n_small + n_med + n_lrg, B)
        tyi = torch.arange(nty, dtype=I32, device=dev)[None, :, None]
        txi = torch.arange(ntx, dtype=I32, device=dev)[None, None, :]
        ov = (
            (tyi >= bty0[:, None, None])
            & (tyi <= (bty0 + bh - 1)[:, None, None])
            & (txi >= btx0[:, None, None])
            & (txi <= (btx0 + bw - 1)[:, None, None])
            & (bts == 3)[:, None, None]
        )
        parts.append((
            torch.where(ov, tyi * ntx + txi, NT).reshape(-1),
            bids[:, None].expand(B, NT).reshape(-1),
        ))
    tiles = torch.cat([p[0] for p in parts])
    tris = torch.cat([p[1] for p in parts])
    P = tiles.shape[0]

    # (tile, tri) pairs are unique: sorting tile * T2 + tri is pair order,
    # and sentinel pairs (tile NT) sort past every tile.
    T2 = 1 << max(T - 1, 1).bit_length()
    keys_sorted = torch.sort(tiles.long() * T2 + tris.long()).values
    tris_sorted = keys_sorted % T2
    edges = torch.arange(NT + 1, dtype=torch.int64, device=dev) * T2
    bounds = torch.searchsorted(keys_sorted, edges).to(I32)
    true_counts = bounds[1:] - bounds[:-1]
    counts = torch.clamp(true_counts, max=K)
    overflow = (
        (true_counts > K).sum()
        + torch.clamp(n_small - LS, min=0)
        + torch.clamp(n_med - MB, min=0)
        + torch.clamp(n_lrg - ML, min=0)
        + (torch.clamp(n_big - B, min=0) if has_big else 0)
    ).to(I32)

    # The sorted pair prefix IS the stream: row i holds sorted pair i's
    # record; one row gather builds it.
    cap = min(cfg.bin_stream_cap * area_scale, P)
    offs = torch.clamp(bounds, max=cap)
    scounts = torch.minimum(counts, offs[1:] - offs[:-1])
    overflow = overflow + (bounds[NT] > cap).to(I32)
    return BinnedTriangles(
        counts=scounts, overflow=overflow, stream=packed[tris_sorted[:cap]], offs=offs,
    )
