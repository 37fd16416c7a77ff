"""K2, the fused tile renderer (ops/fused.render_fused -> csrc/fused.cu):
its device kernels and the bytes and operations one frame needs.

Bytes: the binned records once, the tile counts and offsets, the light,
material and uniform tables, the colour planes out (3, or 8 with the
deferred-directional split's auxiliary planes) and the tile overflow
counts.  Operations: the edge tests of each binned record over the pixels
of its box in its tile, the shading of each covered pixel (with the bump
where the configuration has it) and each live light of its tile at each
covered pixel, where a tile's live lights are those whose sphere touches
the world box of either of its two eye-distance slabs (the kernel's own
cull), capped at its slots.  Coverage and world positions come from the
reference's raster of the same frame."""
from __future__ import annotations

import torch

from .common import RASTER_OPS_PER_RECORD_PIXEL, RECORD_BYTES, raster_box_pixels

KERNELS = ("fused_tile_kernel",)
SHADE_OPS_PER_PIXEL = 130        # decode, ambient and directional GGX, tonemap
SHADE_OPS_PER_PIXEL_LIGHT = 120  # one point light's GGX at a pixel
BUMP_OPS_PER_PIXEL = 150         # world from depth and the bump


def live_lights(covered, world, eye, lights, n_tiles_y, n_tiles_x, tile_h, tile_w):
    """Live lights a tile [NT]: the slab cull over covered [H, W] and world
    [H, W, 3] (padded to whole tiles as background)."""
    H, W = covered.shape
    Hp, Wp = n_tiles_y * tile_h, n_tiles_x * tile_w

    def tiles(a, fill):
        a = torch.nn.functional.pad(a, (0, Wp - W, 0, Hp - H), value=fill)
        return a.reshape(n_tiles_y, tile_h, n_tiles_x, tile_w).transpose(1, 2).reshape(n_tiles_y * n_tiles_x, -1)

    cov = tiles(covered.float(), 0.0) > 0
    wt = [tiles(world[..., i], 0.0) for i in range(3)]
    d2 = sum((wt[i] - eye[i]) ** 2 for i in range(3))
    big = torch.full_like(d2, 3e38)
    dmin = torch.where(cov, d2, big).amin(1, keepdim=True)
    dmax = torch.where(cov, d2, -big).amax(1, keepdim=True)
    dmid = 0.5 * (dmin + dmax)
    pos, r2 = lights["lights.point_position"], lights["lights.point_radius"] ** 2
    live = torch.zeros((cov.shape[0], pos.shape[0]), dtype=torch.bool, device=cov.device)
    for m in (cov & (d2 <= dmid), cov & (d2 > dmid)):
        dist2 = 0.0
        for i in range(3):
            bn = torch.where(m, wt[i], big).amin(1, keepdim=True)
            bx = torch.where(m, wt[i], -big).amax(1, keepdim=True)
            dd = torch.clamp(torch.maximum(bn - pos[:, i][None], pos[:, i][None] - bx), min=0.0)
            dist2 = dist2 + dd * dd
        live |= dist2 <= r2[None, :]
    return live.sum(1), cov.sum(1)


def work(frame) -> tuple:
    """(bytes, operations) of K2 on `frame` (reading.FrameInputs)."""
    cfg = frame.cfg
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-cfg.height // TH), -(-cfg.width // TW)
    NT = nty * ntx
    b = frame.binned()
    pairs = int(b.counts.sum())
    box_px = raster_box_pixels(b.counts, b.offs, b.stream, ntx, TH, TW)
    frags, world = frame.reference()
    L = frame.scene["lights.point_position"].shape[0]
    M = frame.scene["materials.albedo"].shape[0]
    n_live, n_cov = live_lights(frags.depth < 1.0, world, frame.scene["camera.eye"], frame.scene, nty, ntx, TH, TW)
    slots = -(-min(cfg.max_live_lights_per_tile, L) // 16) * 16
    n_live = torch.clamp(n_live, max=slots)
    split = cfg.deferred_directional and cfg.shadows
    planes = 8 if split else 3
    n_bytes = (pairs * RECORD_BYTES + 4 * (2 * NT + 1) + 32 * max(L, 1) + 32 * max(M, 8) + 4 * 32
               + 4 * planes * nty * TH * ntx * TW + 4 * NT)
    cov = int(n_cov.sum())
    ops = (box_px * RASTER_OPS_PER_RECORD_PIXEL + cov * SHADE_OPS_PER_PIXEL
           + int((n_cov * n_live).sum()) * SHADE_OPS_PER_PIXEL_LIGHT
           + (cov * BUMP_OPS_PER_PIXEL if cfg.normal_mapping else 0))
    return n_bytes, ops
