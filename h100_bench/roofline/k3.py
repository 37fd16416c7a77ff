"""K3 on the shadow map, the depth-only tile raster (ops/shadows.
render_shadow_map -> raster_tiles.raster_depth -> csrc/raster.cu): its
device kernels (the depth plane's fill and the raster) and the bytes and
operations one frame's map needs.

Bytes: the map's binned records once, the tile counts and offsets, the
S x S depth plane written once.  Operations: the edge tests of each binned
record over the pixels of its box in its tile."""
from __future__ import annotations

from .common import RASTER_OPS_PER_RECORD_PIXEL, RECORD_BYTES, raster_box_pixels

KERNELS = ("raster_depth_kernel", "fill_kernel<unsigned int>")


def work(frame) -> tuple:
    """(bytes, operations) of K3's shadow map on `frame` (reading.FrameInputs)."""
    if not frame.cfg.shadows:
        return None
    b, scfg = frame.shadow_binned()
    S = frame.cfg.shadow_map_size
    nty, ntx = S // scfg.tile_h, S // scfg.tile_w
    pairs = int(b.counts.sum())
    box_px = raster_box_pixels(b.counts, b.offs, b.stream, ntx, scfg.tile_h, scfg.tile_w)
    return pairs * RECORD_BYTES + 4 * (2 * nty * ntx + 1) + 4 * S * S, box_px * RASTER_OPS_PER_RECORD_PIXEL
