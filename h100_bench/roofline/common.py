"""What the kernels' rooflines share: the bound of a count of bytes and
operations, and the raster work of a binned record stream.

Operations are counted from the kernels' sources: a multiply or an add is
1, a fused multiply-add 2, a divide, square root or pow 1.  Bytes count
each input read once and each output written once."""
from __future__ import annotations

import importlib

import torch

from .peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

RASTER_OPS_PER_RECORD_PIXEL = 26  # the three edge tests of a record at a pixel
RECORD_BYTES = 128                 # one 32-float triangle record


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def raster_box_pixels(counts, offs, stream, ntx: int, tile_h: int, tile_w: int) -> int:
    """The raster work a binned record stream needs: over every (tile,
    record) pair, the pixel centres inside both the record's box (its
    vertices' least and greatest x and y) and the tile, for records
    flagged valid."""
    n = counts.long()
    tiles = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rows = offs[:-1].long()[tiles] + (torch.arange(tiles.numel(), device=n.device) - first)
    rec = stream[rows]
    x, y = rec[:, 0:6:2], rec[:, 1:6:2]
    counted = []
    for lo, hi, t0, size in ((x.amin(1), x.amax(1), (tiles % ntx) * tile_w, tile_w),
                             (y.amin(1), y.amax(1), (tiles // ntx) * tile_h, tile_h)):
        c0 = torch.maximum(torch.ceil(lo - 0.5), t0.float())
        c1 = torch.minimum(torch.floor(hi - 0.5), (t0 + size - 1).float())
        counted.append(torch.nan_to_num(torch.clamp(c1 - c0 + 1.0, min=0.0), nan=0.0).double())
    return int((counted[0] * counted[1] * (rec[:, 28] > 0.0)).sum())


def share(r, kernel: str, frames: int = 4):
    """100 x (mean bound of `frames` profiled frames) / (the kernel's
    profiled device seconds a frame); None where the profile holds none of
    the kernel's time or the configuration runs no such kernel."""
    mod = importlib.import_module(f"{__package__}.{kernel}")
    prof = r.run.get("profile")
    if not prof:
        return None
    dev_s = sum(s for name, s in prof["ops"].items() if any(k in name for k in mod.KERNELS))
    if dev_s <= 0:
        return None
    counts = [mod.work(f) for f in r.profiled_frames(frames)]
    counts = [c for c in counts if c is not None]
    if not counts:
        return None
    bound = sum(bound_s(b, o) for b, o in counts) / len(counts)
    return 100.0 * bound / (dev_s / prof["frames"])
