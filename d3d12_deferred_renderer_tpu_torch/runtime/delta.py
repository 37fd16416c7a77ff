"""Delta presentation: transfer only the CHANGED tiles of each frame to the host.

The counterpart of d3d12_deferred_renderer_tpu/runtime/delta.py (its
docstrings give the measurements behind the design).  The reference
presents with plain `Present(1, 0)` (main.cpp:337); its flip-model swapchain
family exists to let the present path skip unchanged content (DXGI
`Present1` dirty rects).  Here the frame is cut into tiles on the device,
the tiles that differ from the previous presented frame are compacted to
the front of one buffer, and the host reconstructs the frame from its own
copy of the previous one, so static pixels never cross the link again.

The wire format is JAX's, byte for byte: in pixel mode

  [4B count][4B npx][cap*4B dirty order][cap*ceil(P/8)B pixel bitmaps]
  [px_cap*C B changed pixels]

(bitmaps little-bit-order, changed pixels in ascending flat (dirty-tile
rank, pixel) order), in raw mode [4B count][cap*4B dirty order]
[cap*tile_bytes dirty tiles]; the speculative tile and pixel caps, their
quarter-pow2 buckets and the shrink hysteresis are JAX's, so the bytes and
counters equal JAX's for the same frames.  Two faults of the JAX version
are not carried over: the queue has a close() that shuts its worker down,
and both miss paths re-transfer a bucket of `_pow2_at_least` rows (JAX's
pixel-miss path takes 2 rows where one tile missed, so the port moves
one tile's bytes less on those presents).

`push` packs on the frame's device and starts the buffer's copy into
pinned host memory at once, with an event after it (as runtime/present.py
does); one worker thread waits on that event and decodes, FIFO, so the host
mirror chains.  Reconstruction is bit-identical to a full readback: a tile
is transferred iff any byte differs, so the mirror never drifts.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .present import start_host_copy


def _bucket(x: int) -> int:
    """Smallest quarter-pow2 step >= x (... 8, 10, 12, 14, 16, 20, 24, 28,
    32 ...): at most 25% overshoot of the speculative prefix."""
    if x <= 8:
        return max(1, x)
    p = 1 << (x.bit_length() - 1)  # pow2 floor
    q = p // 4
    return p + q * (-(-(x - p) // q))


def _pow2_at_least(n: int) -> int:
    """Rows of a miss re-transfer: the smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _pick_tile(size: int, preferred: int) -> int:
    """Largest divisor of `size` that is <= preferred (>= 1)."""
    t = min(preferred, size)
    while size % t:
        t -= 1
    return t


def _tile_layout(frame: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[H, W, C] -> [NT, tile_bytes] tile layout (one u8 relayout)."""
    H, W, C = frame.shape
    TH, TW = H // th, W // tw
    return frame.reshape(TH, th, TW, tw, C).permute(0, 2, 1, 3, 4).reshape(TH * TW, th * tw * C)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Indices with mask set first, each group ascending (a stable argsort
    of ~mask)."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def _i32_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).reshape(-1).view(torch.uint8)


def _pack(t_prev, t_new, channels: int, cap: int, px_cap: int):
    """(buffer, order): the single-transfer buffer of one present, in pixel
    mode when px_cap > 0, and the dirty-tile order [NT] (dirty tiles
    first, ascending)."""
    NT, B = t_new.shape
    changed_px = (t_new.reshape(NT, -1, channels) != t_prev.reshape(NT, -1, channels)).any(dim=2)
    changed = changed_px.any(dim=1)
    count = changed.sum(dtype=torch.int32)
    order = _first_true(changed)
    ranked = order[:cap]
    if not px_cap:
        return torch.cat([_i32_bytes(count), _i32_bytes(ranked), t_new[ranked].reshape(-1)]), order
    P = B // channels
    Pp = -(-P // 8) * 8
    mp = torch.nn.functional.pad(changed_px, (0, Pp - P)).reshape(NT, Pp // 8, 8).to(torch.uint8)
    bitmap = (mp << torch.arange(8, dtype=torch.uint8, device=mp.device)).sum(dim=-1, dtype=torch.uint8)
    npx = changed_px.sum(dim=1, dtype=torch.int32)[ranked].sum(dtype=torch.int32)
    px = t_new.reshape(NT * P, channels)[_first_true(changed_px.reshape(-1))[:px_cap]]
    hdr = _i32_bytes(torch.stack([count, npx]))
    return torch.cat([hdr, _i32_bytes(ranked), bitmap[ranked].reshape(-1), px.reshape(-1)]), order


class DeltaPresentQueue:
    """Bounded queue of in-flight frames presented through dirty-tile deltas.

    Same contract as `PresentQueue` (push returns the oldest presented frame
    once `depth` frames are in flight; present_next / drain download in
    order), but each present moves only the speculative prefix of changed
    tiles or pixels.  `bytes_transferred` / `bytes_full` expose the savings.
    With threaded=False there is no worker: present_next waits for the
    buffer and decodes on the caller's thread (the same frames and
    counters).  close() (or the context manager) shuts the decode worker
    down."""

    _SHRINK_RUN = 16

    def __init__(
        self, height: int, width: int, depth: int = 3,
        tile_h: int = 8, tile_w: int = 64, channels: int = 3, pixel_level: bool = True,
        threaded: bool = True,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        # ONE worker so presents stay FIFO (the host mirror chains).
        self._pool = ThreadPoolExecutor(max_workers=1) if threaded else None
        self._closed = False
        self.depth = depth
        self.th = _pick_tile(height, tile_h)
        self.tw = _pick_tile(width, tile_w)
        self.H, self.W, self.C = height, width, channels
        self.TH, self.TW = height // self.th, width // self.tw
        self.NT = self.TH * self.TW
        self.tile_bytes = self.th * self.tw * channels
        self.tile_px = self.th * self.tw
        self._bmp_bytes = -(-self.tile_px // 8)  # per-tile bitmap bytes
        self.pixel_level = pixel_level
        self._queue: deque = deque()
        # The previous frame's tile layout on its device (made at the first
        # push, on that frame's device) feeds the next pack; the host
        # mirror reconstructs.
        self._prev_tiles: Optional[torch.Tensor] = None
        self._host = np.zeros((self.NT, self.tile_bytes), np.uint8)
        self.frames_presented = 0
        self.bytes_transferred = 0
        self.bytes_full = 0
        # Speculative caps (tiles, changed pixels): grow at once, shrink only
        # after _SHRINK_RUN presents at <= half the current bucket; a frame
        # over a cap costs one extra transfer (transfer_misses), never a
        # wrong frame.
        self._spec = self.NT
        self._spec_px = self.NT * self.tile_px
        self.transfer_misses = 0
        self._low = 0
        self._low_px = 0
        # Whether a pixel-mode present has observed a real changed-pixel
        # count yet (the one-time seeding, then a slow decay).
        self._px_informed = False

    def _sticky(self, cur: int, want: int, low: int, limit: int):
        """(new_cap, new_low): grow now, shrink only after a sustained run of
        observations at <= half the current bucket."""
        if want > cur:
            return min(want, limit), 0
        if want * 2 <= cur:
            low += 1
            if low >= self._SHRINK_RUN:
                return want, 0
            return cur, low
        return cur, 0

    def _px_mode(self, cap: int, px_cap: int) -> bool:
        """The pixel-level buffer iff it undercuts the raw dirty-tile buffer
        and the observed changed-pixel estimate fits its payload."""
        if not self.pixel_level or cap == 0:
            return False
        raw = cap * self.tile_bytes
        px = cap * self._bmp_bytes + px_cap * self.C + 4
        return px < raw and self._spec_px <= px_cap

    def push(self, device_frame: torch.Tensor) -> Optional[np.ndarray]:
        """Submit a rendered frame [H, W, C] uint8 and start its buffer's
        copy to the host; returns the OLDEST frame (a host uint8 [H, W, C]
        array) when the queue is full, else None."""
        if self._prev_tiles is None:
            self._prev_tiles = torch.zeros((self.NT, self.tile_bytes), dtype=torch.uint8,
                                           device=device_frame.device)
        cap = self._spec
        # The pixel payload is sized at quarter pixel density, a function of
        # the tile cap alone; the observed estimate only gates the mode.
        px_cap = max(1, cap * self.tile_px // 4)
        if not self._px_mode(cap, px_cap):
            px_cap = 0
        t_new = _tile_layout(device_frame, self.th, self.tw)
        buf, order = _pack(self._prev_tiles, t_new, self.C, cap, px_cap)
        self._prev_tiles = t_new
        job = (cap, px_cap, start_host_copy(buf), order, t_new)
        if self._pool is None:
            if self._closed:
                raise RuntimeError("push after close()")
            self._queue.append(job)
        else:
            self._queue.append(self._pool.submit(self._present_job, job))
        if len(self._queue) > self.depth:
            return self.present_next()
        return None

    def present_next(self) -> Optional[np.ndarray]:
        if not self._queue:
            return None
        item = self._queue.popleft()
        return self._consume(item.result() if self._pool is not None else self._present_job(item))

    def _present_job(self, job):
        """Wait for ONE present's buffer and decode it into the host mirror;
        returns the frame and the observations _consume applies.  Mutates
        only self._host (jobs run FIFO)."""
        cap, px_cap, (host, done), order, t_new = job
        if done is not None:
            done.synchronize()
        buf = host.numpy()
        nbytes = buf.nbytes
        misses = 0
        c = int(buf[:4].view(np.int32)[0])
        take = min(c, cap)
        npx = None  # observed changed-pixel count (pixel mode only)
        if px_cap:
            npx = int(buf[4:8].view(np.int32)[0])
            off = 8
            idx = buf[off: off + 4 * cap].view(np.int32)[:take]
            off += 4 * cap
            bmp = buf[off: off + cap * self._bmp_bytes].reshape(cap, self._bmp_bytes)[:take]
            off += cap * self._bmp_bytes
            px = buf[off:].reshape(px_cap, self.C)
            if take:
                bits = np.unpackbits(bmp, axis=1, bitorder="little")[:, : self.tile_px]
                pos = np.flatnonzero(bits)  # ascending == device pixel order
                tiles_buf = self._host[idx]  # previous content, by the invariant
                flat_px = tiles_buf.reshape(take * self.tile_px, self.C)
                nv = min(npx, px_cap)
                flat_px[pos[:nv]] = px[:nv]
                if npx > px_cap:
                    # Pixel miss: the missing pixels are the tail of the
                    # ascending order, in the last rows of the dirty prefix.
                    misses += 1
                    first_bad = int(pos[px_cap]) // self.tile_px
                    k = _pow2_at_least(take)
                    tiles_buf[first_bad:take] = t_new[order[:k]].cpu().numpy()[first_bad:take]
                    nbytes += k * self.tile_bytes
                self._host[idx] = tiles_buf
        elif take:
            idx = buf[4: 4 + 4 * cap].view(np.int32)[:take]
            self._host[idx] = buf[4 + 4 * cap:].reshape(cap, self.tile_bytes)[:take]
        if c > cap:
            # Tile miss: one extra transfer for the remainder.
            misses += 1
            k = _pow2_at_least(c)
            self._host[order[cap:c].cpu().numpy()] = t_new[order[:k]].cpu().numpy()[cap:c]
            nbytes += k * self.tile_bytes + self.NT * 4
            npx = None  # pixel count unseen past the cap: no decay of _spec_px
        # Snapshot into a fresh buffer: later jobs keep mutating the mirror.
        frame = np.empty((self.H, self.W, self.C), np.uint8)
        frame.reshape(self.TH, self.th, self.TW, self.tw, self.C)[...] = (
            self._host.reshape(self.TH, self.TW, self.th, self.tw, self.C).transpose(0, 2, 1, 3, 4)
        )
        return frame, nbytes, misses, c, npx

    def _consume(self, res) -> np.ndarray:
        """Apply one present's observations (byte and miss counters, the
        speculative caps) on the caller's thread, in present order."""
        frame, nbytes, misses, c, npx = res
        self.bytes_transferred += nbytes
        self.transfer_misses += misses
        if c == 0:
            self._spec = 0
            self._low = 0
        else:
            want = min(self.NT, _bucket(int(c * 1.15) + 1))
            self._spec, self._low = self._sticky(self._spec, want, self._low, self.NT)
        if npx is not None:
            self._px_informed = True
            want_px = min(self.NT * self.tile_px, _bucket(int(npx * 1.15) + 1))
            self._spec_px, self._low_px = self._sticky(
                self._spec_px, want_px, self._low_px, self.NT * self.tile_px
            )
        elif c > 0:
            # Raw presents do not observe the pixel count: seed the estimate
            # at the quarter-density payload once, then only decay toward it.
            seed = max(1, self._spec * self.tile_px // 4)
            if not self._px_informed:
                self._spec_px = seed
            else:
                self._spec_px = max(seed, int(self._spec_px * 0.95))
        self.bytes_full += self.NT * self.tile_bytes
        self.frames_presented += 1
        return frame

    def drain(self):
        while self._queue:
            yield self.present_next()

    def close(self) -> None:
        """Shut the decode worker down (a later push raises RuntimeError):
        frames still in flight are dropped, and an exception raised by
        their decode is raised here.  Idempotent."""
        pending, self._queue = self._queue, deque()
        self._closed = True
        if self._pool is None:
            return
        self._pool.shutdown(wait=True, cancel_futures=True)
        for fut in pending:
            if not fut.cancelled():
                fut.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def in_flight(self) -> int:
        return len(self._queue)
