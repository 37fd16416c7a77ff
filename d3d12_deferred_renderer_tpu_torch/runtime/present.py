"""Presentation: triple-buffered asynchronous device-to-host readback.

The counterpart of d3d12_deferred_renderer_tpu/runtime/present.py.  The
reference's swapchain and fences (3 backbuffers, a fence value a buffer, the
CPU blocking only when more than 3 frames are in flight; main.cpp:84,
108-111, 167-171, 337-341) map onto a bounded queue of frames whose copy to
the host has started but may not have finished.

PyTorch runs a stream's work in order, so a copy started when a frame is
popped would queue behind every later frame on the stream, and waiting for
it would wait for the newest frame: nothing would stay in flight.  So
``push`` starts the frame's copy at once (non-blocking, into pinned host
memory from PyTorch's caching host allocator, on the current stream) and
records an event after it; ``present_next`` waits on that frame's event
only.  The pinned buffer belongs to the returned numpy array, so no later
push overwrites it.  A CPU frame is copied and presented at once.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch


def start_host_copy(frame: torch.Tensor):
    """(host tensor, event or None): a CUDA tensor's non-blocking copy into
    fresh pinned memory and the event recorded after it on the current
    stream; a CPU tensor's copy, done at once."""
    if frame.device.type != "cuda":
        return frame.detach().clone(), None
    host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
    host.copy_(frame, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(frame.device))
    return host, done


class PresentQueue:
    """Bounded queue of in-flight frames (default depth 3 = triple buffer)."""

    def __init__(self, depth: int = 3):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = depth
        self._queue: deque = deque()
        self.frames_presented = 0

    def push(self, device_frame: torch.Tensor) -> Optional[np.ndarray]:
        """Submit a rendered frame and start its copy to the host.  If the
        queue is full, the OLDEST frame is presented (waiting for that
        frame's copy only) and returned: the analog of the fence wait at
        main.cpp:167-171."""
        self._queue.append(start_host_copy(device_frame))
        if len(self._queue) > self.depth:
            return self.present_next()
        return None

    def present_next(self) -> Optional[np.ndarray]:
        """Present (download) the oldest in-flight frame; None if empty."""
        if not self._queue:
            return None
        host, done = self._queue.popleft()
        if done is not None:
            done.synchronize()  # blocks iff this frame's copy has not finished
        self.frames_presented += 1
        return host.numpy()

    def drain(self):
        """Present every remaining in-flight frame (teardown)."""
        while self._queue:
            yield self.present_next()

    def close(self) -> None:
        """Drop the frames still in flight (their pinned buffers return to
        the allocator once their copies finish)."""
        self._queue.clear()

    @property
    def in_flight(self) -> int:
        return len(self._queue)
