"""App shell: the frame loop (the reference's main() while-loop, main.cpp:161-342).

The counterpart of d3d12_deferred_renderer_tpu/runtime/app.py.  Headless by
design: the 'window' is a PNG or frame-callback sink fed by the
triple-buffered PresentQueue.  `App.run(n)` replaces the reference's GLFW
loop: animate -> render (frame.step_frame_jit: on the card one CUDA graph
replay a frame, as JAX's loop calls its jitted step) -> present, with the
host ahead of the device by up to `frames_in_flight` frames.  Each frame
that step_frame_jit returns is a clone of the graph's output, so its copy to
the host, queued after the replay on the same stream, never races the next
replay.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

from ..config import RendererConfig
from ..frame import step_frame_jit
from ..scene import SceneState
from .delta import DeltaPresentQueue
from .present import PresentQueue


@dataclasses.dataclass
class FrameStats:
    frames: int = 0
    elapsed_s: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.elapsed_s if self.elapsed_s else 0.0


class App:
    """The frame loop.

    present_callback(frame_index, np.uint8[H, W, 3]) receives every presented
    frame (e.g. a PNG writer or encoder); None discards them after download.
    With delta_present the frames cross to the host as dirty-tile deltas
    (runtime/delta.py).  close() (or the context manager) releases the
    queue."""

    def __init__(
        self,
        state: SceneState,
        cfg: RendererConfig,
        present_callback: Optional[Callable] = None,
        delta_present: bool = False,
    ):
        self.state = state
        self.cfg = cfg
        self.present_callback = present_callback
        if delta_present:
            self.queue = DeltaPresentQueue(cfg.height, cfg.width, depth=cfg.frames_in_flight)
        else:
            self.queue = PresentQueue(depth=cfg.frames_in_flight)
        self.stats = FrameStats()

    def _present(self, host_frame):
        if host_frame is not None and self.present_callback is not None:
            self.present_callback(self.queue.frames_presented - 1, host_frame)

    def run(self, num_frames: int) -> FrameStats:
        """Render and present `num_frames` frames; every frame is presented
        before it returns.  Stats accumulate over runs."""
        t0 = time.perf_counter()
        for _ in range(num_frames):
            self.state, frame = step_frame_jit(self.state, self.cfg)
            self._present(self.queue.push(frame))
        for host in self.queue.drain():
            self._present(host)
        self.stats = FrameStats(
            frames=self.stats.frames + num_frames,
            elapsed_s=self.stats.elapsed_s + (time.perf_counter() - t0),
        )
        return self.stats

    def close(self) -> None:
        self.queue.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_frames_to_dir(out_dir: str):
    """A present_callback that writes frame_%05d.png into out_dir."""
    from ..utils.image import write_png

    os.makedirs(out_dir, exist_ok=True)

    def cb(i, frame):
        write_png(os.path.join(out_dir, f"frame_{i:05d}.png"), frame)

    return cb
