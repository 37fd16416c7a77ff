"""Per-pass timing and a trace hook.

The counterpart of d3d12_deferred_renderer_tpu/runtime/profiler.py.  The
reference ships no instrumentation (no timers, no FPS counter; SURVEY.md
section 5).  ``PassProfiler.time_pass`` times a block: by CUDA events where
the tensors it is given lie on the card, by the host clock otherwise.
``chrome_trace`` records a torch.profiler trace of a block (host and, where
there is a card, device activity) and writes it as a Chrome trace (view it
in chrome://tracing or Perfetto); JAX's ``xla_trace`` records an XLA trace.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


def _cuda_devices(tensors) -> set:
    return {t.device for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"}


class PassProfiler:
    """Accumulates time per named pass; `summary()` gives ms averages."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time_pass(self, name: str, *sync, inputs=()):
        """Times the enclosed block.  The tensors in `sync` and `inputs` name
        the device to time: where one lies on the card, the block is timed
        by CUDA events on the current stream, the end event waited for on
        exit, so asynchronous launches do not hide the block's device work.
        Each card holding an `inputs` tensor is synchronised before the
        timer starts, so earlier work is not billed to this pass.  Without
        a CUDA tensor the host clock times the block."""
        for dev in _cuda_devices(inputs):
            torch.cuda.synchronize(dev)
        devices = _cuda_devices((*sync, *inputs))
        if not devices:
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
        else:
            stream = torch.cuda.current_stream(next(iter(devices)))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            name: 1e3 * self.totals[name] / max(1, self.counts[name])
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def chrome_trace(path: str):
    """Record a torch.profiler trace of the enclosed block and write it to
    `path` as a Chrome trace (JSON), also when the block raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
