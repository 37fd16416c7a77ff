"""The one traffic driver: it runs a cell's window as its mix file says.

A mix file (traffic/<mix>.json) names an ``entry`` and its parameters:

- ``present``: ``runtime.App.run`` presents every frame through its
  ``PresentQueue`` (frames_in_flight deep); one ``App.run`` call sized
  from the warm-up rate fills the window, so the window holds no drain but
  the last;
- ``batch``: ``frame.render_batch`` of ``batch`` frames a call, each batch
  pushed to one ``PresentQueue`` as it returns;
- ``bands``: ``parallel.render_sharded`` over ``ranks`` processes
  (``parallel.run_bands``, a card a rank), each animating its own copy of
  the state; rank 0 pushes each assembled frame to a ``PresentQueue``.

Every loop is closed and uncapped.  A frame arrives when the queue hands
it to the host (its copy into pinned memory has finished); its arrival is
stamped then, and a batch's frames share their stamp.  The overflow
count of every frame in the window is copied on the device as the frame
is made (OverflowLog: no host sync) and read once the window has closed.
The window's size comes from a rate probe after the warm-up, so nothing
is captured or built inside it.

With ``trace`` the window is run with host spans around the calls into
the program's layers (``step``: the frame program; ``present``: the
queue's push and the arrival; ``collective``: a rank program's
collectives), then ``trace_frames`` more frames under ``torch.profiler``
(devtrace.py).

Every entry returns plain numbers and host arrays: the window's start,
length, arrival stamps, attempted and failed frames, the sampled frames
with the animation steps that made them, the final clock, the memory peak
and, traced, the spans and the profile.
"""
from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from . import devtrace


class Spans:
    """Host seconds spent inside wrapped calls, by span name; under a
    profiler each call is also a ``bench.<name>`` range of the trace."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self.annotate = False

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            if self.annotate:
                with torch.profiler.record_function("bench." + name):
                    return self._time(name, fn, args, kwargs)
            return self._time(name, fn, args, kwargs)
        return timed

    def _time(self, name, fn, args, kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.total[name] += time.perf_counter() - t0


class OverflowLog:
    """Each frame's int32 overflow count, copied as the frame is made into
    a device buffer of the log's own (no host sync, no pinned memory held),
    read once the window has closed."""

    CHUNK = 4096

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.chunks, self.n = [], 0

    def record(self, count: torch.Tensor) -> None:
        k = self.n % self.CHUNK
        if k == 0:
            self.chunks.append(torch.empty((self.CHUNK,), dtype=count.dtype, device=count.device))
        self.chunks[-1][k:k + 1].copy_(count.reshape(1))
        self.n += 1

    def failed(self) -> int:
        """Frames whose count is above 0 (waits for the frames)."""
        if not self.n:
            return 0
        return int((torch.cat(self.chunks)[:self.n] > 0).sum())


def hook_frame_overflow(log: OverflowLog):
    """Log the overflow count of every frame that frame.step_frame_jit and
    render_batch make: each call of the frame module's overflow warning
    (after every replay) also records its count.  Returns the undo."""
    from d3d12_deferred_renderer_tpu_torch import frame as tf

    original = tf._warn_overflow

    def logged(overflow):
        original(overflow)
        log.record(overflow)

    tf._warn_overflow = logged

    def undo():
        tf._warn_overflow = original
    return undo


class Arrivals:
    """Arrival stamps of the window's frames and the sampled frames kept
    for the check (the host arrays the queue hands over: no copy)."""

    def __init__(self):
        self.open(set())

    def open(self, sample: set) -> None:
        self.stamps, self.sample, self.kept = [], sample, {}

    def arrive(self, frames, batched: bool = False) -> None:
        now = time.perf_counter()
        for f in (frames if batched else (frames,)):
            j = len(self.stamps)
            self.stamps.append(now)
            if j in self.sample:
                self.kept[j] = f


def sample_indices(seed: int, n: int, k: int, unit: int = 1) -> set:
    """The frames of ceil(k / unit) calls of a window of n frames (unit
    frames a call), the calls drawn from the seed: every frame of a drawn
    call, so that a batch is checked whole."""
    rng = np.random.default_rng([abs(int(seed)), 1])
    calls = rng.choice(n // unit, size=min(-(-k // unit), n // unit), replace=False)
    return {int(c) * unit + j for c in calls for j in range(unit)}


def port_config(fields: dict):
    from d3d12_deferred_renderer_tpu_torch import RendererConfig

    return RendererConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Cell:
    """One entry's state across its windows.  render(n) renders n frames (a
    multiple of `unit`) and returns once every one has arrived."""

    def __init__(self, job: dict, unit: int = 1):
        self.job = job
        self.traffic = job["traffic"]
        self.dev = torch.device(job["device"])
        self.cfg = port_config(job["fields"])
        self.unit = unit
        self.log = OverflowLog()
        self.arrivals = Arrivals()
        self.spans = Spans()
        self.steps = 0  # animation steps taken so far

    def size(self, render, rounds=None) -> int:
        """Warm up (one render of warmup_frames), probe the rate (renders of
        warmup_frames for rate_probe_s, or `rounds` of them) and return the
        window's frames."""
        k = max(self.unit, self.traffic["warmup_frames"] // self.unit * self.unit)
        render(k)
        done, t0 = 0, time.perf_counter()
        while (done < rounds * k) if rounds else (time.perf_counter() - t0 < self.traffic["rate_probe_s"]):
            render(k)
            done += k
        rate = done / (time.perf_counter() - t0)
        return max(2, math.ceil(rate * self.job["seconds"] / self.unit)) * self.unit

    def window(self, render, n: int, sample_seed=None) -> dict:
        """render(n) timed, and what it left: arrival stamps, attempted
        frames (the animation steps taken), failed frames, the frames whose
        overflow count the log never saw (a hook that misses frames would
        leave overflows uncounted), the sampled frames with the animation
        step of each."""
        k = self.traffic["check_frames"]
        self.arrivals.open(sample_indices(sample_seed, n, k, self.unit) if sample_seed is not None else set())
        self.log.clear()
        first = self.steps
        _sync(self.dev)
        t0 = time.perf_counter()
        render(n)
        t1 = time.perf_counter()
        taken = self.steps - first
        return {"window_start": t0, "window_s": t1 - t0, "attempted": taken, "unlogged": taken - self.log.n,
                "failed": self.log.failed(), "frames": len(self.arrivals.stamps),
                "arrivals": list(self.arrivals.stamps), "sampled": len(self.arrivals.sample),
                "samples": [(first + j + 1, f) for j, f in sorted(self.arrivals.kept.items())]}

    def traced(self, render, n: int) -> dict:
        """A spans window of n frames, then trace_frames frames under the
        profiler -> the spans and the profile."""
        self.spans.total.clear()
        w = self.window(render, n)
        t = max(self.unit, self.traffic["trace_frames"] // self.unit * self.unit)
        self.spans.annotate = True
        first = self.steps
        try:
            prof = devtrace.profile(lambda: render(t), self.dev)
        finally:
            self.spans.annotate = False
        prof.update(frames=t, first_step=first)
        return {"spans": dict(self.spans.total), "span_frames": w["frames"], "span_attempted": w["attempted"],
                "span_failed": w["failed"], "span_unlogged": w["unlogged"], "profile": prof}

    def finish(self, out: dict, clock_end: float) -> dict:
        out.update(clock_end=clock_end, steps=self.steps,
                   memory_peak_bytes=torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0)
        return out


def _measure(cell: _Cell, render, install_spans) -> dict:
    """Size, run the window, and with trace the spans and profiled windows."""
    n = cell.size(render)
    out = cell.window(render, n, cell.job["seed"])
    if cell.job["trace"]:
        install_spans()
        out.update(cell.traced(render, n))
    return out


# ---------------------------------------------------------------------------
# The entries
# ---------------------------------------------------------------------------

def run_present(job: dict) -> dict:
    """App.run: render(n) is one App.run(n), which drains its queue last."""
    from d3d12_deferred_renderer_tpu_torch import convert
    from d3d12_deferred_renderer_tpu_torch.runtime import App
    from d3d12_deferred_renderer_tpu_torch.runtime import app as app_mod

    cell = _Cell(job)
    app = App(convert.scene_from_arrays(job["arrays"], cell.dev), cell.cfg,
              present_callback=lambda i, f: cell.arrivals.arrive(f))

    def render(n):
        app.run(n)
        cell.steps += n

    def install_spans():
        app_mod.step_frame_jit = cell.spans.wrap("step", original_step)
        app.queue.push = cell.spans.wrap("present", app.queue.push)
        app.present_callback = cell.spans.wrap("present", app.present_callback)

    original_step = app_mod.step_frame_jit
    undo = hook_frame_overflow(cell.log)
    try:
        out = _measure(cell, render, install_spans)
        clock_end = float(app.state.time)
    finally:
        app_mod.step_frame_jit = original_step
        undo()
        app.close()
    return cell.finish(out, clock_end)


def run_batch(job: dict) -> dict:
    """frame.render_batch of `batch` frames a call, each batch pushed to one
    PresentQueue as it returns; render(n) drains the queue last."""
    from d3d12_deferred_renderer_tpu_torch import convert, frame as tf
    from d3d12_deferred_renderer_tpu_torch.runtime import PresentQueue

    B = job["traffic"]["batch"]
    cell = _Cell(job, unit=B)
    queue = PresentQueue(depth=cell.cfg.frames_in_flight)
    held = {"state": convert.scene_from_arrays(job["arrays"], cell.dev), "render": tf.render_batch,
            "push": queue.push, "arrive": lambda frames: cell.arrivals.arrive(frames, batched=True)}

    def render(n):
        for _ in range(n // B):
            held["state"], frames = held["render"](held["state"], cell.cfg, B)
            cell.steps += B
            host = held["push"](frames)
            if host is not None:
                held["arrive"](host)
        while queue.in_flight:
            held["arrive"](queue.present_next())

    def install_spans():
        held["render"] = cell.spans.wrap("step", tf.render_batch)
        held["push"] = cell.spans.wrap("present", queue.push)
        held["arrive"] = cell.spans.wrap("present", held["arrive"])

    undo = hook_frame_overflow(cell.log)
    try:
        out = _measure(cell, render, install_spans)
        clock_end = float(held["state"].time)
    finally:
        undo()
        queue.close()
    return cell.finish(out, clock_end)


def run_bands(job: dict) -> dict:
    """parallel.render_sharded over `ranks` spawned ranks -> rank 0's record
    (its arrivals, samples and profile), with the memory peak of the
    fullest card, the failed and unlogged frames of any rank, each rank's
    busy seconds and the forbidden modules that any rank had loaded."""
    from d3d12_deferred_renderer_tpu_torch import parallel

    ranks = job["traffic"]["ranks"]
    outs = parallel.run_bands(ranks, band_rank, args=(job,), device=job["device"],
                              timeout_s=job["traffic"]["rank_timeout_s"])
    out = outs[0]
    out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    out["failed"] = max(o["failed"] for o in outs)
    out["unlogged"] = max(o["unlogged"] for o in outs)
    out["rank_forbidden"] = sorted({m for o in outs for m in o["rank_forbidden"]})
    if "profile" in out:
        out["profile"]["busy_s_ranks"] = [o["profile"]["busy_s"] for o in outs]
    return out


def band_rank(device, job: dict) -> dict:
    """One rank of the bands entry (run by parallel.run_bands in its own
    process): every rank animates its state and calls render_sharded; rank 0
    presents.  Rank 0 sizes the window and tells the others.  Once its
    windows have closed, each rank lists the forbidden modules it has loaded
    (run.forbidden_modules): the run's own check sees only its process."""
    import torch.distributed as dist

    from d3d12_deferred_renderer_tpu_torch import convert, scene
    from d3d12_deferred_renderer_tpu_torch.parallel import program, sharded

    from d3d12_deferred_renderer_tpu_torch.runtime import PresentQueue

    job = dict(job, device=str(device))
    cell = _Cell(job)
    rank = dist.get_rank()
    queue = PresentQueue(depth=cell.cfg.frames_in_flight) if rank == 0 else None
    held = {"state": convert.scene_from_arrays(job["arrays"], cell.dev), "render": sharded.render_sharded,
            "push": queue.push if queue else None, "arrive": cell.arrivals.arrive}

    def render(n):
        for _ in range(n):
            held["state"] = scene.animate(held["state"], cell.cfg.yaw_per_frame, cell.cfg)
            cell.steps += 1
            frame, stats = held["render"](held["state"], cell.cfg, return_stats=True)
            cell.log.record(stats["overflow"])
            if queue is not None:
                host = held["push"](frame)
                if host is not None:
                    held["arrive"](host)
        if queue is not None:
            while queue.in_flight:
                held["arrive"](queue.present_next())

    original_run = program.Collective.run

    def install_spans():
        held["render"] = cell.spans.wrap("step", sharded.render_sharded)
        if queue is not None:
            held["push"] = cell.spans.wrap("present", queue.push)
            held["arrive"] = cell.spans.wrap("present", cell.arrivals.arrive)
        spans = cell.spans

        def run(self, handles):
            return spans.wrap("collective", original_run)(self, handles)
        program.Collective.run = run

    try:
        # Every rank renders the same warm-up and probe frames, in lockstep
        # through the collectives; rank 0's rate sizes the window.
        n = torch.tensor([cell.size(render, job["traffic"]["probe_rounds"])], dtype=torch.int64,
                         device=cell.dev)
        dist.broadcast(n, 0)
        n = int(n.item())
        sharded.bytes_sent = 0
        out = cell.window(render, n, job["seed"] if rank == 0 else None)
        out["bytes_sent_per_frame"] = sharded.bytes_sent / n
        if job["trace"]:
            install_spans()
            out.update(cell.traced(render, n))
        clock_end = float(held["state"].time)
    finally:
        program.Collective.run = original_run
        if queue is not None:
            queue.close()
    if rank != 0:
        out["samples"], out["arrivals"] = [], []
    from h100_bench.run import forbidden_modules

    out["rank_forbidden"] = forbidden_modules()
    return cell.finish(out, clock_end)


ENTRIES = {"present": run_present, "batch": run_batch, "bands": run_bands}
