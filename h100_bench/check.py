"""What decides `correct`: the frames the window presented against the
plain reference, and the window's own exact readings.

Compared, each against its limit:

- ``overflowed_frames``: frames of the window (and of a traced run's
  spans window) whose overflow count was above 0 (a capacity cap
  dropped a triangle or a light; the reference drops nothing): limit 0;
- ``overflow_unlogged``: frames of the window whose overflow count the
  log never saw (drive.py reads the counts through a hook on the frame
  module; a hook that misses frames would let overflows pass): limit 0;
- ``clock_off``: 1 when the program's animation clock after its last frame
  is not the clock the frame count gives (a step that left its state
  unchanged, or stepped twice): limit 0;
- ``frames_missing``: sampled frames that never reached the host: limit 0;
- over the sampled frames (check_frames of the window, drawn from the
  seed), against the reference's frame at the same clock, the worst of:
  ``px_over_1lsb_pct`` (pixels whose largest channel differs by more than
  1 of 255, in percent), ``mean_abs_u8`` (the mean over pixels of the
  largest channel difference) and ``max_abs_u8``; limits in
  limits/<cell>.json, set from the program's and the control's readings
  (PERF.md gives them).
"""
from __future__ import annotations

import json
import os

import torch

from . import scenegen
from .reference import render

EXACT = ("overflowed_frames", "overflow_unlogged", "clock_off", "frames_missing")
FRAME_NUMBERS = ("px_over_1lsb_pct", "mean_abs_u8", "max_abs_u8")


def load_limits(bench_dir: str, cell: str) -> dict:
    with open(os.path.join(bench_dir, "limits", f"{cell}.json")) as fh:
        limits = json.load(fh)
    return {**{k: 0 for k in EXACT}, **{k: limits[k] for k in FRAME_NUMBERS}}


def frame_numbers(got, want) -> dict:
    """px_over_1lsb_pct, mean_abs_u8 and max_abs_u8 of uint8 [H, W, 3] got
    against want."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs().amax(-1)
    return {"px_over_1lsb_pct": 100.0 * float((d > 1).double().mean()),
            "mean_abs_u8": float(d.double().mean()), "max_abs_u8": int(d.max())}


def _worst(pairs) -> dict:
    """The largest of each frame number over (got, want) frame pairs."""
    worst = {k: 0 for k in FRAME_NUMBERS}
    for got, want in pairs:
        for k, v in frame_numbers(got, want).items():
            worst[k] = max(worst[k], v)
    return worst


def _reference(reading, device):
    """(the run's sampled clocks, render(clock, dtype) of the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clocks = reading.clocks(s for s, _ in reading.run["samples"])
    scene = render.device_scene(reading.arrays, device)
    cfg = render.renderer_config(reading.config["renderer"])
    return clocks, lambda clock, dtype=torch.float32: render.render_frame(scene, cfg, clock, dtype)


def frames_against_reference(reading, device) -> tuple:
    """(worst frame numbers over the run's sampled frames, frames compared):
    each sampled frame against the reference at its clock."""
    clocks, ref = _reference(reading, device)
    frames = [f for _, f in reading.run["samples"]]
    return _worst((torch.as_tensor(f).to(device), ref(c)) for c, f in zip(clocks, frames)), len(frames)


def control_numbers(reading, device, dtype=torch.bfloat16) -> dict:
    """The control's frame numbers: the reference with its lighting in
    `dtype` put in the program's place, at the run's sampled clocks."""
    clocks, ref = _reference(reading, device)
    return _worst((ref(c, dtype), ref(c)) for c in clocks)


def numbers(reading, device) -> dict:
    """Every compared number of the run."""
    run = reading.run
    want_clock = float(scenegen.advance_clock(reading.arrays["time"], reading.yaw, run["steps"])[-1])
    frames, n = frames_against_reference(reading, device)
    return {"overflowed_frames": run["failed"] + run.get("span_failed", 0), "overflow_unlogged": run["unlogged"] + run.get("span_unlogged", 0),
            "clock_off": int(run["clock_end"] != want_clock),
            "frames_missing": run["sampled"] - n, **frames}


def judged(values: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]})."""
    out = {k: [values[k], limits[k]] for k in values}
    return all(v <= lim for v, lim in out.values()), out
