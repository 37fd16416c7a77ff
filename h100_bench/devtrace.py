"""The traced window: torch.profiler over a call, reduced to device time.

``profile(fn, device)`` runs fn() under the profiler (CPU and CUDA
activities) inside a ``bench.window`` range, with a synchronise at its end,
exports the trace to a temporary file, reads it back and returns:

- ``window_s``: the length of the ``bench.window`` range;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside it (overlapping kernels count once, so it never exceeds the
  window);
- ``ops``: device seconds by operation name (each interval whole);
- ``gaps``: the device's idle seconds inside the window by what the host
  was doing, each gap of at least GAP_NAMED_S named by the innermost host
  range covering its midpoint, the shorter ones pooled;
- ``device_ops`` / ``idle_gaps``: the ten largest of each, for the
  result line's breakdown.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_NAMED_S = 20e-6
SHORT_GAPS = "gaps under 20 us (between graph nodes and launches)"


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi) covered by no interval."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list; other operations' names as they are."""
    if not name.startswith("void "):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<{":
            depth += 1
        elif ch in ">}":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i]
    return name


def reduce_events(events: list) -> dict:
    """The profile's numbers from chrome-trace events (times in us)."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == "bench.window"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no bench.window range")
    lo = window[0]["ts"] * 1e-6
    hi = lo + window[0]["dur"] * 1e-6
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = e["ts"] * 1e-6, e["dur"] * 1e-6
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, s + d, e["name"]))
        elif e is not window[0] and e.get("cat") != "gpu_user_annotation":
            host.append((s, s + d, e["name"]))
    inside = [(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi]
    ops = {}
    for s, e, name in dev:
        if e > lo and s < hi:
            ops[name] = ops.get(name, 0.0) + (e - s)
    gaps = {}
    hs = np.array([h[0] for h in host]) if host else np.zeros(0)
    he = np.array([h[1] for h in host]) if host else np.zeros(0)
    for s, e in idle_gaps(inside, lo, hi):
        name = SHORT_GAPS
        if e - s >= GAP_NAMED_S:
            mid = 0.5 * (s + e)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = host[cover[np.argmin(he[cover] - hs[cover])]][2] if cover.size else "host outside any range"
        gaps[name] = gaps.get(name, 0.0) + (e - s)
    short = {}
    for name, sec in ops.items():
        short[short_name(name)] = short.get(short_name(name), 0.0) + sec
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": hi - lo, "busy_s": union_length(inside), "ops": ops, "gaps": gaps,
            "device_ops": top(short), "idle_gaps": top(gaps)}


def profile(fn, device: torch.device) -> dict:
    """fn() under the profiler -> reduce_events of its trace, plus the host
    seconds that reading the trace took (``read_s``)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with torch_profile(activities=acts) as prof:
        with record_function("bench.window"):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce_events(events)
    out["read_s"] = time.perf_counter() - t0
    return out
