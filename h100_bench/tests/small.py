"""Small versions of the benchmark's cells for the CPU tests: the same
files, the frame cut to 256 x 128 and the scene to 6 meshes and 24 lights,
and the traffic to a few frames."""
from __future__ import annotations

import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
LIMITS = {"overflowed_frames": 0, "overflow_unlogged": 0, "clock_off": 0, "frames_missing": 0,
          "px_over_1lsb_pct": 0.5, "mean_abs_u8": 0.05, "max_abs_u8": 8}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(name: str) -> tuple:
    """(cell, small config, small traffic) of the benchmark's cell `name`."""
    b = bench()
    (c,) = [w for w in b["workloads"] if w["name"] == name]
    with open(os.path.join(BENCH_DIR, "configs", f"{c['config']}.json")) as fh:
        config = json.load(fh)
    config["renderer"].update(width=256, height=128, shadow_map_size=256)
    config["scene"].update(n_meshes=6, rings=8, segments=16, lights=24)
    with open(os.path.join(BENCH_DIR, "traffic", f"{c['traffic']}.json")) as fh:
        traffic = json.load(fh)
    traffic.update(warmup_frames=traffic.get("batch", 2), trace_frames=traffic.get("batch", 2))
    if "rate_probe_s" in traffic:
        traffic["rate_probe_s"] = 0.05
    if traffic["entry"] == "bands":
        traffic.update(ranks=2, probe_rounds=1, rank_timeout_s=300)
    return c, config, traffic
