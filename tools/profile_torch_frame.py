"""Where a frame of the PyTorch port spends its time on the GPU.

    python3 tools/profile_torch_frame.py [--frames 10] [--out chiprun_out/profile]

For each main path of the port (config 1, the fused and the staged
flagship frame, and config 4 (shadows + bump + bloom, 1024^2 shadow map)
fused with the deferred-directional split and staged) it warms up, then runs `--frames` step_frame calls
under torch.profiler and prints one JSON line: ms per frame on the host
clock around the synchronised window, the device's busy share (the summed
time of the CUDA kernels and copies over the window), kernel launches,
host-to-device copies and stream synchronisations per frame, and the ten
kernels with the most device time.  The full key_averages tables go to
`--out`.  Then the card's name and power limit.  Needs a CUDA device; imports
no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _scenes(tp, dev):
    models = os.path.join(REPO, "assets", "models")
    geo1 = tp.build_scene_geometry([tp.load_obj(os.path.join(models, f"{m}.obj"))
                                    for m in ("cube", "pyramid")])
    yield "config1", tp.REFERENCE_CONFIG, tp.make_scene(geo1, tp.REFERENCE_CONFIG, device=dev)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=24))
    config4 = dict(shadows=True, normal_mapping=True, bloom=True, deferred_directional=True,
                   inkernel_light_cull=True, max_lights_per_tile=128, shadow_vis_downsample=1)
    for label, fused, extra in (("fused_flagship", True, {}), ("staged_flagship", False, {}),
                                ("config4_fused_split", True, config4), ("config4_staged", False, config4)):
        cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=fused, **extra)
        yield label, cfg, tp.make_scene(
            geo, cfg, lights=tp.random_point_lights(256, cfg=cfg, radius=1.2, device=dev),
            placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=dev), device=dev,
        )


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frame: needs a CUDA device", file=sys.stderr)
        return 2
    import d3d12_deferred_renderer_tpu_torch as tp

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    n = args.frames
    for label, cfg, state in _scenes(tp, dev):
        for _ in range(5):
            state, _ = tp.step_frame(state, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                state, frame = tp.step_frame(state, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = prof.key_averages()
        dev_events = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in dev_events) / 1e3
        count = {e.key: e.count for e in avgs}
        top = sorted(dev_events, key=_device_us, reverse=True)[:10]
        with open(os.path.join(args.out, f"{label}.txt"), "w") as fh:
            fh.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
        print(json.dumps({
            "path": label, "resolution": f"{cfg.width}x{cfg.height}", "frames": n,
            "ms_per_frame_host": wall_ms / n,
            "device_busy_ms_per_frame": busy_ms / n if busy_ms else None,
            "device_busy_share": busy_ms / wall_ms if busy_ms else None,
            "kernel_launches_per_frame": count.get("cudaLaunchKernel", 0) / n,
            "memcpy_per_frame": count.get("cudaMemcpyAsync", 0) / n,
            "stream_syncs_per_frame": count.get("cudaStreamSynchronize", 0) / n,
            "top_kernels_ms_per_frame": {e.key[:80]: _device_us(e) / 1e3 / n for e in top},
        }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
