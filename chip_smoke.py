"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile the hand-written kernels (csrc/*.cu) with nvcc, one
             process per source, all started together.
2. k1      — the setup kernel against its plain PyTorch version on the
             flagship scene (23,906 triangles, 1920x1080) and on 600
             instances of a cube (600 meshes): records, boxes and valid
             flags bit-equal (int32 views); ptxas's registers and stack
             frame, the block size and grid, ms and device ms.
3. k2      — the fused tile kernel against its plain version on the same
             binned input, at 256x64 and 1920x1080: equal per-tile overflow,
             max |du8| <= 1, fewer than 1% of pixels different; records
             and live lights per tile, ms back to back and replayed from a
             CUDA graph (device_ms), the bound from the pixels inside each
             binned record's box.
4. k6      — the tile raster kernel against its plain version on the same
             binned input at 256x64, 1280x720 (config 1) and 1920x1080
             (flagship scene): all 8 planes bit-equal as int32 (the depth's
             sign of zero too), also at 16 records a work item, equal
             overflow; timed as k2, and at 16, 32, 64 and 128 records a
             work item.
5. k7      — the G-buffer lighting kernel against its plain version on the
             flagship G-buffer (256 lights), without and with a visibility
             plane: HDR bit-equal, the frame after tonemap + gamma within
             1 u8 on < 1% of pixels; device ms, also with the light-heaviest
             tile's count set to 0 and with no point light.
6. k4      — the depth-only setup kernel against its plain version in the
             light's view of the flagship scene and of the 600-mesh scene,
             cull none: records, boxes and valid flags bit-equal; reported
             as k1.
7. k3      — the depth-only raster kernel: the 1024^2 shadow map on 16 x 128
             tiles equal (torch.equal) to its plain version at 64, 128 and
             256 records a work item, and on the display grid equal to the
             tile raster kernel's depth plane; timed as k2 on both grids.
8. k8      — the bump kernel against its plain version on the flagship
             frame's raster planes (K6's output, updated in place): every
             plane bit-equal as int32; the exhaustive check of the kernels'
             float32 rsqrt against the plain versions' float64 one over
             all 2^31 non-negative bit patterns (0 mismatches); ptxas's
             registers and stack frame; ms, device ms, the bound.
9. k2v     — the fused tile kernel's config-4 variant (bump, linear HDR, the
             split's aux planes) at 1920x1080: depth and mesh-id planes
             bit-equal to the tile raster kernel's on the same binned input,
             the depth, normal and mesh-id planes bit-equal to the plain
             version's, the frame within 1 u8 LSB of the plain version on
             < 1% of pixels.
10. k5     — the directional resolve kernel against its plain version on
             the k2v planes and the frame's PCF visibility: HDR within rtol
             2e-4, atol 2e-5.
11. main   — the fused flagship frame through the entry points (animate +
             render_stats, step_frame): a 64-step sweep of the whole yaw
             orbit with overflow 0, launch counts equal to the frames
             rendered, a frame that is not blank and agrees with the plain
             chain, at most 3 synchronising calls a frame (profiled), and
             ms/frame from CUDA events over 3 x 30 frames.
12. staged — one line for config 1 (the reference's frame: Lambert, cube +
             pyramid, 1280x720) and one for the staged flagship (fused=False,
             1920x1080, 256 lights): the same sweep, launch counts and timing
             through tp.step_frame / tp.render_stats; overflow 0 for config
             1, equal to the plain chain's at every 4th step for the flagship.
13. config4 — one line for each config-4 path (shadows + bump + bloom on the
             flagship scene, 1024^2 shadow map): the fused frame with the
             deferred-directional split and the staged frame (fused=False):
             the same sweep (overflow 0; staged: equal to the plain chain's
             at every 4th step), launches, the last frame against its plain
             chain and the timing.
14. parity — bench.py's two 256x64 parity blocks ("pbr" and "config4"),
             the fused frame against the staged frame through the kernels:
             mean |du8| <= 1 and at most 2% of pixels more than 4 LSB off.
15. k2l    — the fused tile kernel fed by per-tile light lists (the depth
             prepass: the depth-only raster kernel on the frame's binned
             records, then the light cull) at 1920x1080 on the flagship
             scene: without a visibility plane, with the unsplit config-4
             PCF plane, with that plane, bump and linear HDR, and with bump
             and the split's aux planes; against the plain version (max
             |du8| <= 1 on < 1% of pixels, zero tile overflow), the prepass
             depth and the aux depth and mesh-id planes bit-equal to the
             tile raster kernel's; each variant's ms beside the in-kernel
             cull's on the same frame.
16. prepass — one line for each fused frame with the depth prepass through
             the entry points: the flagship without the in-kernel cull, and
             config 4 without the split or the in-kernel cull (the
             visibility plane): the sweep (overflow 0), launches (the depth
             raster once a frame for the prepass and once for the shadow
             map), the last frame against its plain chain, the timing.
17. calibrate — autotune_shadow on the split config 4 and autotune on the
             colonnade scene (the fused flagship config), as
             tools/bench_configs.py runs them: the derived tiers or budgets
             and their sort keys, then the calibrated config's 16-step
             sweep (overflow 0), launches and timing; the calibrated shadow map
             equal to the default tiers', the colonnade frame against its
             plain chain.
18. k9     — the row scatter kernel against its plain version (bit-equal) at
             n = 4096, 8192 (the TPU tool's sizes) and the flagship binning's
             sort-key count: ms, ns/row, the plain version's and one
             index_copy_'s ms, the bound, and torch.sort's ns/key at the
             same count.

19. app    — the application path on the fused flagship, modelled on
             tools/present_run.py: App with PresentQueue (depth 3) over 30
             frames (step_frame_jit's graph replays), every presented frame
             bit-equal to a separate step_frame loop's from the same state
             (delivered FPS beside the same loop of eager step_frame calls
             into a PresentQueue, the loop's unpresented ms/frame, a loop
             that reads every frame back synchronously, and the
             device-to-host ms of one frame into pinned memory); the same
             through DeltaPresentQueue (bytes transferred over a full
             readback's, misses); 8 frames through NativeFrameSink, read
             back by read_png; render_batch (graph replays) bit-equal to
             step_frame, its ms/frame beside an eager loop's; supersample=2
             on config 1 (K1, K6 at 2560x1440)
             and the flagship (K1, K2 at 3840x2160) bit-equal to the box
             average of the frame at twice the size, overflow 0, config 1
             within 1 u8 of its plain chain's; a checkpoint saved mid-orbit
             and loaded onto the card resumes bit-exactly; one frame under
             debug_layer raises nothing.  One line a part.
20. window — the window-gather PCF (shadow_window_gather) on the three
             config-4 paths (fused split, fused unsplit, staged; the
             flagship scene, 1024^2 map): at every 4th step of the 64-step
             orbit step_frame with the flag equal (torch.equal) to
             step_frame without it, overflow 0; the largest bad-quad count
             beside the automatic cap; the last frame's visibility on the
             card bit-equal to the quad path's (and on the split path to
             the CPU's); overflow
             >= 1 at shadow_bad_quads_cap 8; ms/frame, CUDA launches and
             device busy ms a frame, and shadow_visibility's graph-replayed
             device ms, flag on beside flag off.  One line a path.
21. graph  — step_frame_jit, the frame captured once as a CUDA graph and
             replayed, on the seven main paths (fused flagship, config 1,
             staged flagship, fused list-fed, the three config-4 paths),
             supersample=2 on config 1 and the split config 4 with the
             window-gather PCF, at full size: the host-built perspective
             matrix bit-equal to the device build it replaced; the capture's
             seconds and the graph's pool MiB; at every 4th of the 64 orbit
             steps frame and state bit-equal to step_frame's, no wrapper
             launch in a replay, the graph's overflow count 0; ms/frame
             graphed and eager in turns (best of 3 x 30); from one profiled
             window each, device busy ms and share, device kernels and
             copies a frame, and 0 synchronising calls in a graphed frame.
             Then JAX's overflow warning, once per offending frame under
             replay.  One line a path.
22. bands — the screen-row band path.  bands_kernels: K6, K3, K7, K2 and
             K8 on the middle band of 3 (rows 360-719) and K6, K3 and K7 on
             the second band of 4 (rows 270-539: a padded last tile row) of
             the flagship frame, against their plain versions on the same
             band inputs (K6, K7 and K8 bit-equal, K3 torch.equal, K2 within
             1 u8) and against the same rows of the full frame's kernel
             (bit-equal on whole tiles; K7 on the 270-row band within 1 u8):
             device ms band beside full frame.  bands: parallel.render_sharded
             in 3 spawned ranks sharing the card through a gloo group (the
             fused flagship, the fused list-fed frame, the staged flagship,
             the unsplit config 4 with FXAA, the staged config 4 with K8 on
             each band) and in 4 (the fused flagship config on 270-row
             bands, which takes the staged branch; config 1 on 180-row
             bands): each rank's launches, the summed overflow 0 at every
             4th step of the 64-step orbit, the assembled frame against the
             single-device frame of the same state (exact for config 1, else
             within 1 u8 on < 0.2% of pixels), each rank's ms/frame.
             In the same spawns, the mesh paths (parallel.make_mesh): in 4
             ranks render_frames_batch_tri_sharded of the staged flagship
             (2 frames, mesh frame 1 x tri 2 x rows 2 declared (frame, tri,
             rows): 270-row sub-bands) and render_frames_batch_sharded of
             the fused flagship config (4 frames, frame 2 x rows 2: 540-row
             bands, the staged branch); in 3, render_tri_sharded of the
             staged config 4 (3 triangle shards, 360-row sub-bands, K8 on
             each composited sub-band).  Each: every rank's launches, the
             overflow 0 at 4 calls around the orbit, the last call's frames
             against render_stats at the same clocks (the staged frame for
             the triangle shards) within 1 u8 on < 0.2%, the bytes a rank
             puts into collectives a frame, ms/frame.  Then
             dryrun_multichip(4) on the card (its kernel step launches K2).

Then the card's name and power limit (nvidia-smi), the kernels line (with
the band entries k6_band, k3_band, k7_band, k2_band, k8_band), and the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.  Needs one card; imports no JAX.  Each main path runs
with every launch count set to 0 just before it and read just after.

    python3 chip_smoke.py --graph

runs the build, the app phase and the graph phase only (~2 minutes): the
quickest check of step_frame_jit on the card.

    python3 chip_smoke.py --time-staged DIR

runs no phase: it times the setup kernels, K1 on the flagship's camera pass
and K4 on config 4's light-view pass (1024^2), and the staged frame's
per-pixel kernels, K6, K7 (also with its light-heaviest tile's count set
to 0 and with no point light) and K8, from CUDA-graph replays on the staged
flagship's inputs, with the port imported from the checkout at DIR, and
prints one JSON line (with the setup kernels' and K8's ptxas lines when this
process built them) and the card's name and power limit.  It passes only
the arguments every version of the wrappers takes (K8 by either of its
signatures, bump_call), so that one call can time the parent commit
(unpacked with `git archive` into a directory .gitignore lists) and this
tree in turns on the same card.

    python3 chip_smoke.py --time-bump DIR

runs no phase: it builds copies of the csrc/bump.cu of the checkout at DIR
(BUMP_ABLATIONS: as it is; with float32 intrinsics for sin and rsqrt,
wrong bits, timing only; the staging alone, without the bump's arithmetic),
checks the first bit-equal to its plain version on the staged config-4
flagship's raster planes, and prints each one's graph-replayed device ms
(the copies in turns, 3 passes) and ptxas lines: where K8's time goes.

    python3 chip_smoke.py --time-setup-blocks

runs no phase: it builds this checkout's csrc/setup.cu at 64, 128 and 256
threads a block (the source's one block size replaced in a copy under
build/), checks each build's K1 and K4 bit-equal to the plain versions on
the flagship inputs, and prints each one's graph-replayed device ms (the
sizes in turns, 3 passes), grid and ptxas lines, and the device ms of the
valid flags computed from the records by a second kernel, as the wrapper
did before the kernel wrote them.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_name_and_limit() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over `reps` calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn: `reps` calls captured in one CUDA
    graph and replayed, so the host's per-call cost (argument checks,
    allocation, the launch itself) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def u8(color):
    import torch

    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.int32)


def frame_stats(a, b) -> dict:
    """bench.py's parity metrics between two uint8/int frames [..., 3]."""
    import torch

    d = (a.to(torch.int32) - b.to(torch.int32)).abs().amax(-1).double()
    return {
        "mean_abs_u8": float(d.mean()),
        "frac_gt_4lsb": float((d > 4).double().mean()),
        "frac_diff": float((d > 0).double().mean()),
        "max_u8": int(d.max()),
    }


def flagship_scene(tp, cfg, device):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=24))
    state = tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(256, cfg=cfg, radius=1.2, device=device),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=device),
        device=device,
    )
    return geo, state


def small_scene(tp, cfg, device):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, device=device),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=device),
        device=device,
    )


def k2_inputs(tp, state, cfg):
    """Setup + binning of one frame -> the tile renderer's arguments."""
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting, lighting_cuda
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    args = (
        binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
        fused.build_material_table(state.materials, cfg.gamma),
        lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg,
                                    lighting.inverse_view_proj(view_proj), cfg.width, cfg.height),
    )
    kw = dict(
        nty=-(-cfg.height // cfg.tile_h), ntx=-(-cfg.width // cfg.tile_w),
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
    )
    return args, kw, binned


# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations counted from the kernels' sources (a multiply or add is 1, a
# fused multiply-add 2, a divide, square root or pow 1): the edge tests of
# one record at one pixel, the shading of one covered pixel without point
# lights, one point light at one covered pixel.
RASTER_OPS_PER_RECORD_PIXEL = 26
SHADE_OPS_PER_PIXEL = 130
SHADE_OPS_PER_PIXEL_LIGHT = 120
SETUP_OPS_PER_TRIANGLE = 300
SETUP_DEPTH_OPS_PER_TRIANGLE = 200
BUMP_OPS_PER_PIXEL = 150     # world from depth + bump.cuh
RESOLVE_OPS_PER_PIXEL = 100  # world from depth + view + directional GGX

# The config-4 flags (tools/bench_configs.py's config-4 row): shadows,
# procedural bump and bloom, the deferred-directional split with the
# in-kernel light cull, full-resolution PCF.
CONFIG4_FLAGS = dict(shadows=True, normal_mapping=True, bloom=True, deferred_directional=True,
                     inkernel_light_cull=True, max_lights_per_tile=128, shadow_vis_downsample=1)
# The shipped unsplit config-4 rows of the JAX package's tools: the config-4
# flags without the split and without the in-kernel cull (the depth
# prepass, per-tile light lists, the visibility plane in the tile kernel).
CONFIG4_UNSPLIT_FLAGS = {**CONFIG4_FLAGS, "deferred_directional": False, "inkernel_light_cull": False}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate, and which of them it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def setup_equal(got, ref) -> bool:
    """Two TriSetups equal bit for bit: records and boxes as int32 views
    (the sign of zero too), and the valid flags."""
    import torch

    i32 = torch.int32
    return (torch.equal(got.packed.view(i32), ref.packed.view(i32))
            and torch.equal(got.aabb.view(i32), ref.aabb.view(i32)) and torch.equal(got.valid, ref.valid))


def ptxas_lines(log: str, entry: str) -> list:
    """ptxas's lines (registers; stack frame and spills) in an nvcc log for
    the kernels whose mangled name holds `entry`.  Empty for a log without
    a build."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = entry in ln
        elif mine and ("registers" in ln or "stack frame" in ln):
            out.append(ln.strip())
    return out


def setup_ptxas(log: str) -> dict:
    """ptxas's lines for the setup kernel's two instantiations: "K1"
    (setup_kernel<true>) and "K4" (setup_kernel<false>)."""
    out = {"K1": ptxas_lines(log, "setup_kernelILb1E"), "K4": ptxas_lines(log, "setup_kernelILb0E")}
    return {k: v for k, v in out.items() if v}


SETUP_THREADS_DECL = re.compile(r"constexpr int kThreads = (\d+);")


def setup_source(csrc_dir: str) -> tuple:
    """(csrc/setup.cu's text, its threads a block)."""
    with open(os.path.join(csrc_dir, "setup.cu")) as fh:
        src = fh.read()
    return src, int(SETUP_THREADS_DECL.search(src).group(1))


def instanced_scene(tp, cfg, device, n: int = 600):
    """n instances of one cube on the benchmark grid: n meshes, 12 n
    triangles, each instance's matrices selected by its mesh id."""
    geo = tp.build_instanced_geometry([tp.procedural.cube(1.0)], [0] * n)
    return tp.animate(tp.make_scene(geo, cfg, placement="grid", device=device), cfg.yaw_per_frame, cfg)


def per_tile_covered(depth_planes, tile_h: int, tile_w: int):
    """Covered pixels (depth < 1) per tile [NT] of a [Hp, Wp] depth plane."""
    Hp, Wp = depth_planes.shape
    return (depth_planes < 1.0).reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w).sum((1, 3)).reshape(-1)


def raster_box_pixels(counts, offs, stream, ntx: int, tile_h: int, tile_w: int, y0: int = 0) -> int:
    """The raster work these binned records need: over every (tile, valid
    record) pair, the pixel centres inside the record's box (its vertices'
    min and max) and inside its tile (tile rows from frame row y0 on: a
    band's), computed on the card."""
    import torch

    n = counts.long()
    tiles = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rows = offs[:-1].long()[tiles] + (torch.arange(tiles.numel(), device=n.device) - first)
    rec = stream[rows]
    x, y = rec[:, 0:6:2], rec[:, 1:6:2]
    counted = []
    for lo, hi, t0, size in ((x.amin(1), x.amax(1), (tiles % ntx) * tile_w, tile_w),
                             (y.amin(1), y.amax(1), (tiles // ntx) * tile_h + y0, tile_h)):
        c0 = torch.maximum(torch.ceil(lo - 0.5), t0.float())
        c1 = torch.minimum(torch.floor(hi - 0.5), (t0 + size - 1).float())
        counted.append(torch.nan_to_num(torch.clamp(c1 - c0 + 1.0, min=0.0), nan=0.0).double())
    return int((counted[0] * counted[1] * (rec[:, 28] > 0.0)).sum())


def tile_load(counts) -> dict:
    """Records per tile: the most, and the 99th percentile."""
    import torch

    c = counts.double()
    return {"max_records_in_a_tile": int(c.max()), "p99_records_per_tile": float(torch.quantile(c, 0.99))}


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def config1_scene(tp, cfg, device):
    """The reference's scene: cube + pyramid from the repo's OBJ assets."""
    import os

    models = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "models")
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(models, f"{m}.obj"))
                                   for m in ("cube", "pyramid")])
    return geo, tp.make_scene(geo, cfg, device=device)


def shadow_plain(state, cfg, raster: bool = True):
    """The shadow map by the plain versions on the card: depth-only setup,
    binning, depth raster -> (depth [S, S] or None, light_vp, overflow)."""
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import raster_tiles, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_depth_reference

    S = cfg.shadow_map_size
    g = state.geometry
    lvp = shadows.light_view_proj(state.lights.direction)
    scfg = shadows.shadow_bin_config(cfg, g.tri_mesh_id.shape[0])
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    tris = setup_depth_reference(g.fv_pos_cols, g.tri_mesh_id, xmath.matmul4_fma(model, lvp), S, S)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg)
    depth = None
    if raster:
        depth = raster_tiles.raster_depth_reference(
            b.counts, b.offs, b.stream, nty=-(-S // scfg.tile_h), ntx=-(-S // scfg.tile_w),
            tile_h=scfg.tile_h, tile_w=scfg.tile_w)[:S, :S]
    return depth, lvp, b.overflow


def staged_plain_chain(state, cfg, shade: bool = True):
    """The staged frame by the plain versions on the card: plain setup,
    binning, plain tile raster, [plain bump], G-buffer, Lambert or [the
    plain shadow map + PCF] + the light cull + plain lighting, post.
    Returns (uint8 frame or None, overflow, light cull or None)."""
    import torch
    from d3d12_deferred_renderer_tpu_torch.ops import bump, lighting, lighting_cuda, post, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.gbuffer import encode_gbuffer
    from d3d12_deferred_renderer_tpu_torch.ops.raster_tiles import (
        fragments_from_planes, raster_tiles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        frame_matrices, setup_triangles_reference,
    )

    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    model, view_proj, mvp = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, W, H)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    planes = raster_tiles_reference(binned.counts, binned.offs, binned.stream,
                                    nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)
    if cfg.normal_mapping:
        bump.bump_tiles_reference(planes, inv_vp, width=W, height=H, tile_h=TH, tile_w=TW,
                                  strength=cfg.bump_strength, freq=cfg.bump_frequency)
    gb = encode_gbuffer(fragments_from_planes(planes, H, W), state.materials, cfg)
    overflow, tl = binned.overflow, None
    if cfg.shading == "lambert":
        color = lighting.shade_lambert(gb, state.lights, cfg) if shade else None
        if shade and cfg.fxaa:
            color = post.fxaa(color)
    else:
        li = state.lights
        vis = None
        if cfg.shadows:
            sd, lvp, s_ovf = shadow_plain(state, cfg, raster=shade)
            if sd is None:  # overflow only: the PCF cap reads the depth alone
                sd = torch.ones((cfg.shadow_map_size,) * 2, device=gb.depth.device)
            vis, v_ovf = shadows.shadow_visibility(gb.depth, view_proj, sd, lvp, cfg,
                                                   return_overflow=True, inv_vp=inv_vp)
            overflow = overflow + s_ovf + v_ovf
        tl = lighting.cull_lights_to_tiles(
            gb.depth, li, cfg, view_proj, tile=(TH, TW),
            max_per_tile=min(li.num_point, cfg.max_live_lights_per_tile), inv_vp=inv_vp,
        )
        overflow = overflow + tl.overflow
        color = None
        if shade:
            hdr = lighting_cuda.shade_tiles_reference(
                lighting_cuda.gbuffer_planes(gb, nty * TH, ntx * TW, vis),
                lighting_cuda.build_light_table(li), tl.indices.reshape(nty * ntx, -1),
                tl.counts.reshape(-1),
                lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H),
                nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=cfg.gamma,
            )
            color = post.apply_post(hdr[:, :H, :W].permute(1, 2, 0), cfg)
    frame = post.to_uint8(color) if color is not None else None
    return frame, overflow, tl


def prepass_lists(depth_pre, state, cfg, view_proj, inv_vp):
    """The per-tile light lists of the depth prepass: the light cull on the
    tile grid, capped at min(L, max_live_lights_per_tile), the id lists
    padded to CHUNK -> (ids [NT, Lk], counts [NT], overflow)."""
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting

    L = state.lights.num_point
    tl = lighting.cull_lights_to_tiles(depth_pre, state.lights, cfg, view_proj, tile=(cfg.tile_h, cfg.tile_w),
                                       max_per_tile=min(L, cfg.max_live_lights_per_tile), inv_vp=inv_vp)
    NT = tl.counts.numel()
    return fused.pad_light_ids_to_chunk(tl.indices.reshape(NT, -1)), tl.counts.reshape(-1), tl.overflow


def fused_plain_chain(state, cfg):
    """The fused frame by the plain versions on the card: plain setup,
    binning, [the plain depth prepass, the light cull, and without the
    split the plain shadow map + PCF], the plain tile renderer and, with
    the split, the plain shadow map, PCF and plain resolve.  Returns (uint8
    frame, overflow, the tile renderer's planes)."""
    import torch.nn.functional as F
    from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting, lighting_cuda, raster_tiles, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        frame_matrices, setup_triangles_reference,
    )

    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    model, view_proj, mvp = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, W, H)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    li = state.lights
    L = li.num_point
    mats = fused.build_material_table(state.materials, cfg.gamma)
    u = lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H)
    ik = cfg.inkernel_light_cull and L > 0
    split = cfg.deferred_directional and cfg.shadows
    overflow = binned.overflow
    depth_pre = ids = counts = vis = None
    if (L and not ik) or (cfg.shadows and not split):
        depth_pre = raster_tiles.raster_depth_reference(binned.counts, binned.offs, binned.stream,
                                                        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)[:H, :W]
    if L and not ik:
        ids, counts, l_ovf = prepass_lists(depth_pre, state, cfg, view_proj, inv_vp)
        overflow = overflow + l_ovf
    if cfg.shadows:
        sd, lvp, s_ovf = shadow_plain(state, cfg)
        overflow = overflow + s_ovf
        if not split:
            vis, v_ovf = shadows.shadow_visibility(depth_pre, view_proj, sd, lvp, cfg, return_overflow=True,
                                                   inv_vp=inv_vp)
            overflow = overflow + v_ovf
            vis = F.pad(vis, (0, ntx * TW - W, 0, nty * TH - H), value=1.0)
    out, tovf = fused.fused_tiles_reference(
        binned.counts, binned.offs, binned.stream, fused.build_light_table(li), mats, u,
        nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
        bump=(cfg.bump_strength, cfg.bump_frequency) if cfg.normal_mapping else None,
        hdr_out=cfg.bloom or split, aux=split, light_ids=ids, light_counts=counts, vis=vis,
    )
    overflow = overflow + tovf.sum()
    color = out[:3]
    if split:
        vis, v_ovf = fused.split_visibility(out, view_proj, sd, lvp, cfg, u, inv_vp)
        overflow = overflow + v_ovf
        color = fused.directional_resolve_reference(out, vis, mats, u)
    return fused.finish_frame(color, cfg, hdr=cfg.bloom or split), overflow, out


def binning_sort_keys(cfg, n_records: int) -> int:
    """The (tile, triangle) keys the sort path of ops/binning.bin_triangles
    sorts each frame: every tier's budget times its rect expansion, and the
    big tier times the tile grid."""
    nty, ntx = -(-cfg.height // cfg.tile_h), -(-cfg.width // cfg.tile_w)
    NT, T = nty * ntx, n_records
    s = max(1, round((cfg.height * cfg.width) / (1920 * 1080)))
    E = max(1, cfg.bin_expand * s)
    EM = max(E + 1, cfg.bin_expand_medium * s)
    EL = max(EM + 1, cfg.bin_expand_large * s)
    LS = T if cfg.bin_max_small < 0 else min(cfg.bin_max_small * s, T)
    keys = LS * E + min(cfg.bin_max_medium * s, T) * EM + min(cfg.bin_max_large * s, T) * EL
    return keys + (min(cfg.bin_max_big * s, T) * NT if EL < NT else 0)


def drive_path(tp, state, cfg, kernels, sweep_steps: int = 64):
    """A main path through the entry points, with every launch count set to
    0 just before it and read just after: 2 warm-up frames, a sweep of the
    whole yaw orbit in `sweep_steps` steps through render_stats, then 3
    passes of 30 step_frame calls timed by CUDA events and the host clock.
    Returns (last state, last frame, frames, launches, sweep states,
    sweep overflows, passes)."""
    import torch

    reset_launches(kernels)
    frames = 0
    for _ in range(2):  # warm-up
        state, frame = tp.step_frame(state, cfg)
        frames += 1
    sweep_states, sweep_ovf = [], []
    sweep = state
    for _ in range(sweep_steps):
        sweep = tp.animate(sweep, 2.0 * math.pi / sweep_steps, cfg)
        _, stats = tp.render_stats(sweep, cfg)
        sweep_states.append(sweep)
        sweep_ovf.append(stats["overflow"])
        frames += 1
    passes = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for _ in range(30):
            state, frame = tp.step_frame(state, cfg)
            frames += 1
        end.record()
        torch.cuda.synchronize()
        passes.append((start.elapsed_time(end) / 30, (time.perf_counter() - t_host) * 1e3 / 30))
    launches = {k.__name__: k.launches for k in kernels}
    return state, frame, frames, launches, sweep_states, [int(o) for o in torch.stack(sweep_ovf)], passes


# The bands phase: the paths that render_sharded drives, each as (label,
# config changes from the fused flagship, band count, frame contract).
# Exact for Lambert; for PBR max |du8| <= 1 on < 0.2% of pixels of the
# single-device frame (band-local light culls).
BAND_PATHS_3 = (
    ("fused_flagship", dict(fused=True), "pbr"),
    ("fused_listfed", dict(fused=True, inkernel_light_cull=False), "pbr"),
    ("staged_flagship", dict(fused=False), "pbr"),
    ("config4_fused_unsplit", dict(fused=True, fxaa=True, **CONFIG4_UNSPLIT_FLAGS), "pbr"),
    ("config4_staged", dict(fused=False, **CONFIG4_FLAGS), "pbr"),
)
# 270-row bands are not whole 8-row tiles: the fused config takes the
# staged branch.  Config 1 (1280x720, Lambert) in bands of 180 rows.
BAND_PATHS_4 = (
    ("staged_flagship_270", dict(fused=True), "pbr"),
    ("config1_180", None, "exact"),
)
BAND_SWEEP_STEPS, BAND_SAMPLE_EVERY = 64, 4


def band_path_config(tp, changes):
    if changes is None:
        return tp.REFERENCE_CONFIG
    return dataclasses.replace(tp.FLAGSHIP_CONFIG, **changes)


def band_sweep_states(tp, state, cfg):
    """The states of the orbit's sampled steps (every BAND_SAMPLE_EVERY-th of
    BAND_SWEEP_STEPS steps of 2 pi / BAND_SWEEP_STEPS)."""
    out = []
    for step in range(BAND_SWEEP_STEPS):
        state = tp.animate(state, 2.0 * math.pi / BAND_SWEEP_STEPS, cfg)
        if step % BAND_SAMPLE_EVERY == BAND_SAMPLE_EVERY - 1:
            out.append(state)
    return out


def bands_job(device, scenes, paths, passes: int = 2, frames_per_pass: int = 10):
    """One band rank of the bands phase (run by parallel.run_bands): each
    path through render_sharded, with every launch count of this rank set
    to 0 just before it and read just after: one warm-up frame, the orbit's
    sampled steps (summed overflow), then `passes` x `frames_per_pass`
    frames of an advancing clock timed by CUDA events and the host clock.
    Returns one dict a path; rank 0's carries the last sampled frame."""
    import torch
    import torch.distributed as dist

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.parallel import render_sharded
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import kernel_wrappers

    wrappers = kernel_wrappers()
    out = []
    for label, changes, _ in paths:
        cfg = band_path_config(tp, changes)
        state = tp.scene_from_arrays(scenes[label], device)
        reset_launches(wrappers)
        frames = 1
        render_sharded(state, cfg)
        sweep = band_sweep_states(tp, state, cfg)
        ovf, frame = [], None
        for s in sweep:
            frame, stats = render_sharded(s, cfg, return_stats=True)
            ovf.append(stats["overflow"])
            frames += 1
        ovf = [int(o) for o in torch.stack(ovf)]
        timed = []
        s = sweep[-1]
        for _ in range(passes):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            start.record()
            for _ in range(frames_per_pass):
                s = tp.animate(s, cfg.yaw_per_frame, cfg)
                render_sharded(s, cfg)
                frames += 1
            end.record()
            torch.cuda.synchronize()
            timed.append((start.elapsed_time(end) / frames_per_pass,
                          (time.perf_counter() - t_host) * 1e3 / frames_per_pass))
        out.append({
            "label": label, "rank": dist.get_rank(), "frames": frames,
            "launches": {w.__name__: w.launches for w in wrappers}, "sampled_overflow": ovf,
            "passes": timed, "frame_sum": int(frame.to(torch.int64).sum()),
            "frame": frame.cpu().numpy() if dist.get_rank() == 0 else None,
        })
    return out


# The band kernels' launches a frame on each path, by wrapper.
BAND_PATH_LAUNCHES = {
    "fused_flagship": {"setup_triangles": 1, "fused_tiles": 1},
    "fused_listfed": {"setup_triangles": 1, "raster_depth": 1, "fused_tiles": 1},
    "staged_flagship": {"setup_triangles": 1, "raster_tiles": 1, "shade_tiles": 1},
    "config4_fused_unsplit": {"setup_triangles": 1, "setup_depth_triangles": 1, "raster_depth": 2,
                              "fused_tiles": 1},
    "config4_staged": {"setup_triangles": 1, "raster_tiles": 1, "bump_tiles": 1, "setup_depth_triangles": 1,
                       "raster_depth": 1, "shade_tiles": 1},
    "staged_flagship_270": {"setup_triangles": 1, "raster_tiles": 1, "shade_tiles": 1},
    "config1_180": {"setup_triangles": 1, "raster_tiles": 1},
}


# The mesh paths of the bands phase (parallel.make_mesh; ranks sharing the
# card through gloo), each (label, config changes from the flagship, entry,
# axis sizes, axis names, keywords, frames a call): the triangle shards x
# row bands x frames of the staged flagship on the mesh declared (frame,
# tri, rows), 270-row sub-bands; the staged config 4 over 3 triangle shards
# (360-row sub-bands, whole tiles for the bump kernel on each composited
# sub-band); frames x rows of the fused flagship config (540-row bands:
# no whole tiles, so the staged branch, as JAX's).
MESH_PATHS_4 = (
    ("tri_rows_3axis", dict(fused=False), "tri_frames", (1, 2, 2), ("frame", "tri", "rows"),
     dict(frame_axis="frame", tri_axis="tri", rows_axis="rows"), 2),
    ("frames_rows", dict(fused=True), "frames", (2, 2), ("frame", "rows"),
     dict(frame_axis="frame", rows_axis="rows"), 4),
)
MESH_PATHS_3 = (
    ("tri_config4", dict(fused=False, **CONFIG4_FLAGS), "tri", (3,), ("tri",), dict(tri_axis="tri"), 1),
)
# The kernels' launches for each frame a rank renders on each mesh path.
MESH_PATH_LAUNCHES = {
    "tri_rows_3axis": {"setup_triangles": 1, "raster_tiles": 1, "shade_tiles": 1},
    "tri_config4": {"setup_triangles": 1, "raster_tiles": 1, "bump_tiles": 1, "setup_depth_triangles": 1,
                    "raster_depth": 1, "shade_tiles": 1},
    "frames_rows": {"setup_triangles": 1, "raster_tiles": 1, "shade_tiles": 1},
}
MESH_CALLS = 4  # calls a path: the clocks of animation_times at 4 starts around the orbit


def mesh_path_starts():
    return [k * 2.0 * math.pi / MESH_CALLS for k in range(MESH_CALLS)]


def mesh_paths_job(device, scene, paths):
    """One rank of the bands phase's mesh paths (run with bands_job through
    parallel.launch.run_calls): each path on parallel.make_mesh of its
    axes, with every launch count and the collective byte count of this
    rank set to 0 just before it and read just after: one warm-up call,
    then MESH_CALLS calls at clocks around the orbit (summed overflow),
    the last 3 of them timed by CUDA events and the host clock.  Returns
    one dict a path; rank 0's carries the last call's frames."""
    import torch
    import torch.distributed as dist

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.parallel import (
        animation_times, make_mesh, render_frames_batch_sharded, render_frames_batch_tri_sharded,
        render_tri_sharded, sharded,
    )
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import kernel_wrappers

    wrappers = kernel_wrappers()
    state = tp.scene_from_arrays(scene, device)
    out = []
    for label, changes, entry, sizes, names, kw, n_frames in paths:
        cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, **changes)
        mesh = make_mesh(sizes, names)

        def call(start):
            times = animation_times(start, n_frames, device=device)
            if entry == "tri":
                frame, stats = render_tri_sharded(sharded._with_time(state, times[0]), cfg, mesh,
                                                  return_stats=True, **kw)
                return frame[None], stats["overflow"]
            fn = render_frames_batch_tri_sharded if entry == "tri_frames" else render_frames_batch_sharded
            frames, stats = fn(state, times, cfg, mesh, return_stats=True, **kw)
            return frames, stats["overflow"]

        reset_launches(wrappers)
        sharded.bytes_sent = 0
        call(0.0)  # warm-up
        ovf, timed, frames = [], [], None
        for k, start in enumerate(mesh_path_starts()):
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            frames, o = call(start)
            ev[1].record()
            torch.cuda.synchronize()
            ovf.append(int(o))
            if k:
                timed.append((ev[0].elapsed_time(ev[1]), (time.perf_counter() - t_host) * 1e3))
        per_rank = n_frames // mesh.shape.get("frame", 1) if entry != "tri" else 1
        rendered = per_rank * (MESH_CALLS + 1)
        out.append({
            "label": label, "rank": dist.get_rank(), "frames_rendered": rendered,
            "launches": {w.__name__: w.launches for w in wrappers}, "overflow": ovf,
            "bytes_per_frame": sharded.bytes_sent / rendered,
            "branch": sharded.band_branch(cfg, cfg.height // mesh.shape["rows"]) if entry == "frames" else "staged",
            "ms_per_frame": [t[0] / per_rank for t in timed], "host_ms_per_frame": [t[1] / per_rank for t in timed],
            "frames_sum": int(frames.to(torch.int64).sum()),
            "frames": frames.cpu().numpy() if dist.get_rank() == 0 else None,
        })
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import numpy as np

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import (
        bump, fused, lighting, lighting_cuda, post, raster_tiles, scatter, setup_cuda, shadows,
    )
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        frame_matrices, setup_depth_reference, setup_frame_triangles,
        setup_triangles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import kernel_wrappers
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    check("jax" not in sys.modules, "the port imported jax")
    wrappers = kernel_wrappers()
    no_launch = {k.__name__: 0 for k in wrappers}

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_build.library()
    emit({
        "phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
        "nvcc_seconds": cuda_build.BuildInfo.seconds, "cached": cuda_build.BuildInfo.cached,
        "library": cuda_build.BuildInfo.path,
        "ptxas": [ln.strip() for ln in cuda_build.BuildInfo.log.splitlines()
                  if "registers" in ln or "spill" in ln],
    })

    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    geo, state0 = flagship_scene(tp, cfg, dev)
    check(geo.num_triangles == 23_906, f"flagship scene has {geo.num_triangles} triangles")
    T = geo.num_triangles
    kernels = {}

    # ---- 2. K1 against its plain version ----
    state = tp.animate(state0, cfg.yaw_per_frame, cfg)
    model, _, mvp = frame_matrices(state, cfg)
    g = state.geometry
    k1_args = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id, mvp, model,
               cfg.width, cfg.height)
    got = setup_cuda.setup_triangles(*k1_args)
    ref = setup_triangles_reference(*k1_args)
    torch.cuda.synchronize()
    check(got.packed.shape == (2 * T, 32), f"K1 shape {tuple(got.packed.shape)}")
    check(setup_equal(got, ref), "K1 records, boxes or valid flags differ from the plain version")
    k1_err = float((got.packed - ref.packed).abs().max())
    # Many meshes: 600 instances, each with its own matrices.
    inst = instanced_scene(tp, cfg, dev)
    imodel, _, imvp = frame_matrices(inst, cfg)
    ig = inst.geometry
    i_args = (ig.fv_pos_cols, ig.fv_nrm_cols, ig.fv_uv_cols, ig.tri_mesh_id, imvp, imodel,
              cfg.width, cfg.height)
    igot, iref = setup_cuda.setup_triangles(*i_args), setup_triangles_reference(*i_args)
    torch.cuda.synchronize()
    check(setup_equal(igot, iref), "K1 differs from the plain version on the 600-mesh scene")
    check(int(igot.valid.sum()) > 0, "the 600-mesh scene has no valid record")
    _, threads = setup_source(cuda_build.CSRC_DIR)
    ptxas = setup_ptxas(cuda_build.BuildInfo.log)
    k1_ms = cuda_ms(lambda: setup_cuda.setup_triangles(*k1_args), 200)
    k1_plain_ms = cuda_ms(lambda: setup_triangles_reference(*k1_args), 20)
    k1_dev_ms = graph_ms(lambda: setup_cuda.setup_triangles(*k1_args), 50)
    M = mvp.shape[0]
    # Face-vertex columns and mesh ids in, the matrices, records, boxes and
    # valid flags out.
    k1_bytes = T * (36 + 36 + 24 + 4) + 2 * M * 64 + 2 * T * (32 * 4 + 16 + 1)
    emit({
        "phase": "k1", "ok": True, "records": int(got.packed.shape[0]), "valid": int(got.valid.sum()),
        "bit_equal": True, "max_abs_err": k1_err,
        "instanced": {"meshes": imvp.shape[0], "triangles": ig.tri_mesh_id.shape[0],
                      "valid": int(igot.valid.sum()), "bit_equal": True},
        "block_threads": threads, "grid": -(-T // threads), "ptxas": ptxas.get("K1"),
        "ms": k1_ms, "device_ms": k1_dev_ms, "plain_ms": k1_plain_ms,
        **bound(k1_bytes, T * SETUP_OPS_PER_TRIANGLE),
    })
    kernels["setup"] = dict(
        name="setup_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:254",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
        **bound(k1_bytes, T * SETUP_OPS_PER_TRIANGLE), library_ms=None, device_ms=k1_dev_ms,
    )
    del igot, iref

    # ---- 3. K2 against its plain version, small and full size ----
    small_cfg = dataclasses.replace(cfg, width=256, height=64)
    for label, kcfg, kstate in (
        ("256x64", small_cfg, tp.animate(small_scene(tp, small_cfg, dev), cfg.yaw_per_frame, cfg)),
        ("1920x1080", cfg, state),
    ):
        args, kw, binned = k2_inputs(tp, kstate, kcfg)
        color, tovf = fused.fused_tiles(*args, **kw)
        pcolor, ptovf, live = fused.fused_tiles_reference(*args, **kw, return_live=True)
        torch.cuda.synchronize()
        check(color.shape == (3, kw["nty"] * kcfg.tile_h, kw["ntx"] * kcfg.tile_w), "K2 shape")
        check(bool(torch.isfinite(color).all()), "K2 produced non-finite values")
        check(torch.equal(tovf, ptovf), f"K2 tile overflow differs at {label}")
        st = frame_stats(u8(color).permute(1, 2, 0), u8(pcolor).permute(1, 2, 0))
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 frame off at {label}: {st}")
        covered = float((u8(color).amax(0) > 0).double().mean())
        check(covered > 0.2, f"K2 frame nearly blank at {label}")
        err = float((color - pcolor).abs().max())
        line = {"phase": "k2", "ok": True, "size": label, "overflow": int(tovf.sum()) + int(binned.overflow),
                "covered_frac": covered, "max_abs_err": err,
                "bit_equal_frac": float((color == pcolor).double().mean()), **st}
        if label == "1920x1080":
            line["binned_pairs"] = int(binned.offs[-1])
            line.update(tile_load(binned.counts))
            line["max_live_lights_in_a_tile"] = int(live.max())
            line["ms"] = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["device_ms"] = graph_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **kw), 2)
            # The work this frame needs: the pixels inside each binned
            # record's box in its tile, every covered pixel, and every
            # covered pixel with each live light of its tile (covered pixels
            # from the tile raster kernel on the same records).
            planes = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream,
                                               **{k: kw[k] for k in ("nty", "ntx", "tile_h", "tile_w")})
            cov = per_tile_covered(planes[raster_tiles.PLANE_DEPTH], kcfg.tile_h, kcfg.tile_w)
            pairs = int(binned.counts.sum())
            box_px = raster_box_pixels(binned.counts, binned.offs, binned.stream, kw["ntx"], kcfg.tile_h,
                                       kcfg.tile_w)
            line["box_pixels"] = box_px
            k2_ops = (box_px * RASTER_OPS_PER_RECORD_PIXEL + int(cov.sum()) * SHADE_OPS_PER_PIXEL
                      + int((cov * live).sum()) * SHADE_OPS_PER_PIXEL_LIGHT)
            k2_bytes = (pairs * 128 + 4 * (2 * binned.counts.numel() + 1) + 4 * args[3].numel()
                        + 4 * args[4].numel() + 4 * args[5].numel() + 4 * color.numel() + 4 * tovf.numel())
            line["live_pixel_light_pairs"] = int((cov * live).sum())
            line.update(bound(k2_bytes, k2_ops))
            kernels["fused"] = dict(
                name="fused_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/fused.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/fused.py:157",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                **bound(k2_bytes, k2_ops), library_ms=None, device_ms=line["device_ms"],
            )
        emit(line)

    # ---- 4. K6 against its plain version: 256x64, config 1, flagship ----
    staged_cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=False)
    c1_cfg = tp.REFERENCE_CONFIG
    c1_geo, c1_state0 = config1_scene(tp, c1_cfg, dev)
    small_staged = dataclasses.replace(staged_cfg, width=256, height=64)
    for label, kcfg, kstate in (
        ("256x64", small_staged, tp.animate(small_scene(tp, small_staged, dev), 0.3, small_staged)),
        ("1280x720", c1_cfg, tp.animate(c1_state0, 0.3, c1_cfg)),
        ("1920x1080", staged_cfg, state),
    ):
        TH, TW = kcfg.tile_h, kcfg.tile_w
        kw = dict(nty=-(-kcfg.height // TH), ntx=-(-kcfg.width // TW), tile_h=TH, tile_w=TW)
        tris, _ = setup_frame_triangles(kstate, kcfg)
        binned = bin_triangles(tris.packed, tris.aabb, tris.valid, kcfg)
        model, _, mvp = frame_matrices(kstate, kcfg)
        g = kstate.geometry
        ptris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                          mvp, model, kcfg.width, kcfg.height)
        pbinned = bin_triangles(ptris.packed, ptris.aabb, ptris.valid, kcfg)
        bargs = (binned.counts, binned.offs, binned.stream)
        planes = raster_tiles.raster_tiles(*bargs, **kw)
        pplanes = raster_tiles.raster_tiles_reference(*bargs, **kw)
        torch.cuda.synchronize()
        # All 8 planes bit for bit (int32 views: the depth's sign of zero
        # included), at the default work items and at R = 16.
        off = (planes.view(torch.int32) != pplanes.view(torch.int32)).sum((1, 2)).tolist()
        check(not any(off), f"K6 planes not bit-equal at {label}: elements off per plane {off}")
        small_r = raster_tiles.raster_tiles(*bargs, **kw, records_per_block=16)
        check(torch.equal(small_r.view(torch.int32), pplanes.view(torch.int32)),
              f"K6 planes at R = 16 not bit-equal at {label}")
        err = float((planes - pplanes).abs().max())
        check(int(binned.overflow) == int(pbinned.overflow), f"K6 overflow differs at {label}")
        covered = float((planes[raster_tiles.PLANE_MID] >= 0).double().mean())
        check(covered > 0.02, f"K6 planes nearly empty at {label}")
        neg_zero = int((planes[raster_tiles.PLANE_DEPTH].view(torch.int32) == -2**31).sum())
        line = {"phase": "k6", "ok": True, "size": label, "overflow": int(binned.overflow),
                "covered_frac": covered, "max_abs_err": err, "bit_equal": True, "neg_zero_depth_pixels": neg_zero,
                "binned_pairs": int(binned.counts.sum()), **tile_load(binned.counts)}
        if label == "1920x1080":
            line["records_per_block"] = raster_tiles.TILE_RECORDS_PER_BLOCK
            line["ms"] = cuda_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw), 100)
            line["device_ms"] = graph_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw), 50)
            line["device_ms_by_records_per_block"] = {
                R: graph_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw, records_per_block=R), 50)
                for R in (16, 32, 64, 128)}
            line["plain_ms"] = cuda_ms(lambda: raster_tiles.raster_tiles_reference(*bargs, **kw), 2)
            pairs = int(binned.counts.sum())
            k6_bytes = pairs * 128 + 4 * (2 * binned.counts.numel() + 1) + 4 * planes.numel()
            line["box_pixels"] = raster_box_pixels(*bargs, kw["ntx"], TH, TW)
            k6_bound = bound(k6_bytes, line["box_pixels"] * RASTER_OPS_PER_RECORD_PIXEL)
            line.update(k6_bound)
            kernels["raster"] = dict(
                name="raster_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/raster.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/raster_pallas.py:730",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"], **k6_bound, library_ms=None,
                device_ms=line["device_ms"],
            )
        emit(line)

    # ---- 5. K7 against its plain version on the flagship G-buffer ----
    H, W, TH, TW = staged_cfg.height, staged_cfg.width, staged_cfg.tile_h, staged_cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    gb = tp.render_gbuffer(state, staged_cfg)
    _, view_proj, _ = frame_matrices(state, staged_cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    li = state.lights
    tl = lighting.cull_lights_to_tiles(gb.depth, li, staged_cfg, view_proj, tile=(TH, TW),
                                       max_per_tile=min(li.num_point, staged_cfg.max_live_lights_per_tile),
                                       inv_vp=inv_vp)
    _, _, ptl = staged_plain_chain(state, staged_cfg, shade=False)
    check(torch.equal(tl.counts, ptl.counts) and torch.equal(tl.indices, ptl.indices),
          "K7 light lists of the kernel G-buffer differ from the plain chain's")
    vis_np = np.random.default_rng(11).uniform(0, 1, (H, W)).astype(np.float32)
    for label, vis in (("no_vis", None), ("vis", torch.from_numpy(vis_np).to(dev))):
        sargs = (lighting_cuda.gbuffer_planes(gb, nty * TH, ntx * TW, vis),
                 lighting_cuda.build_light_table(li), tl.indices.reshape(NT, -1), tl.counts.reshape(NT),
                 lighting_cuda.make_uniforms(state.camera.eye, li, staged_cfg, inv_vp, W, H))
        skw = dict(nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=staged_cfg.gamma)
        hdr = lighting_cuda.shade_tiles(*sargs, **skw)
        phdr = lighting_cuda.shade_tiles_reference(*sargs, **skw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(hdr).all()), f"K7 produced non-finite values ({label})")
        off = int((hdr.view(torch.int32) != phdr.view(torch.int32)).sum())
        check(off == 0, f"K7 HDR ({label}) differs from its plain version on {off} values")
        img = [u8(post.apply_post(h[:, :H, :W].permute(1, 2, 0), staged_cfg)) for h in (hdr, phdr)]
        st = frame_stats(*img)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K7 frame off ({label}): {st}")
        err = float((hdr - phdr).abs().max())
        cov = per_tile_covered(sargs[0][lighting_cuda.P_DEPTH], TH, TW)
        pairs = int((cov * tl.counts.reshape(NT)).sum())
        line = {"phase": "k7", "ok": True, "variant": label, "max_abs_err": err,
                "bit_equal_frac": float((hdr == phdr).double().mean()),
                "tiles_overflowing": int(tl.overflow), "max_live_lights_in_a_tile": int(tl.counts.max()),
                "covered_pixels": int(cov.sum()), "live_pixel_light_pairs": pairs, **st}
        line["device_ms"] = graph_ms(lambda: lighting_cuda.shade_tiles(*sargs, **skw), 50)
        if label == "no_vis":
            line["ms"] = cuda_ms(lambda: lighting_cuda.shade_tiles(*sargs, **skw), 100)
            # The heaviest tile's share: the same launch with that tile's
            # live-light count set to 0.
            light_counts = tl.counts.reshape(NT).double()
            heavy = int(torch.argmax(light_counts))
            no_heavy = sargs[3].clone()
            no_heavy[heavy] = 0
            hargs = (*sargs[:3], no_heavy, sargs[4])
            line["heaviest_tile"] = {
                "tile": heavy, "live_lights": int(light_counts[heavy]),
                "p99_live_lights_per_tile": float(torch.quantile(light_counts, 0.99)),
                "mean_live_lights_per_tile": float(light_counts.mean()),
                "device_ms_without_it": graph_ms(lambda: lighting_cuda.shade_tiles(*hargs, **skw), 50)}
            no_lights = (*sargs[:3], torch.zeros_like(sargs[3]), sargs[4])
            line["device_ms_without_point_lights"] = graph_ms(
                lambda: lighting_cuda.shade_tiles(*no_lights, **skw), 50)
            line["plain_ms"] = cuda_ms(lambda: lighting_cuda.shade_tiles_reference(*sargs, **skw), 2)
            # The bytes the function needs: the depth plane at every pixel,
            # the other planes at covered pixels only (background is depth
            # alone), each tile's live ids and their light rows, the counts,
            # the uniforms and the HDR output.
            n_planes, plane = sargs[0].shape[0], sargs[0][0].numel()
            live_ids = int(tl.counts.sum())
            k7_bytes = 4 * (plane + (n_planes - 1) * int(cov.sum()) + live_ids + NT + 32
                            + hdr.numel()) + 32 * li.num_point
            k7_ops = int(cov.sum()) * SHADE_OPS_PER_PIXEL + pairs * SHADE_OPS_PER_PIXEL_LIGHT
            line.update(bound(k7_bytes, k7_ops))
            kernels["shade"] = dict(
                name="shade_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/shade.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/lighting_pallas.py:52",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                **bound(k7_bytes, k7_ops), library_ms=None, device_ms=line["device_ms"],
            )
        emit(line)
    del gb, sargs, hdr, phdr, img

    # ---- 6. K4: the depth-only setup in the light's view ----
    cfg4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_FLAGS)
    S = cfg4.shadow_map_size
    lvp = shadows.light_view_proj(state.lights.direction)
    model, _, _ = frame_matrices(state, cfg4)
    k4_args = (g.fv_pos_cols, g.tri_mesh_id, xmath.matmul4_fma(model, lvp), S, S)
    got = setup_cuda.setup_depth_triangles(*k4_args)
    ref = setup_depth_reference(*k4_args)
    ilvp = shadows.light_view_proj(inst.lights.direction)
    i4_args = (ig.fv_pos_cols, ig.tri_mesh_id, xmath.matmul4_fma(imodel, ilvp), S, S)
    igot, iref = setup_cuda.setup_depth_triangles(*i4_args), setup_depth_reference(*i4_args)
    torch.cuda.synchronize()
    check(setup_equal(got, ref), "K4 records, boxes or valid flags differ from the plain version")
    check(setup_equal(igot, iref), "K4 differs from the plain version on the 600-mesh scene")
    check(not bool(got.packed[:, 12:27].any()), "K4 attribute fields not zero")
    k4_ms = cuda_ms(lambda: setup_cuda.setup_depth_triangles(*k4_args), 200)
    k4_plain_ms = cuda_ms(lambda: setup_depth_reference(*k4_args), 20)
    k4_dev_ms = graph_ms(lambda: setup_cuda.setup_depth_triangles(*k4_args), 50)
    k4_bytes = T * (36 + 4) + M * 64 + 2 * T * (32 * 4 + 16 + 1)
    emit({"phase": "k4", "ok": True, "records": int(got.packed.shape[0]), "valid": int(got.valid.sum()),
          "bit_equal": True, "max_abs_err": 0.0,
          "instanced": {"meshes": imvp.shape[0], "valid": int(igot.valid.sum()), "bit_equal": True},
          "block_threads": threads, "grid": -(-T // threads), "ptxas": ptxas.get("K4"),
          "ms": k4_ms, "device_ms": k4_dev_ms, "plain_ms": k4_plain_ms,
          **bound(k4_bytes, T * SETUP_DEPTH_OPS_PER_TRIANGLE)})
    kernels["setup_depth"] = dict(
        name="setup_depth_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:281",
        max_abs_err=0.0, ms=k4_ms, plain_ms=k4_plain_ms,
        **bound(k4_bytes, T * SETUP_DEPTH_OPS_PER_TRIANGLE), library_ms=None, device_ms=k4_dev_ms,
    )
    del inst, ig, igot, iref

    # ---- 7. K3: the 1024^2 shadow map on 16 x 128 tiles; the display grid ----
    scfg = shadows.shadow_bin_config(cfg4, T)
    sb = bin_triangles(got.packed, got.aabb, got.valid, scfg)
    skw = dict(nty=S // scfg.tile_h, ntx=S // scfg.tile_w, tile_h=scfg.tile_h, tile_w=scfg.tile_w)
    sargs = (sb.counts, sb.offs, sb.stream)
    sdepth = raster_tiles.raster_depth(*sargs, **skw)
    psdepth = raster_tiles.raster_depth_reference(*sargs, **skw)
    tris, _ = setup_frame_triangles(state, staged_cfg)
    db = bin_triangles(tris.packed, tris.aabb, tris.valid, staged_cfg)
    dkw = dict(nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)
    ddepth = raster_tiles.raster_depth(db.counts, db.offs, db.stream, **dkw)
    dplanes = raster_tiles.raster_tiles(db.counts, db.offs, db.stream, **dkw)
    torch.cuda.synchronize()
    check(torch.equal(sdepth, psdepth), "K3 shadow map not bit-equal to its plain version")
    check(torch.equal(ddepth, dplanes[raster_tiles.PLANE_DEPTH]), "K3 depth differs from K6's depth plane")
    check(int(sb.overflow) == 0, f"shadow binning overflow {int(sb.overflow)}")
    shadow_cov = float((sdepth < 1.0).double().mean())
    check(shadow_cov > 0.05, f"shadow map nearly empty ({shadow_cov})")
    # The split at other work-item sizes R: the same depth.
    for R in (128, 256):
        check(torch.equal(raster_tiles.raster_depth(*sargs, **skw, records_per_block=R), psdepth),
              f"K3 shadow map at R = {R} differs from its plain version")
    k3_ms = cuda_ms(lambda: raster_tiles.raster_depth(*sargs, **skw), 100)
    k3_dev_ms = graph_ms(lambda: raster_tiles.raster_depth(*sargs, **skw), 50)
    k3_r_ms = {R: graph_ms(lambda: raster_tiles.raster_depth(*sargs, **skw, records_per_block=R), 50)
               for R in (64, 128, 256)}
    k3_plain_ms = cuda_ms(lambda: raster_tiles.raster_depth_reference(*sargs, **skw), 2)
    pre_dev_ms = graph_ms(lambda: raster_tiles.raster_depth(db.counts, db.offs, db.stream, **dkw), 50)
    spairs = int(sb.counts.sum())
    k3_bytes = spairs * 128 + 4 * (2 * sb.counts.numel() + 1) + 4 * sdepth.numel()
    s_box_px = raster_box_pixels(*sargs, skw["ntx"], scfg.tile_h, scfg.tile_w)
    k3_bound = bound(k3_bytes, s_box_px * RASTER_OPS_PER_RECORD_PIXEL)
    d_box_px = raster_box_pixels(db.counts, db.offs, db.stream, ntx, TH, TW)
    pre_bound = bound(4 * int(db.counts.sum()) * 32 + 4 * (2 * NT + 1) + 4 * ddepth.numel(),
                      d_box_px * RASTER_OPS_PER_RECORD_PIXEL)
    emit({"phase": "k3", "ok": True, "size": f"{S}x{S}", "tile": f"{scfg.tile_h}x{scfg.tile_w}",
          "binned_pairs": spairs, **tile_load(sb.counts), "box_pixels": s_box_px,
          "records_per_block": raster_tiles.DEPTH_RECORDS_PER_BLOCK,
          "tris_per_tile_cap": scfg.max_tris_per_tile, "covered_frac": shadow_cov,
          "display_grid_bit_equal_to_k6": True, "max_abs_err": 0.0, "ms": k3_ms, "device_ms": k3_dev_ms,
          "device_ms_by_records_per_block": k3_r_ms, "plain_ms": k3_plain_ms, **k3_bound,
          "prepass": {"size": f"{W}x{H}", "binned_pairs": int(db.counts.sum()), **tile_load(db.counts),
                      "box_pixels": d_box_px, "device_ms": pre_dev_ms, **pre_bound}})
    kernels["raster_depth"] = dict(
        name="raster_depth", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/raster.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/raster_pallas.py:799",
        max_abs_err=0.0, ms=k3_ms, plain_ms=k3_plain_ms, **k3_bound, library_ms=None, device_ms=k3_dev_ms,
        prepass_device_ms=pre_dev_ms, prepass_bound_ms=pre_bound["bound_ms"],
    )
    del sdepth, psdepth, ddepth

    # ---- 8. K8: the bump on the flagship frame's raster planes, in place ----
    inv_vp = lighting.inverse_view_proj(view_proj)
    bkw = dict(width=W, height=H, tile_h=TH, tile_w=TW, strength=cfg4.bump_strength, freq=cfg4.bump_frequency)
    bn = bump.bump_tiles(dplanes.clone(), inv_vp, **bkw)
    pbn = bump.bump_tiles_reference(dplanes.clone(), inv_vp, **bkw)
    torch.cuda.synchronize()
    # Every plane bit for bit (int32 views): the normals, and the other
    # planes untouched (1920 x 1080 is whole 8 x 128 tiles: no padding).
    off8 = (bn.view(torch.int32) != pbn.view(torch.int32)).sum((1, 2)).tolist()
    check(not any(off8), f"K8 planes not bit-equal to the plain version's: elements off per plane {off8}")
    k8_err = float((bn - pbn).abs().max())
    moved = float((bn[1:4] != dplanes[1:4]).any(0).double().mean())
    check(moved > 0.1, f"K8 perturbed only {moved} of the pixels")
    t0 = time.perf_counter()
    rsqrt_bad = bump.rsqrt_mismatches(dev)
    rsqrt_s = time.perf_counter() - t0
    check(rsqrt_bad == 0, f"the kernels' rsqrt differs from xmath.rsqrtf on {rsqrt_bad} float32 inputs")
    work = dplanes.clone()
    k8_ms = cuda_ms(lambda: bump.bump_tiles(work, inv_vp, **bkw), 100)
    k8_plain_ms = cuda_ms(lambda: bump.bump_tiles_reference(work, inv_vp, **bkw), 5)
    k8_dev_ms = graph_ms(lambda: bump.bump_tiles(work, inv_vp, **bkw), 50)
    # The bytes the function needs: the mesh id at every pixel (a
    # background or out-of-frame pixel keeps its normal, in place), and at
    # covered pixels depth, u, v and the normal in and out; the inverse.
    # An out-of-place bump (a separate normals output) would also read the
    # normal at every pixel and write all three planes
    # (bound_bytes_out_of_place).
    plane8 = dplanes[raster_tiles.PLANE_MID].numel()
    cov8 = int((dplanes[raster_tiles.PLANE_MID] >= 0).sum())
    k8_bytes = 4 * (plane8 + 9 * cov8 + 16)
    k8_bound = bound(k8_bytes, cov8 * BUMP_OPS_PER_PIXEL)
    k8_old = bound(4 * (7 * plane8 + 3 * cov8 + 32), cov8 * BUMP_OPS_PER_PIXEL)
    emit({"phase": "k8", "ok": True, "bit_equal": True, "max_abs_err": k8_err, "perturbed_frac": moved,
          "covered_pixels": cov8, "rsqrt_check": {"inputs": 2**31, "mismatches": rsqrt_bad, "seconds": rsqrt_s},
          "ptxas": ptxas_lines(cuda_build.BuildInfo.log, "bump_tile_kernel"),
          "ms": k8_ms, "device_ms": k8_dev_ms, "plain_ms": k8_plain_ms, **k8_bound,
          "bound_ms_out_of_place": k8_old["bound_ms"], "bound_bytes_out_of_place": k8_old["bound_bytes"]})
    kernels["bump"] = dict(
        name="bump_tiles", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/bump.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/bump.py:196",
        max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain_ms, **k8_bound, library_ms=None, device_ms=k8_dev_ms,
    )
    del bn, pbn, work

    # ---- 9. K2's config-4 variant: bump + linear HDR + the split's planes ----
    args, kw, binned = k2_inputs(tp, state, cfg4)
    kw.update(bump=(cfg4.bump_strength, cfg4.bump_frequency), hdr_out=True, aux=True)
    out4, tovf4 = fused.fused_tiles(*args, **kw)
    pout4, ptovf4 = fused.fused_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(tovf4, ptovf4), "K2 variant tile overflow differs")
    check(torch.equal(out4[3], dplanes[raster_tiles.PLANE_DEPTH]), "K2 variant depth differs from K6's")
    check(torch.equal(out4[7], dplanes[raster_tiles.PLANE_MID]), "K2 variant mesh ids differ from K6's")
    # The bumped, quantized and decoded normals (planes 4-6) feed the lit
    # mask and K5: bit-equal to the plain version's, as K8's normals are.
    aux_err = float((out4[3:8] - pout4[3:8]).abs().max())
    check(aux_err == 0.0, f"K2 variant aux planes (depth, normal, mesh id) off the plain version's by {aux_err}"
                          f" (elements off per plane: {(out4[3:8] != pout4[3:8]).sum((1, 2)).tolist()})")
    st = frame_stats(*(u8(post.gamma_encode(post.reinhard(o[:3, :H, :W]), cfg4.gamma)).permute(1, 2, 0)
                       for o in (out4, pout4)))
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 variant frame off: {st}")
    k2v_ms = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    k2v_dev_ms = graph_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    emit({"phase": "k2v", "ok": True, "variant": "bump+hdr_out+aux", "max_abs_err": float((out4 - pout4).abs().max()),
          "aux_max_abs_err": aux_err, "aux_depth_mid_bit_equal_to_k6": True, "overflow": int(tovf4.sum()),
          "ms": k2v_ms, "device_ms": k2v_dev_ms, **st})
    del dplanes

    # ---- 10. K5: the directional resolve on the k2v planes (the kernel's
    # aux planes, bit-equal to the plain version's as checked above) ----
    u4 = args[5]
    sd4, lvp4, _ = shadow_plain(state, cfg4)
    vis4, _ = fused.split_visibility(out4, view_proj, sd4, lvp4, cfg4, u4, inv_vp)
    rargs = (out4, vis4, args[4], u4)
    rhdr = fused.directional_resolve(*rargs)
    prhdr = fused.directional_resolve_reference(*rargs)
    torch.cuda.synchronize()
    excess = float(((rhdr - prhdr).abs() - (2e-5 + 2e-4 * prhdr.abs())).max())
    check(excess <= 0.0, f"K5 HDR outside rtol 2e-4, atol 2e-5: excess {excess}")
    st = frame_stats(*(u8(post.gamma_encode(post.reinhard(h[:, :H, :W]), cfg4.gamma)).permute(1, 2, 0)
                       for h in (rhdr, prhdr)))
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K5 frame off: {st}")
    k5_err = float((rhdr - prhdr).abs().max())
    k5_ms = cuda_ms(lambda: fused.directional_resolve(*rargs), 100)
    k5_plain_ms = cuda_ms(lambda: fused.directional_resolve_reference(*rargs), 5)
    k5_dev_ms = graph_ms(lambda: fused.directional_resolve(*rargs), 50)
    # The bytes the function needs: depth and the HDR at every pixel, the
    # normal, mesh id and visibility at covered pixels, the HDR out.
    cov5 = int((out4[3] < 1.0).sum())
    k5_bytes = 4 * (4 * out4[3].numel() + 5 * cov5 + 3 * out4[3].numel() + 64 + 32)
    emit({"phase": "k5", "ok": True, "max_abs_err": k5_err, "bit_equal_frac": float((rhdr == prhdr).double().mean()),
          "covered_pixels": cov5, "ms": k5_ms, "device_ms": k5_dev_ms, "plain_ms": k5_plain_ms,
          **bound(k5_bytes, cov5 * RESOLVE_OPS_PER_PIXEL), **st})
    kernels["resolve"] = dict(
        name="directional_resolve", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/resolve.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/fused.py:445",
        max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms,
        **bound(k5_bytes, cov5 * RESOLVE_OPS_PER_PIXEL), library_ms=None, device_ms=k5_dev_ms,
    )
    del out4, pout4, rhdr, prhdr, rargs, args, vis4

    # ---- 11. K2 fed by the depth prepass's per-tile light lists ----
    lcfg = dataclasses.replace(cfg, inkernel_light_cull=False)
    args, kw, binned = k2_inputs(tp, state, lcfg)
    grid = {k: kw[k] for k in ("nty", "ntx", "tile_h", "tile_w")}
    bargs = (binned.counts, binned.offs, binned.stream)
    depth_pre = raster_tiles.raster_depth(*bargs, **grid)
    kplanes = raster_tiles.raster_tiles(*bargs, **grid)
    check(torch.equal(depth_pre, kplanes[raster_tiles.PLANE_DEPTH]), "prepass depth differs from K6's depth plane")
    ids, counts, l_ovf = prepass_lists(depth_pre[:H, :W], state, lcfg, view_proj, inv_vp)
    c4u = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_UNSPLIT_FLAGS)
    vis_u, v_ovf = shadows.shadow_visibility(depth_pre[:H, :W], view_proj, sd4, lvp4, c4u, return_overflow=True,
                                             inv_vp=inv_vp)
    vis_u = torch.nn.functional.pad(vis_u, (0, ntx * TW - W, 0, nty * TH - H), value=1.0)
    check(int(l_ovf) == 0 and int(v_ovf) == 0, f"prepass lists or PCF overflow: {int(l_ovf)}, {int(v_ovf)}")
    bump4 = (cfg4.bump_strength, cfg4.bump_frequency)
    lkw = dict(kw, ik_slots=0, light_ids=ids, light_counts=counts)
    k2l_variants = {
        "lists": lkw,
        "lists+vis": dict(lkw, vis=vis_u),
        "lists+vis+bump+hdr_out": dict(lkw, vis=vis_u, bump=bump4, hdr_out=True),
        "lists+bump+aux": dict(lkw, bump=bump4, aux=True),
    }
    cov_l = per_tile_covered(depth_pre, TH, TW)
    pairs = int(binned.counts.sum())
    live_pairs = int((cov_l * counts).sum())
    k2l_ops = (raster_box_pixels(*bargs, ntx, TH, TW) * RASTER_OPS_PER_RECORD_PIXEL
               + int(cov_l.sum()) * SHADE_OPS_PER_PIXEL + live_pairs * SHADE_OPS_PER_PIXEL_LIGHT)
    ik_ms = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
    k2l_ms, k2l_dev_ms = {}, {}
    for label, vkw in k2l_variants.items():
        lout, lovf = fused.fused_tiles(*args, **vkw)
        plout, plovf = fused.fused_tiles_reference(*args, **vkw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lout).all()), f"K2 {label} produced non-finite values")
        check(torch.equal(lovf, plovf) and not bool(lovf.any()), f"K2 {label} tile overflow not 0")
        hdr = vkw.get("hdr_out") or vkw.get("aux")
        img = [o[:3, :H, :W] for o in (lout, plout)]
        if hdr:
            img = [post.gamma_encode(post.reinhard(o), cfg.gamma) for o in img]
        st = frame_stats(*(u8(o).permute(1, 2, 0) for o in img))
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 {label} frame off: {st}")
        line = {"phase": "k2l", "ok": True, "variant": label, "max_abs_err": float((lout - plout).abs().max()),
                "bit_equal_frac": float((lout == plout).double().mean()), **st}
        if vkw.get("aux"):
            check(torch.equal(lout[3], kplanes[raster_tiles.PLANE_DEPTH])
                  and torch.equal(lout[7], kplanes[raster_tiles.PLANE_MID]), f"K2 {label}: depth or mesh id != K6's")
            aux_err = float((lout[3:8] - plout[3:8]).abs().max())
            check(aux_err == 0.0, f"K2 {label} aux planes off the plain version's by {aux_err}")
            line["aux_depth_mid_bit_equal_to_k6"] = True
        line["ms"] = k2l_ms[label] = cuda_ms(lambda: fused.fused_tiles(*args, **vkw), 50)
        line["device_ms"] = k2l_dev_ms[label] = graph_ms(lambda: fused.fused_tiles(*args, **vkw), 50)
        # The bytes the function needs: the in-kernel cull's, plus the lists
        # and counts and, with it, the visibility plane; the same operations
        # over this frame's live pixel-light pairs.
        k2l_bytes = (pairs * 128 + 4 * (2 * NT + 1) + 4 * (args[3].numel() + args[4].numel() + args[5].numel())
                     + 4 * (ids.numel() + NT) + (4 * vis_u.numel() if "vis" in vkw else 0)
                     + 4 * lout.numel() + 4 * NT)
        line.update(bound(k2l_bytes, k2l_ops))
        if label == "lists":
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **vkw), 2)
            line["in_kernel_cull_ms"] = ik_ms
            line["lists_shape"] = list(ids.shape)
            line["max_live_lights_in_a_tile"] = int(counts.max())
            line["live_pixel_light_pairs"] = live_pairs
            kernels["fused"]["list_fed"] = dict(ms=line["ms"], device_ms=line["device_ms"], plain_ms=line["plain_ms"],
                                                in_kernel_cull_ms=ik_ms, **bound(k2l_bytes, k2l_ops))
        emit(line)
    kernels["fused"]["variants_ms"] = k2l_ms
    kernels["fused"]["variants_device_ms"] = k2l_dev_ms
    del args, lout, plout, kplanes, depth_pre, vis_u, sd4
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t_start})

    total_launches = {k.__name__: 0 for k in wrappers}

    # ---- 6. the main path: the fused flagship frame ----
    torch.cuda.reset_peak_memory_stats()
    state, frame, frames, launches, _, sweep_ovf, passes = drive_path(tp, state0, cfg, wrappers)
    sweep_max = max(sweep_ovf)
    check(sweep_max == 0, f"overflow {sweep_max} on the yaw orbit sweep")
    main_kernels = ("setup_triangles", "fused_tiles")
    check(all(launches[k] == frames for k in main_kernels),
          f"launch counts {launches} != {frames} frames")
    for k, n in launches.items():
        total_launches[k] += n

    check(frame.shape == (cfg.height, cfg.width, 3) and frame.dtype == torch.uint8, "frame shape")
    covered = float((frame.amax(-1) > 0).double().mean())
    check(covered > 0.2, f"main-path frame nearly blank ({covered})")
    # The last frame against the plain chain (plain setup, binning, plain
    # tile renderer) on the same state.
    L = state.lights.num_point
    plain_frame, _, _ = fused_plain_chain(state, cfg)
    st = frame_stats(frame, plain_frame)
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"main-path frame vs plain chain: {st}")
    # The host's synchronising calls a frame, over 10 profiled step_frame
    # calls (each also copies its overflow count for the warning, without
    # blocking).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pstate = state
        for _ in range(10):
            pstate, _ = tp.step_frame(pstate, cfg)
    torch.cuda.synchronize()
    api = {e.key: e.count for e in prof.key_averages()}
    syncs = {k: api.get(k, 0) / 10 for k in ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpyAsync")}
    check(syncs["cudaStreamSynchronize"] + syncs["cudaEventSynchronize"] <= 3,
          f"main path: more than 3 synchronising calls a frame: {syncs}")
    best = min(p[0] for p in passes)
    emit({
        "phase": "main", "ok": True, "resolution": f"{cfg.width}x{cfg.height}", "host_calls_per_frame": syncs,
        "triangles": geo.num_triangles, "lights": L, "frames": frames,
        "sweep_steps": 64, "sweep_max_overflow": sweep_max,
        "launches": {k: launches[k] for k in main_kernels},
        "covered_frac": covered, "vs_plain_chain": st,
        "ms_per_frame": best, "fps": 1e3 / best,
        "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
    })

    # ---- 7. the staged frame: config 1 and the staged flagship ----
    for label, scfg, sstate0 in (("config1", c1_cfg, c1_state0), ("staged_flagship", staged_cfg, state0)):
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, sweep_states, sweep_ovf, passes = drive_path(
            tp, sstate0, scfg, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        pbr = scfg.shading == "pbr"
        expect = {**no_launch, "setup_triangles": frames, "raster_tiles": frames,
                  "shade_tiles": frames if pbr else 0}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        line = {"phase": "staged", "ok": True, "config": label,
                "resolution": f"{scfg.width}x{scfg.height}", "shading": scfg.shading,
                "triangles": int(sstate.geometry.tri_mesh_id.numel()),
                "lights": sstate.lights.num_point, "frames": frames, "launches": launches,
                "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf)}
        if not pbr:
            check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        # The overflow of the plain chain at every 4th step of the sweep.
        sampled = list(range(3, len(sweep_states), 4))
        plain_ovf = [int(staged_plain_chain(sweep_states[i], scfg, shade=False)[1]) for i in sampled]
        kernel_ovf = [sweep_ovf[i] for i in sampled]
        check(plain_ovf == kernel_ovf, f"{label}: overflow {kernel_ovf} != plain chain's {plain_ovf}")
        line["sampled_steps"] = sampled
        line["sampled_overflow"] = kernel_ovf
        if pbr:
            # Live lights per tile over the whole orbit, uncapped, from the
            # kernel path's depth (bit-equal to the plain raster's).
            per_step = []
            for s in sweep_states:
                sgb = tp.render_gbuffer(s, scfg)
                _, svp, _ = frame_matrices(s, scfg)
                stl = lighting.cull_lights_to_tiles(sgb.depth, s.lights, scfg, svp,
                                                    tile=(scfg.tile_h, scfg.tile_w),
                                                    max_per_tile=s.lights.num_point)
                per_step.append(stl.counts.max())
            per_step = [int(c) for c in torch.stack(per_step)]
            line["orbit_max_live_lights_per_tile"] = max(per_step)
            line["live_light_cap"] = min(sstate.lights.num_point, scfg.max_live_lights_per_tile)
            line["steps_over_cap"] = sum(c > line["live_light_cap"] for c in per_step)
        check(sframe.shape == (scfg.height, scfg.width, 3) and sframe.dtype == torch.uint8,
              f"{label}: frame shape")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.02, f"{label}: frame nearly blank ({covered})")
        pframe, _, _ = staged_plain_chain(sstate, scfg)
        st = frame_stats(sframe, pframe)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        line.update({
            "covered_frac": covered, "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
            "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
            "peak_mem_mib": peak_mib,
        })
        emit(line)

    # ---- 13. config 4: the fused frame with the split, and the staged frame ----
    for label, fused_path in (("config4_fused_split", True), ("config4_staged", False)):
        c4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=fused_path, **CONFIG4_FLAGS)
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, sweep_states, sweep_ovf, passes = drive_path(
            tp, state0, c4, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        common = {"setup_triangles": frames, "setup_depth_triangles": frames, "raster_depth": frames}
        if fused_path:
            expect = {**no_launch, **common, "fused_tiles": frames, "directional_resolve": frames}
        else:
            expect = {**no_launch, **common, "raster_tiles": frames, "bump_tiles": frames,
                      "shade_tiles": frames}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        line = {"phase": "config4", "ok": True, "config": label,
                "resolution": f"{c4.width}x{c4.height}", "shadow_map": c4.shadow_map_size,
                "triangles": T, "lights": sstate.lights.num_point, "frames": frames,
                "launches": {k: n for k, n in launches.items() if n},
                "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
                "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf)}
        if not fused_path:
            sampled = list(range(3, len(sweep_states), 4))
            plain_ovf = [int(staged_plain_chain(sweep_states[i], c4, shade=False)[1]) for i in sampled]
            kernel_ovf = [sweep_ovf[i] for i in sampled]
            check(plain_ovf == kernel_ovf, f"{label}: overflow {kernel_ovf} != plain chain's {plain_ovf}")
            line["sampled_steps"], line["sampled_overflow"] = sampled, kernel_ovf
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        pframe = (fused_plain_chain(sstate, c4) if fused_path else staged_plain_chain(sstate, c4))[0]
        st = frame_stats(sframe, pframe)
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        line.update({
            "covered_frac": covered, "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
            "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
            "peak_mem_mib": peak_mib,
        })
        emit(line)

    # ---- 16. the fused frame with the depth prepass: the flagship without
    # the in-kernel cull, config 4 without the split (the visibility plane) ----
    for label, pcfg in (
        ("fused_listfed", dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, inkernel_light_cull=False)),
        ("config4_fused_unsplit", dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_UNSPLIT_FLAGS)),
    ):
        torch.cuda.reset_peak_memory_stats()
        sstate, sframe, frames, launches, _, sweep_ovf, passes = drive_path(tp, state0, pcfg, wrappers)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        expect = {**no_launch, "setup_triangles": frames, "raster_depth": frames, "fused_tiles": frames}
        if pcfg.shadows:  # the shadow map: depth-only setup and a second depth raster
            expect.update(setup_depth_triangles=frames, raster_depth=2 * frames)
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        st = frame_stats(sframe, fused_plain_chain(sstate, pcfg)[0])
        check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
        best = min(p[0] for p in passes)
        emit({"phase": "prepass", "ok": True, "config": label, "resolution": f"{pcfg.width}x{pcfg.height}",
              "triangles": T, "lights": sstate.lights.num_point, "frames": frames,
              "launches": {k: n for k, n in launches.items() if n},
              "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
              "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf), "covered_frac": covered,
              "vs_plain_chain": st, "ms_per_frame": best, "fps": 1e3 / best,
              "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
              "peak_mem_mib": peak_mib})

    # ---- 17. calibrate: autotune_shadow on the split config 4, autotune on
    # the colonnade scene (tools/bench_configs.py's two calibrated rows) ----
    c4 = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_FLAGS)
    cgeo = tp.build_scene_geometry(tp.procedural.colonnade_meshes())
    ccfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    cstate0 = tp.make_scene(
        cgeo, ccfg, lights=tp.random_point_lights(256, cfg=ccfg, radius=1.2, device=dev), placement="origin",
        materials=tp.Materials.varied(cgeo.num_meshes, device=dev), device=dev)
    for label, tune, tcfg, tstate0 in (("config4_autotune_shadow", tp.autotune_shadow, c4, state0),
                                      ("colonnade_autotune", tp.autotune, ccfg, cstate0)):
        t0 = time.perf_counter()
        cal, rep = tune(tstate0, tcfg)
        tune_s = time.perf_counter() - t0
        n_rec = 2 * int(tstate0.geometry.tri_mesh_id.numel())
        line = {"phase": "calibrate", "ok": True, "config": label, "tune_seconds": tune_s,
                "triangles": n_rec // 2, "report": rep}
        if label == "config4_autotune_shadow":
            scfg_def = shadows.shadow_bin_config(tcfg, n_rec // 2)
            scfg_cal = shadows.shadow_bin_config(cal, n_rec // 2)
            line["sort_keys"] = {"default_tiers": binning_sort_keys(scfg_def, n_rec),
                                 "calibrated": binning_sort_keys(scfg_cal, n_rec)}
            # The calibrated tiers bin the same records: the same shadow map.
            sd_def, _ = shadows.render_shadow_map(tstate0, tcfg)
            sd_cal, _ = shadows.render_shadow_map(tstate0, cal)
            check(torch.equal(sd_def, sd_cal), f"{label}: calibrated shadow map differs from the default tiers'")
            expect_k = {"setup_triangles": 1, "setup_depth_triangles": 1, "raster_depth": 1, "fused_tiles": 1,
                        "directional_resolve": 1}
        else:
            line["sort_keys"] = {"flagship_tiers": binning_sort_keys(tcfg, n_rec),
                                 "calibrated": binning_sort_keys(cal, n_rec)}
            expect_k = {"setup_triangles": 1, "fused_tiles": 1}
        print(f"{label}: {json.dumps(rep)}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        # A 16-step sweep keeps the script's time down; the prepass paths
        # above sweep the whole 64.
        sstate, sframe, frames, launches, _, sweep_ovf, passes = drive_path(tp, tstate0, cal, wrappers,
                                                                            sweep_steps=16)
        expect = {**no_launch, **{k: n * frames for k, n in expect_k.items()}}
        check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
        for k, n in launches.items():
            total_launches[k] += n
        check(max(sweep_ovf) == 0, f"{label}: overflow {max(sweep_ovf)} on the orbit sweep")
        covered = float((sframe.amax(-1) > 0).double().mean())
        check(covered > 0.2, f"{label}: frame nearly blank ({covered})")
        if label == "colonnade_autotune":
            st = frame_stats(sframe, fused_plain_chain(sstate, cal)[0])
            check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"{label}: frame vs plain chain: {st}")
            line["vs_plain_chain"] = st
        best = min(p[0] for p in passes)
        line.update({"frames": frames, "launches_per_frame": {k: n / frames for k, n in launches.items() if n},
                     "sweep_steps": len(sweep_ovf), "sweep_max_overflow": max(sweep_ovf), "covered_frac": covered,
                     "ms_per_frame": best, "fps": 1e3 / best, "passes_device_ms": [p[0] for p in passes],
                     "passes_host_ms": [p[1] for p in passes],
                     "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20})
        emit(line)

    # ---- 14. bench.py's parity blocks: fused against staged at 256x64 ----
    pgeo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4))
    parity = {}
    for pname, extras in (("pbr", {}), ("config4", {k: CONFIG4_FLAGS[k] for k in (
            "shadows", "normal_mapping", "bloom", "deferred_directional", "inkernel_light_cull")})):
        pcfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True, **extras)
        pstate = tp.make_scene(
            pgeo, pcfg, lights=tp.random_point_lights(16, cfg=pcfg, radius=1.2, device=dev),
            placement="grid", materials=tp.Materials.varied(pgeo.num_meshes, device=dev), device=dev)
        f_fused, o_fused = tp.render_stats(pstate, pcfg)
        f_staged, o_staged = tp.render_stats(pstate, dataclasses.replace(pcfg, fused=False))
        st = frame_stats(f_fused, f_staged)
        parity[pname] = {k: st[k] for k in ("mean_abs_u8", "frac_gt_4lsb", "max_u8", "frac_diff")}
        parity[pname]["overflow"] = [int(o_fused["overflow"]), int(o_staged["overflow"])]
        check(st["mean_abs_u8"] <= 1.0 and st["frac_gt_4lsb"] <= 0.02, f"parity {pname}: {st}")
    emit({"phase": "parity", "ok": True, "size": "256x64", **parity})

    # ---- 18. K9: the row scatter, at the TPU tool's sizes and at the
    # flagship binning's sort-key count ----
    n_keys = binning_sort_keys(cfg, 2 * T)
    k9_launches = 0
    for n in (4096, 8192, n_keys):
        gen = torch.Generator().manual_seed(n)
        idx = torch.randperm(n, generator=gen).to(torch.int32).to(dev)
        val = torch.randint(0, 1 << 30, (n, 128), generator=gen, dtype=torch.int32).to(dev)
        got = scatter.row_scatter(idx, val)
        ref = scatter.row_scatter_reference(idx, val)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K9 differs from its plain version at n = {n}")
        # The scatter's own run: launches counted from 0 over the timing.
        # call_ms times calls back to back (the wrapper's host work
        # included); ms replays them from a CUDA graph (device time).
        scatter.row_scatter.launches = 0
        k9_call_ms = cuda_ms(lambda: scatter.row_scatter(idx, val), 200)
        k9_launches += scatter.row_scatter.launches
        check(scatter.row_scatter.launches == 201, f"K9 launches {scatter.row_scatter.launches} != 201")
        out, idx_l = torch.empty_like(val), idx.long()
        keys = torch.randint(0, 1 << 40, (n,), generator=gen, dtype=torch.int64).to(dev)
        fns = {"kernel": lambda: scatter.row_scatter(idx, val),
               "plain": lambda: scatter.row_scatter_reference(idx, val),
               "index_copy_": lambda: out.index_copy_(0, idx_l, val), "sort": lambda: torch.sort(keys)}
        dev_ms = {k: graph_ms(f, 50) for k, f in fns.items()}
        k9_ms, k9_plain_ms, k9_lib_ms = dev_ms["kernel"], dev_ms["plain"], dev_ms["index_copy_"]
        k9_bound = bound(2 * n * 512 + 4 * n, 0)
        emit({"phase": "k9", "ok": True, "rows": n, "bit_equal": True, "ms": k9_ms, "ns_per_row": k9_ms * 1e6 / n,
              "call_ms": k9_call_ms, "plain_ms": k9_plain_ms, "library_ms": k9_lib_ms, "library": "index_copy_",
              "torch_sort_int64_ms": dev_ms["sort"], "torch_sort_ns_per_key": dev_ms["sort"] * 1e6 / n,
              "timing": "device ms per call, 50 calls replayed from one CUDA graph", **k9_bound})
    kernels["scatter"] = dict(
        name="row_scatter", route="cuda", source="d3d12_deferred_renderer_tpu_torch/csrc/scatter.cu",
        replaces="tools/ubench_pallas_scatter.py:39", launches=k9_launches, max_abs_err=0.0, ms=k9_ms,
        device_ms=k9_ms, plain_ms=k9_plain_ms, **k9_bound, library_ms=k9_lib_ms, rows=n_keys,
    )

    # ---- 19. app: the application path (App, the queues, the sink, render_batch,
    # supersampling, checkpoints, the debug layer) ----
    t_app = time.perf_counter()
    for k, n in app_phase(tp, state0, cfg, c1_state0, c1_cfg, wrappers).items():
        total_launches[k] += n
    emit({"phase": "app_done", "seconds": time.perf_counter() - t_app})

    # ---- 20. window: the window-gather PCF on the three config-4 paths ----
    t_window = time.perf_counter()
    for k, n in window_phase(tp, state0, wrappers, card_name_and_limit()).items():
        total_launches[k] += n
    emit({"phase": "window_done", "seconds": time.perf_counter() - t_window})

    # ---- 21. graph: step_frame_jit on every main path ----
    t_graph = time.perf_counter()
    for k, n in graph_phase(tp, state0, c1_state0, wrappers, card_name_and_limit()).items():
        total_launches[k] += n
    emit({"phase": "graph_done", "seconds": time.perf_counter() - t_graph})
    for key, name in (("setup", "setup_triangles"), ("fused", "fused_tiles"),
                      ("raster", "raster_tiles"), ("shade", "shade_tiles"),
                      ("setup_depth", "setup_depth_triangles"), ("raster_depth", "raster_depth"),
                      ("bump", "bump_tiles"), ("resolve", "directional_resolve")):
        kernels[key]["launches"] = total_launches[name]
        check(total_launches[name] > 0, f"{name} never launched on the main paths")

    # ---- 22. bands: the band kernels, then render_sharded's paths ----
    t_bands = time.perf_counter()
    band_kernel_phase(tp, state, dev, kernels)
    band_path_phase(tp, state0, c1_state0, dev, kernels)
    emit({"phase": "bands_done", "seconds": time.perf_counter() - t_bands})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})

    print(card_name_and_limit(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("device_ms", "list_fed", "variants_ms", "variants_device_ms", "rows", "prepass_device_ms",
             "prepass_bound_ms", "band", "full_frame_device_ms")
    emit({"kernels": [{**{k: kernels[n][k] for k in keys}, **{k: kernels[n][k] for k in extra if k in kernels[n]}}
                      for n in ("setup", "fused", "raster", "shade", "setup_depth", "raster_depth", "bump",
                                "resolve", "scatter", "k6_band", "k3_band", "k7_band", "k2_band", "k8_band")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


APP_FRAMES = 30


def box_average(hi, s: int):
    """The s x s box average of a uint8 frame [s H, s W, 3], by integer
    arithmetic: each block's sum over s^2, rounded half to even."""
    import torch

    H, W = hi.shape[0] // s, hi.shape[1] // s
    sums = hi.to(torch.int64).reshape(H, s, W, s, 3).sum(dim=(1, 3))
    q, r = sums // (s * s), sums % (s * s)
    up = (2 * r > s * s) | ((2 * r == s * s) & (q % 2 == 1))
    return (q + up.to(torch.int64)).to(torch.uint8)


def app_phase(tp, state0, cfg, c1_state0, c1_cfg, wrappers) -> dict:
    """The application path on the fused flagship (and config 1 for
    supersampling), modelled on tools/present_run.py.  Each part runs with
    every launch count set to 0 just before it and read just after; returns
    the launches summed over the parts.  present: App with PresentQueue at
    depth 3 over APP_FRAMES frames, each presented frame bit-equal to a
    separate step_frame loop's from the same state; its delivered FPS timed
    in turns with the same frames unpresented, read back synchronously,
    through DeltaPresentQueue and through render_batch; the device-to-host
    ms of one frame into pinned memory.  delta: the same frames through
    DeltaPresentQueue.  sink: 8 frames through NativeFrameSink, read back
    by read_png.  render_batch: 4 frames bit-equal to step_frame's.
    supersample: config 1 (K1, K6)
    and the flagship (K1, K2) at supersample=2, bit-equal to the box average
    of the frame at twice the size, overflow 0; config 1 within 1 u8 of its
    plain chain's box average.  checkpoint: save_scene mid-orbit, load_scene
    onto the card, the next frame bit-equal.  debug_layer: one flagship frame
    under the scope raises nothing and equals the frame outside it."""
    import numpy as np
    import torch

    from d3d12_deferred_renderer_tpu_torch.runtime import App, NativeFrameSink, PresentQueue, native_sink_available
    from d3d12_deferred_renderer_tpu_torch.scene_io import load_scene, save_scene
    from d3d12_deferred_renderer_tpu_torch.utils import debug_layer, read_png

    total = {k.__name__: 0 for k in wrappers}
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)

    def drive(fn):
        """fn() with every launch count set to 0 just before and read just
        after: (its result, {wrapper: launches})."""
        reset_launches(wrappers)
        out = fn()
        got = {k.__name__: k.launches for k in wrappers}
        for k, n in got.items():
            total[k] += n
        return out, got

    def expect_launches(part, got, per_frame, frames):
        want = {k.__name__: 0 for k in wrappers}
        want.update({k: frames * n for k, n in per_frame.items()})
        check(got == want, f"app {part}: launches {got}, expected {want}")

    flagship = {"setup_triangles": 1, "fused_tiles": 1}
    # App.run and render_batch replay step_frame_jit's graph, captured by
    # the warm-up App below: the wrappers launch nothing after it.
    graphed = {}

    def host_timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The reference: a separate step_frame loop from the same state.
    def step_loop():
        frames, states, s = [], [], state0
        for _ in range(APP_FRAMES):
            s, f = tp.step_frame(s, cfg)
            frames.append(f)
            states.append(s)
        return frames, states

    tp.step_frame_jit.cache_clear()
    App(state0, cfg).run(4)  # warm-up: the graph's capture, the caching host allocator's pinned blocks
    (ref, ref_states), got = drive(step_loop)
    expect_launches("step_frame loop", got, flagship, APP_FRAMES)
    ref_host = [f.cpu().numpy() for f in ref]

    def check_presented(part, kw):
        """One App run that keeps every presented frame: each equal to the
        reference's, in order.  Returns the queue."""
        presented = []
        with App(state0, cfg, present_callback=lambda i, f: presented.append((i, f)), **kw) as app:
            app.run(APP_FRAMES)
        check([i for i, _ in presented] == list(range(APP_FRAMES)), f"app {part}: presented out of order")
        check(all(np.array_equal(f, r) for (_, f), r in zip(presented, ref_host)),
              f"app {part}: a presented frame differs from step_frame's")
        check(app.queue.frames_presented == APP_FRAMES and app.queue.in_flight == 0, f"app {part}: not drained")
        return app.queue

    # The timed loops drop their frames, as a consumer that writes them out
    # would (so the caching host allocator recycles the pinned blocks), and
    # run in turns, 3 rounds, the same APP_FRAMES frames each; render_batch
    # keeps its stacked frames on the card.
    def unpresented():
        s = state0
        for _ in range(APP_FRAMES):
            s, _ = tp.step_frame(s, cfg)

    def sync_readback():
        s = state0
        for _ in range(APP_FRAMES):
            s, f = tp.step_frame(s, cfg)
            f.cpu()

    def app_loop(**kw):
        def run():
            with App(state0, cfg, **kw) as app:
                app.run(APP_FRAMES)
        return run

    def present_queue_eager():  # App.run's loop before step_frame_jit
        q, s = PresentQueue(depth=cfg.frames_in_flight), state0
        for _ in range(APP_FRAMES):
            s, f = tp.step_frame(s, cfg)
            q.push(f)
        list(q.drain())

    def render_batch_eager():  # render_batch before step_frame_jit
        s, frames = state0, []
        for _ in range(APP_FRAMES):
            s, f = tp.step_frame(s, cfg)
            frames.append(f)
        return s, torch.stack(frames)

    loops = {"unpresented": (unpresented, flagship), "present_queue": (app_loop(), graphed),
             "present_queue_eager": (present_queue_eager, flagship), "sync_readback": (sync_readback, flagship),
             "delta_queue": (app_loop(delta_present=True), graphed),
             "render_batch": (lambda: tp.render_batch(state0, cfg, APP_FRAMES), graphed),
             "render_batch_eager": (render_batch_eager, flagship)}
    ms = {name: [] for name in loops}
    for _ in range(3):
        for name, (fn, per_frame) in loops.items():
            (_, got), secs = host_timed(lambda: drive(fn))
            expect_launches(name, got, per_frame, APP_FRAMES)
            ms[name].append(secs * 1e3 / APP_FRAMES)
    best = {name: min(v) for name, v in ms.items()}

    host = torch.empty(ref[0].shape, dtype=torch.uint8, pin_memory=True)
    d2h_ms = cuda_ms(lambda: host.copy_(ref[0], non_blocking=True), 20)

    queue, got = drive(lambda: check_presented("present", {}))
    expect_launches("present", got, graphed, APP_FRAMES)
    emit({"phase": "app", "ok": True, "part": "present", "resolution": f"{cfg.width}x{cfg.height}",
          "frames": APP_FRAMES, "depth": cfg.frames_in_flight, "bit_equal_to_step_frame": True,
          "delivered_fps": 1e3 / best["present_queue"], "delivered_fps_eager": 1e3 / best["present_queue_eager"],
          "unpresented_fps": 1e3 / best["unpresented"],
          "sync_readback_fps": 1e3 / best["sync_readback"], "ms_per_frame_rounds": ms,
          "d2h_ms_per_frame": d2h_ms, "d2h_gb_per_s": ref[0].numel() / d2h_ms / 1e6,
          "frame_mib": ref[0].numel() / 2**20,
          "timing": f"host clock around {APP_FRAMES} frames (App.run with its drain, graph replays; the same "
                    "loop of step_frame calls into a PresentQueue; a step_frame loop; one "
                    "reading every frame back with .cpu()), each ending in a synchronise, presented frames "
                    "dropped; 3 rounds in turns, FPS from the best; device-to-host by CUDA events over 20 "
                    "copies into one pinned buffer"})

    queue, got = drive(lambda: check_presented("delta", {"delta_present": True}))
    expect_launches("delta", got, graphed, APP_FRAMES)
    emit({"phase": "app", "ok": True, "part": "delta", "frames": APP_FRAMES, "bit_equal_to_step_frame": True,
          "delivered_fps": 1e3 / best["delta_queue"],
          "bytes_transferred": queue.bytes_transferred, "bytes_full": queue.bytes_full,
          "bytes_ratio": queue.bytes_transferred / queue.bytes_full, "transfer_misses": queue.transfer_misses,
          "tiles": queue.NT, "tile": f"{queue.th}x{queue.tw}"})

    check(native_sink_available(), "app sink: the native frame sink library could not be built")
    n_sink = 8
    with tempfile.TemporaryDirectory(dir=build_dir) as out_dir:
        def run_sink():
            with NativeFrameSink(out_dir, cfg.width, cfg.height, 3, num_threads=4) as sink:
                stats = App(state0, cfg, present_callback=sink.as_present_callback()).run(n_sink)
                sink.flush()
                return stats, sink.frames_written, sink.errors
        ((stats, written, errors), got), sink_s = host_timed(lambda: drive(run_sink))
        expect_launches("sink", got, graphed, n_sink)
        check(written == n_sink and errors == 0, f"app sink: {written} frames written, {errors} errors")
        for i in range(n_sink):
            check(np.array_equal(read_png(os.path.join(out_dir, f"frame_{i:05d}.png")), ref_host[i]),
                  f"app sink: frame {i} read back differs")
    emit({"phase": "app", "ok": True, "part": "sink", "frames": n_sink, "pngs_equal": True, "threads": 4,
          "launches": {k: v for k, v in got.items() if v},
          "delivered_fps_with_flush": n_sink / sink_s, "app_run_fps": stats.fps})

    (final, frames), got = drive(lambda: tp.render_batch(state0, cfg, 4))
    expect_launches("render_batch", got, graphed, 4)
    check(frames.shape == (4, cfg.height, cfg.width, 3)
          and all(torch.equal(frames[i], ref[i]) for i in range(4)), "app render_batch: frames differ")
    check(torch.equal(final.time, ref_states[3].time), "app render_batch: final clock differs")
    emit({"phase": "app", "ok": True, "part": "render_batch", "frames": 4, "bit_equal_to_step_frame": True,
          "ms_per_frame": best["render_batch"], "ms_per_frame_eager": best["render_batch_eager"]})

    for label, base_cfg, state, per_frame in (
        ("config1", c1_cfg, tp.animate(c1_state0, 0.3, c1_cfg), {"setup_triangles": 1, "raster_tiles": 1}),
        ("fused_flagship", cfg, ref_states[0], flagship),
    ):
        ss_cfg = dataclasses.replace(base_cfg, supersample=2)
        hi_cfg = dataclasses.replace(base_cfg, width=2 * base_cfg.width, height=2 * base_cfg.height)
        (res, got) = drive(lambda: tp.render_stats(state, ss_cfg))
        frame, ovf = res[0], int(res[1]["overflow"])
        expect_launches(f"supersample {label}", got, per_frame, 1)
        hi, hi_stats = tp.render_stats(state, hi_cfg)
        check(ovf == 0 and int(hi_stats["overflow"]) == 0, f"app supersample {label}: overflow {ovf}")
        check(frame.shape == (base_cfg.height, base_cfg.width, 3) and torch.equal(frame, box_average(hi, 2)),
              f"app supersample {label}: frame is not the box average of the {hi_cfg.width}x{hi_cfg.height} frame")
        line = {"phase": "app", "ok": True, "part": "supersample", "config": label, "supersample": 2,
                "rendered_at": f"{hi_cfg.width}x{hi_cfg.height}", "bit_equal_to_box_average": True,
                "overflow": ovf, "launches": {k: v for k, v in got.items() if v},
                "ms_per_frame": cuda_ms(lambda: tp.render(state, ss_cfg), 10),
                "plain_size_ms_per_frame": cuda_ms(lambda: tp.render(state, base_cfg), 10)}
        if label == "config1":
            plain, plain_ovf, _ = staged_plain_chain(state, hi_cfg)
            st = frame_stats(frame, box_average(plain, 2))
            check(st["max_u8"] <= 1 and int(plain_ovf) == 0, f"app supersample {label}: vs plain chain {st}")
            line["vs_plain_chain"] = st
        emit(line)

    mid = ref_states[6]
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt_dir:
        path = os.path.join(ckpt_dir, "scene.npz")
        save_scene(path, mid)
        restored = load_scene(path, state0)
        ckpt_bytes = os.path.getsize(path)
    check(restored.time.device == mid.time.device, "app checkpoint: not loaded onto the card")
    check(torch.equal(tp.step_frame(restored, cfg)[1], ref[7]), "app checkpoint: the next frame differs")
    emit({"phase": "app", "ok": True, "part": "checkpoint", "bytes": ckpt_bytes, "resumed_frame_bit_equal": True})

    state = ref_states[0]
    with debug_layer():
        debug_frame, debug_s = host_timed(lambda: tp.render(state, cfg))
    plain_frame, plain_s = host_timed(lambda: tp.render(state, cfg))
    check(torch.equal(debug_frame, plain_frame), "app debug_layer: the frame differs under the scope")
    emit({"phase": "app", "ok": True, "part": "debug_layer", "raised": False, "ms": debug_s * 1e3,
          "ms_outside_the_scope": plain_s * 1e3})
    return total


# The window phase: the three config-4 paths with the window-gather PCF
# (shadow_window_gather), each as (label, config changes from the flagship,
# wrapper launches a frame).
WINDOW_PATHS = (
    ("config4_fused_split", dict(fused=True, **CONFIG4_FLAGS),
     {"setup_triangles": 1, "setup_depth_triangles": 1, "raster_depth": 1, "fused_tiles": 1,
      "directional_resolve": 1}),
    ("config4_fused_unsplit", dict(fused=True, **CONFIG4_UNSPLIT_FLAGS),
     {"setup_triangles": 1, "setup_depth_triangles": 1, "raster_depth": 2, "fused_tiles": 1}),
    ("config4_staged", dict(fused=False, **CONFIG4_FLAGS),
     {"setup_triangles": 1, "raster_tiles": 1, "bump_tiles": 1, "setup_depth_triangles": 1,
      "raster_depth": 1, "shade_tiles": 1}),
)
WINDOW_SWEEP_STEPS, WINDOW_SAMPLE_EVERY, WINDOW_TIMED_FRAMES, WINDOW_PROFILED_FRAMES = 64, 4, 30, 2


class CallSpy:
    """Stands in for function `name` in `modules` (each module that calls
    it by that name): calls it, runs `on_call(args, kwargs)` first and keeps
    the last call's arguments.  restore() puts the function back."""

    def __init__(self, modules, name, on_call=None):
        self.modules, self.name, self.on_call, self.last = modules, name, on_call, None
        self.fn = getattr(modules[0], name)
        for m in modules:
            setattr(m, name, self)

    def __call__(self, *args, **kwargs):
        if self.on_call is not None:
            self.on_call(args, kwargs)
        self.last = (args, kwargs)
        return self.fn(*args, **kwargs)

    def restore(self) -> None:
        for m in self.modules:
            setattr(m, self.name, self.fn)


def window_phase(tp, state0, wrappers, card: str) -> dict:
    """The window-gather PCF on the three config-4 paths at 1920x1080 (1024^2
    shadow map, the flagship scene), each run with every launch count set
    to 0 just before it and read just after; returns the launches summed
    over the paths.  For each path: at every 4th step of the 64-step yaw
    orbit, step_frame with shadow_window_gather equal (torch.equal) to
    step_frame without it from the same state, and render_stats' overflow
    0 (a state that overflows has its count held against the plain chain's
    and recorded instead); the largest bad-quad count over those steps
    beside the automatic cap; the last frame's visibility inputs through
    shadow_visibility on the card bit-equal to the card's quad path, and
    on the first path to the CPU's; overflow >= 1 through render_stats at
    shadow_bad_quads_cap 8; ms/frame of the flag on and off in turns (best
    of 3 passes of 30 step_frame calls), CUDA launches and device busy ms
    a frame (torch.profiler over 2 frames each), and shadow_visibility's
    device ms alone from CUDA-graph replays, on and off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d3d12_deferred_renderer_tpu_torch.ops import fused, shadows

    total = {k.__name__: 0 for k in wrappers}
    cpu_checked = None
    for label, changes, per_frame in WINDOW_PATHS:
        t_path, seconds = time.perf_counter(), {}
        off = dataclasses.replace(tp.FLAGSHIP_CONFIG, **changes)
        on = dataclasses.replace(off, shadow_window_gather=True)
        counts = []  # (bad quads, quads) of each window-row call
        count_spy = CallSpy([shadows], "_pcf_window_rows", lambda a, k: counts.append(
            (shadows.window_quads(a[0], a[1], k.get("tile_w", 128))[-1].sum(), a[2].numel() // 4)))
        vis_spy = CallSpy([tp.frame, fused], "shadow_visibility")
        try:
            reset_launches(wrappers)
            frames, state, sampled, equal, overflow = 0, state0, [], [], []
            for i in range(WINDOW_SWEEP_STEPS):
                state = tp.animate(state, 2.0 * math.pi / WINDOW_SWEEP_STEPS, off)
                if i % WINDOW_SAMPLE_EVERY != WINDOW_SAMPLE_EVERY - 1:
                    continue
                nxt, f_on = tp.step_frame(state, on)
                _, f_off = tp.step_frame(state, off)
                _, stats = tp.render_stats(nxt, on)
                frames += 3
                sampled.append((i, state))
                equal.append(torch.equal(f_on, f_off))
                overflow.append(stats["overflow"])
            launches = {k.__name__: k.launches for k in wrappers}
            for k, n in launches.items():
                total[k] += n
            expect = {**{k.__name__: 0 for k in wrappers}, **{k: n * frames for k, n in per_frame.items()}}
            check(launches == expect, f"window {label}: launch counts {launches}, expected {expect}")
            overflow = [int(o) for o in torch.stack(overflow)]
            bad = [int(c) for c, _ in counts]
            quads = counts[0][1]
            auto_cap = min(max(8, -(-(quads // 8) // 8) * 8), quads)
            over = {}
            for (i, s), eq, ovf in zip(sampled, equal, overflow):
                if ovf == 0:
                    check(eq, f"window {label}: step {i}: the frame differs from the quad path's")
                    continue
                # Overflowing bad quads blend zero taps: the frame may differ.
                # Hold the count against the plain chain at that state.
                s1 = tp.animate(s, on.yaw_per_frame, on)
                plain = (fused_plain_chain(s1, on) if on.fused else staged_plain_chain(s1, on, shade=False))[1]
                check(int(plain) == ovf, f"window {label}: step {i}: overflow {ovf} != plain chain's {int(plain)}")
                over[i] = ovf
            # The last frame's visibility inputs: the card against the CPU
            # and against the card's quad path.
            args, kwargs = vis_spy.last
        finally:
            count_spy.restore()
            vis_spy.restore()
        seconds["sweep"] = time.perf_counter() - t_path
        t0 = time.perf_counter()
        depth, vp, sd, lvp = args[:4]
        v_on, o_on = shadows.shadow_visibility(depth, vp, sd, lvp, on, **{**kwargs, "return_overflow": True})
        v_off = shadows.shadow_visibility(depth, vp, sd, lvp, off, **{**kwargs, "return_overflow": False})
        check(torch.equal(v_on, v_off) or int(o_on) > 0,
              f"window {label}: the window visibility differs from the quad path's")
        if cpu_checked is None:  # one frame's inputs (the first path's) on the CPU
            cpu_kw = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kwargs.items()}
            v_cpu, o_cpu = shadows.shadow_visibility(depth.cpu(), vp.cpu(), sd.cpu(), lvp.cpu(), on,
                                                     **{**cpu_kw, "return_overflow": True})
            check(torch.equal(v_on.cpu(), v_cpu) and int(o_on) == int(o_cpu),
                  f"window {label}: the card's window visibility differs from the CPU's")
            cpu_checked = label
        reset_launches(wrappers)
        _, loud = tp.render_stats(sampled[-1][1], dataclasses.replace(on, shadow_bad_quads_cap=8))
        for k, n in ((k.__name__, k.launches) for k in wrappers):
            total[k] += n
        check(int(loud["overflow"]) >= 1, f"window {label}: no overflow at shadow_bad_quads_cap 8")
        graph = {flag: graph_ms(lambda c=c: shadows.shadow_visibility(depth, vp, sd, lvp, c, **kwargs), 20)
                 for flag, c in (("off", off), ("on", on))}
        seconds["checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # ms/frame, flag off and on in turns (the order swapped each pass).
        passes = {"off": [], "on": []}
        reset_launches(wrappers)
        for p in range(3):
            for flag in (("off", "on") if p % 2 == 0 else ("on", "off")):
                c, s = (on if flag == "on" else off), state0
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(WINDOW_TIMED_FRAMES):
                    s, _ = tp.step_frame(s, c)
                end.record()
                torch.cuda.synchronize()
                passes[flag].append(start.elapsed_time(end) / WINDOW_TIMED_FRAMES)
        prof = {}
        for flag, c in (("off", off), ("on", on)):
            s = state0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
                for _ in range(WINDOW_PROFILED_FRAMES):
                    s, _ = tp.step_frame(s, c)
                torch.cuda.synchronize()
            avgs = pr.key_averages()
            busy_us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in avgs
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            count = {e.key: e.count for e in avgs}
            prof[flag] = {"cuda_launches": count.get("cudaLaunchKernel", 0) / WINDOW_PROFILED_FRAMES,
                          "device_busy_ms": busy_us / 1e3 / WINDOW_PROFILED_FRAMES}
        seconds["timing"] = time.perf_counter() - t0
        for k, n in ((k.__name__, k.launches) for k in wrappers):
            total[k] += n
        emit({
            "phase": "window", "ok": True, "config": label, "card": card,
            "resolution": f"{on.width}x{on.height}", "shadow_map": on.shadow_map_size,
            "tile_slots": quads // 256, "quads": quads, "auto_bad_quads_cap": auto_cap,
            "sampled_steps": [i for i, _ in sampled], "frames_bit_equal": sum(equal),
            "sampled_overflow": overflow, "bad_quads": bad, "max_bad_quads": max(bad),
            "overflowing_steps": over, "card_vs_cpu_bit_equal": cpu_checked,
            "cap_8_overflow": int(loud["overflow"]),
            "ms_per_frame": {f: min(v) for f, v in passes.items()}, "passes_ms": passes,
            "launches_per_frame": {f: prof[f]["cuda_launches"] for f in prof},
            "device_busy_ms_per_frame": {f: prof[f]["device_busy_ms"] for f in prof},
            "visibility_device_ms": graph, "seconds": {**seconds, "all": time.perf_counter() - t_path},
        })
    return total


# The graph phase: step_frame_jit on each main path, as (label, config
# (None: config 1), the scene ("flagship" or "config1"), wrapper launches a
# frame).
GRAPH_PATHS = (
    ("fused_flagship", dict(fused=True), "flagship", {"setup_triangles": 1, "fused_tiles": 1}),
    ("config1", {}, "config1", {"setup_triangles": 1, "raster_tiles": 1}),
    ("staged_flagship", dict(fused=False), "flagship", {"setup_triangles": 1, "raster_tiles": 1, "shade_tiles": 1}),
    ("fused_listfed", dict(fused=True, inkernel_light_cull=False), "flagship",
     {"setup_triangles": 1, "raster_depth": 1, "fused_tiles": 1}),
    *((label, changes, "flagship", per_frame) for label, changes, per_frame in WINDOW_PATHS),
    ("config1_supersample2", dict(supersample=2), "config1", {"setup_triangles": 1, "raster_tiles": 1}),
    ("config4_fused_split_window", dict(fused=True, shadow_window_gather=True, **CONFIG4_FLAGS), "flagship",
     WINDOW_PATHS[0][2]),
)
GRAPH_SWEEP_STEPS, GRAPH_SAMPLE_EVERY, GRAPH_TIMED_FRAMES = 64, 4, 30
# Frames in the profiled window: an eager frame's ~400-1800 launches make
# the profiler's tables slow to build, and the counts a frame are exact.
GRAPH_PROFILED_FRAMES = {"graph": 10, "eager": 3}


def device_perspective(fov_y, aspect, z_near, z_far, device):
    """xmath.perspective_fov_lh as the port built it on the device before it
    moved to the host (three 0-dim tensors copied from the host a frame)."""
    import torch

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    h = 1.0 / torch.tan((f32(fov_y) * 0.5).double()).float()
    w = h / aspect
    zn, zf = f32(z_near), f32(z_far)
    zr = zf / (zf - zn)
    z0, z1 = f32(0.0), f32(1.0)
    return torch.stack([torch.stack([w, z0, z0, z0]), torch.stack([z0, h, z0, z0]),
                        torch.stack([z0, z0, zr, z1]), torch.stack([z0, z0, -zr * zn, z0])])


def profile_frames(step, state, cfg, frames: int) -> dict:
    """`frames` calls of step(state, cfg) under torch.profiler: host ms a
    frame around the synchronised window, the device's busy ms (kernels,
    copies and fills) and share, device kernels, copies and fills a frame,
    and the host's launches, graph launches, copies and synchronising
    calls a frame (stream and event synchronisations and synchronous copies;
    the window's closing device synchronise is not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            state, _ = step(state, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_events = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in dev_events) / 1e3
    copies = sum(e.count for e in dev_events if "memcpy" in e.key.lower())
    fills = sum(e.count for e in dev_events if "memset" in e.key.lower())
    count = {e.key: e.count for e in avgs}
    syncs = count.get("cudaStreamSynchronize", 0) + count.get("cudaEventSynchronize", 0) + count.get("cudaMemcpy", 0)
    return {"host_ms_per_frame": wall_ms / frames, "device_busy_ms_per_frame": busy_ms / frames,
            "busy_share": busy_ms / wall_ms,
            "device_kernels_per_frame": (sum(e.count for e in dev_events) - copies - fills) / frames,
            "device_copies_per_frame": copies / frames, "device_fills_per_frame": fills / frames,
            "cuda_launch_kernel_per_frame": count.get("cudaLaunchKernel", 0) / frames,
            "cuda_graph_launch_per_frame": count.get("cudaGraphLaunch", 0) / frames,
            "cuda_memcpy_async_per_frame": count.get("cudaMemcpyAsync", 0) / frames,
            "synchronising_calls_per_frame": syncs / frames}


def graph_phase(tp, state0, c1_state0, wrappers, card: str) -> dict:
    """step_frame_jit on the seven main paths, supersample=2 on config 1 and
    the split config 4 with the window-gather PCF, at full size (1920x1080
    on the flagship scene, config 1 at 1280x720), each run with every launch
    count set to 0 just before its capture and read just after (the
    warm-up frame and the capture: 2 a frame's launches; a replay launches
    through no wrapper); returns those launches summed over the paths.  For
    each path: the host-built perspective matrix bit-equal to the device
    build it replaces; the capture's host seconds (warm-up frame, capture,
    first replay) and the graph's private pool in MiB (reserved bytes over
    the capture); at every 4th of the 64 orbit steps step_frame_jit bit-equal
    to step_frame, frame and state, with no wrapper launch and the graph's
    overflow count 0; ms/frame graphed and eager in turns (best of 3 passes
    of 30 frames, CUDA events and the host clock); one profiled window of 10
    graphed and 3 eager frames (device busy ms and share, device kernels,
    copies and synchronising calls a frame).  Then JAX's overflow warning, printed once
    per offending frame under replay."""
    import contextlib
    import io

    import torch

    from d3d12_deferred_renderer_tpu_torch import frame as tframe
    from d3d12_deferred_renderer_tpu_torch import xmath

    dev = state0.time.device
    total = {k.__name__: 0 for k in wrappers}
    leaves = tframe._leaves
    for label, changes, scene, per_frame in GRAPH_PATHS:
        t_path = time.perf_counter()
        base = tp.REFERENCE_CONFIG if scene == "config1" else tp.FLAGSHIP_CONFIG
        cfg = dataclasses.replace(base, **changes)
        state = c1_state0 if scene == "config1" else state0
        args = (cfg.fov_y, cfg.aspect, cfg.z_near, cfg.z_far)
        persp = xmath.perspective_fov_lh(*args, device=dev)
        check(torch.equal(persp.view(torch.int32), device_perspective(*args, dev).view(torch.int32)),
              f"graph {label}: the host-built perspective matrix differs from the device build")
        tp.step_frame_jit.cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        reset_launches(wrappers)
        t0 = time.perf_counter()
        tp.step_frame_jit(state, cfg)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in wrappers}
        for k, n in launches.items():
            total[k] += n
        expect = {**{k.__name__: 0 for k in wrappers}, **{k: 2 * n for k, n in per_frame.items()}}
        check(launches == expect, f"graph {label}: launches at capture {launches}, expected {expect}")
        pool_mib = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        (graph,) = tframe._graphs.values()

        sampled, overflow, s = [], [], state
        for i in range(GRAPH_SWEEP_STEPS):
            s = tp.animate(s, 2.0 * math.pi / GRAPH_SWEEP_STEPS, cfg)
            if i % GRAPH_SAMPLE_EVERY != GRAPH_SAMPLE_EVERY - 1:
                continue
            reset_launches(wrappers)
            g_state, g_frame = tp.step_frame_jit(s, cfg)
            overflow.append(graph.overflow.clone())
            check(all(k.launches == 0 for k in wrappers), f"graph {label}: step {i}: a wrapper launched")
            e_state, e_frame = tp.step_frame(s, cfg)
            check(torch.equal(g_frame, e_frame), f"graph {label}: step {i}: the frame differs from step_frame's")
            check(all(torch.equal(a, b) for a, b in zip(leaves(g_state), leaves(e_state))),
                  f"graph {label}: step {i}: the state differs from step_frame's")
            sampled.append(i)
        overflow = [int(o) for o in torch.stack(overflow)]
        check(max(overflow) == 0, f"graph {label}: overflow {overflow}")
        covered = float((g_frame.amax(-1) > 0).double().mean())
        check(covered > 0.02, f"graph {label}: frame nearly blank")

        passes = {"graph": [], "eager": []}
        host = {"graph": [], "eager": []}
        for p in range(3):
            for mode in (("graph", "eager") if p % 2 == 0 else ("eager", "graph")):
                step = tp.step_frame_jit if mode == "graph" else tp.step_frame
                s = state
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                for _ in range(GRAPH_TIMED_FRAMES):
                    s, _ = step(s, cfg)
                end.record()
                torch.cuda.synchronize()
                passes[mode].append(start.elapsed_time(end) / GRAPH_TIMED_FRAMES)
                host[mode].append((time.perf_counter() - t0) * 1e3 / GRAPH_TIMED_FRAMES)
        prof = {mode: profile_frames(step, state, cfg, GRAPH_PROFILED_FRAMES[mode])
                for mode, step in (("graph", tp.step_frame_jit), ("eager", tp.step_frame))}
        check(prof["graph"]["synchronising_calls_per_frame"] == 0,
              f"graph {label}: synchronising calls inside the graphed frame: {prof['graph']}")
        emit({
            "phase": "graph", "ok": True, "path": label, "card": card,
            "resolution": f"{cfg.width}x{cfg.height}" + (f" x{cfg.supersample}" if cfg.supersample > 1 else ""),
            "perspective_bit_equal": True, "capture_s": capture_s, "pool_mib": pool_mib,
            "launches_at_capture": {k: n for k, n in launches.items() if n},
            "sampled_steps": sampled, "frames_bit_equal": len(sampled), "graph_overflow": overflow,
            "covered_frac": covered,
            "ms_per_frame": {m: min(v) for m, v in passes.items()}, "passes_ms": passes, "passes_host_ms": host,
            "profile": prof, "seconds": time.perf_counter() - t_path,
        })
        del graph
        tp.step_frame_jit.cache_clear()
        torch.cuda.empty_cache()

    # JAX's overflow warning under replay: one triangle a tile overflows.
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=1)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device=dev)
    counts, s = [], state
    for _ in range(3):
        s = tp.animate(s, cfg.yaw_per_frame, cfg)
        counts.append(int(tp.render_stats(s, cfg)[1]["overflow"]))
    torch.cuda.synchronize()
    tframe._pending_overflow.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for _ in range(3):
            state, _ = tp.step_frame_jit(state, cfg)
            torch.cuda.synchronize()
    want = "".join(tframe.OVERFLOW_WARNING.format(n=n) + "\n" for n in counts[:2])
    check(min(counts) > 0 and out.getvalue() == want, f"graph warning: printed {out.getvalue()!r}, wanted {want!r}")
    emit({"phase": "graph", "ok": True, "part": "overflow_warning", "frame_overflows": counts,
          "warnings_printed": out.getvalue().count("WARNING"), "pending": len(tframe._pending_overflow)})
    tframe._pending_overflow.clear()
    tp.step_frame_jit.cache_clear()
    return total


def band_kernel_phase(tp, state, dev, kernels) -> None:
    """The band kernels on the flagship frame (1920x1080): K6 and K3 on the
    middle band of 3 (rows 360-719) and the second band of 4 (rows 270-539,
    a padded last tile row), K7 on each band's G-buffer, K2 (in-kernel
    cull; lists + visibility + bump) and K8 (on K6's planes, row offset
    y0) on the band of whole tiles.  Each against its plain version on the
    same band inputs (K6 planes, K7 HDR and K8 planes bit for bit as int32,
    K3 torch.equal, K2 within 1 u8 on < 1% of pixels and equal tile
    overflow) and against the same rows of the full-frame
    kernel (bit for bit as int32 on the band of whole tiles; K6 and K3 on
    both bands; K7 on the 270-row band within 1 u8 on < 1%: its band-local
    tiles cull their own lights).  Device ms from graph replays, band beside
    full frame; one line each, and the kernels line's band entries."""
    import torch
    import torch.nn.functional as F

    from d3d12_deferred_renderer_tpu_torch.ops import bump, fused, lighting, lighting_cuda, post, raster_tiles, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.gbuffer import encode_gbuffer
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

    i32 = torch.int32
    scfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=False)
    fcfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    c4u = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True, **CONFIG4_UNSPLIT_FLAGS)
    H, W, TH, TW = scfg.height, scfg.width, scfg.tile_h, scfg.tile_w
    ntx = -(-W // TW)
    li, L = state.lights, state.lights.num_point
    tris, view_proj = setup_frame_triangles(state, scfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    lt, mats = fused.build_light_table(li), fused.build_material_table(state.materials, fcfg.gamma)
    cap = min(L, scfg.max_live_lights_per_tile)
    sd, lvp = shadows.render_shadow_map(state, c4u)
    dense = dataclasses.replace(c4u, shadow_tiles_cap=0)

    def grid(bh):
        return dict(nty=-(-bh // TH), ntx=ntx, tile_h=TH, tile_w=TW)

    def k7_inputs(gb, y0, bh):
        tl = lighting.cull_lights_to_tiles(gb.depth, li, scfg, view_proj, tile=(TH, TW), max_per_tile=cap,
                                           inv_vp=inv_vp, y_offset=y0, full_height=H)
        g = grid(bh)
        NT = g["nty"] * ntx
        return (lighting_cuda.gbuffer_planes(gb, g["nty"] * TH, ntx * TW), lt, tl.indices.reshape(NT, -1),
                tl.counts.reshape(NT), lighting_cuda.make_uniforms(state.camera.eye, li, scfg, inv_vp, W, H, y0)), tl

    def k2_inputs_band(b, y0, bh, lists):
        """The tile renderer's arguments on a band: in-kernel cull, or the
        prepass lists + dense PCF visibility + bump (config 4 unsplit)."""
        g = grid(bh)
        args = (b.counts, b.offs, b.stream, lt, mats,
                lighting_cuda.make_uniforms(state.camera.eye, li, fcfg, inv_vp, W, H, y0))
        kw = dict(g, n_lights=L, ik_slots=fused.live_light_slots(fcfg, L), gamma=fcfg.gamma, hdr_out=True)
        if lists:
            depth_pre = raster_tiles.raster_depth(b.counts, b.offs, b.stream, **g, y0=y0)[:bh]
            tl = lighting.cull_lights_to_tiles(depth_pre, li, c4u, view_proj, tile=(TH, TW), max_per_tile=cap,
                                               inv_vp=inv_vp, y_offset=y0, full_height=H)
            vis = shadows.shadow_visibility(depth_pre, view_proj, sd, lvp, dense, inv_vp=inv_vp, y_offset=y0,
                                            full_height=H)
            NT = g["nty"] * ntx
            kw.update(ik_slots=0, light_ids=fused.pad_light_ids_to_chunk(tl.indices.reshape(NT, -1)),
                      light_counts=tl.counts.reshape(NT), bump=(c4u.bump_strength, c4u.bump_frequency),
                      vis=F.pad(vis, (0, ntx * TW - W, 0, g["nty"] * TH - bh), value=1.0))
        return args, kw

    # The full frame's kernels, whose rows the bands are held to.
    fb = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg)
    fbargs = (fb.counts, fb.offs, fb.stream)
    fplanes = raster_tiles.raster_tiles(*fbargs, **grid(H))
    fdepth = raster_tiles.raster_depth(*fbargs, **grid(H))
    fgb = encode_gbuffer(raster_tiles.fragments_from_planes(fplanes, H, W), state.materials, scfg)
    fk7, _ = k7_inputs(fgb, 0, H)
    skw = dict(grid(H), gamma=scfg.gamma)
    fhdr = lighting_cuda.shade_tiles(*fk7, **skw)
    fk2 = {lists: k2_inputs_band(fb, 0, H, lists) for lists in (False, True)}
    fcolor = {lists: fused.fused_tiles(*a, **k)[0] for lists, (a, k) in fk2.items()}
    bkw = dict(width=W, height=H, tile_h=TH, tile_w=TW, strength=c4u.bump_strength, freq=c4u.bump_frequency)
    fbumped = bump.bump_tiles(fplanes.clone(), inv_vp, **bkw)
    fwork = fplanes.clone()
    full_ms = {"k6": graph_ms(lambda: raster_tiles.raster_tiles(*fbargs, **grid(H)), 20),
               "k3": graph_ms(lambda: raster_tiles.raster_depth(*fbargs, **grid(H)), 20),
               "k7": graph_ms(lambda: lighting_cuda.shade_tiles(*fk7, **skw), 20),
               "k2": graph_ms(lambda: fused.fused_tiles(*fk2[False][0], **fk2[False][1]), 20),
               "k8": graph_ms(lambda: bump.bump_tiles(fwork, inv_vp, **bkw), 20)}

    # The middle band of 3 and the second of 4: at 1080 rows, rows 360-719
    # and 270-539.
    for y0, bh in ((H // 3, H // 3), (H // 4, H // 4)):
        whole = bh % TH == 0
        g = grid(bh)
        NT = g["nty"] * ntx
        b = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg, bh, y0)
        bargs = (b.counts, b.offs, b.stream)
        planes = raster_tiles.raster_tiles(*bargs, **g, y0=y0)
        pplanes = raster_tiles.raster_tiles_reference(*bargs, **g, y0=y0)
        depth = raster_tiles.raster_depth(*bargs, **g, y0=y0)
        pdepth = raster_tiles.raster_depth_reference(*bargs, **g, y0=y0)
        torch.cuda.synchronize()
        off = (planes.view(i32) != pplanes.view(i32)).sum((1, 2)).tolist()
        check(not any(off), f"K6 band {y0}+{bh} not bit-equal to its plain version: elements off {off}")
        check(torch.equal(planes[:, :bh].view(i32), fplanes[:, y0 : y0 + bh].view(i32)),
              f"K6 band {y0}+{bh} differs from the full frame's rows")
        check(torch.equal(depth, pdepth), f"K3 band {y0}+{bh} differs from its plain version")
        check(torch.equal(depth[:bh].view(i32), fdepth[y0 : y0 + bh].view(i32)),
              f"K3 band {y0}+{bh} differs from the full frame's rows")
        check(int(b.overflow) == 0, f"band {y0}+{bh} binning overflow {int(b.overflow)}")
        covered = float((planes[raster_tiles.PLANE_MID, :bh] >= 0).double().mean())
        check(covered > 0.02, f"band {y0}+{bh} nearly empty ({covered})")

        gb = encode_gbuffer(raster_tiles.fragments_from_planes(planes, bh, W), state.materials, scfg)
        sargs, tl = k7_inputs(gb, y0, bh)
        bskw = dict(g, gamma=scfg.gamma)
        hdr = lighting_cuda.shade_tiles(*sargs, **bskw)
        phdr = lighting_cuda.shade_tiles_reference(*sargs, **bskw)
        torch.cuda.synchronize()
        off7 = int((hdr.view(i32) != phdr.view(i32)).sum())
        check(off7 == 0, f"K7 band {y0}+{bh} differs from its plain version on {off7} values")
        check(int(tl.overflow) == 0, f"K7 band {y0}+{bh} light overflow {int(tl.overflow)}")
        img = [u8(post.apply_post(h[:, :bh].permute(1, 2, 0), scfg)) for h in (hdr, fhdr[:, y0 : y0 + bh])]
        k7_rows = frame_stats(*img)
        if whole:
            check(torch.equal(hdr.view(i32), fhdr[:, y0 : y0 + bh].view(i32)),
                  f"K7 band {y0}+{bh} differs from the full frame's rows")
        else:
            check(k7_rows["max_u8"] <= 1 and k7_rows["frac_diff"] < 0.01,
                  f"K7 band {y0}+{bh} vs the full frame's rows: {k7_rows}")
        line = {"phase": "bands_kernels", "ok": True, "band": f"rows {y0}-{y0 + bh - 1}",
                "whole_tiles": whole, "binned_pairs": int(b.counts.sum()), "covered_frac": covered,
                "k6": {"bit_equal_to_plain": True, "bit_equal_to_full_rows": True},
                "k3": {"equal_to_plain": True, "bit_equal_to_full_rows": True,
                       "neg_zero_in_plain": int((pdepth.view(i32) == -2**31).sum())},
                "k7": {"bit_equal_to_plain": True, "vs_full_rows": k7_rows,
                       "max_live_lights_in_a_tile": int(tl.counts.max())}}
        if whole:
            # K8 on the band's raster planes, its row offset y0: every plane
            # bit for bit against its plain version and the full frame's rows.
            bb = bump.bump_tiles(planes.clone(), inv_vp, y0=y0, **bkw)
            pbb = bump.bump_tiles_reference(planes.clone(), inv_vp, y0=y0, **bkw)
            torch.cuda.synchronize()
            check(torch.equal(bb.view(i32), pbb.view(i32)), f"K8 band {y0}+{bh} differs from its plain version")
            check(torch.equal(bb.view(i32), fbumped[:, y0 : y0 + bh].view(i32)),
                  f"K8 band {y0}+{bh} differs from the full frame's rows")
            b_moved = float((bb[1:4] != planes[1:4]).any(0).double().mean())
            check(b_moved > 0.1, f"K8 band {y0}+{bh} perturbed only {b_moved} of the pixels")
            line["k8"] = {"bit_equal_to_plain": True, "bit_equal_to_full_rows": True, "perturbed_frac": b_moved}
            bwork = planes.clone()
            line["k2"] = {}
            for lists in (False, True):
                args, kw = k2_inputs_band(b, y0, bh, lists)
                color, tovf = fused.fused_tiles(*args, **kw)
                pcolor, ptovf, live = fused.fused_tiles_reference(*args, **kw, return_live=True)
                torch.cuda.synchronize()
                name = "lists_vis_bump" if lists else "inkernel_cull"
                check(torch.equal(tovf, ptovf) and not bool(tovf.any()), f"K2 band ({name}) tile overflow")
                st = frame_stats(*(u8(post.gamma_encode(post.reinhard(c[:, :bh]), fcfg.gamma)).permute(1, 2, 0)
                                   for c in (color, pcolor)))
                check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"K2 band ({name}) vs plain: {st}")
                check(torch.equal(color.view(i32), fcolor[lists][:, y0 : y0 + bh].view(i32)),
                      f"K2 band ({name}) differs from the full frame's rows")
                k2_err = float((color - pcolor).abs().max())
                line["k2"][name] = {"vs_plain": st, "max_abs_err": k2_err, "bit_equal_to_full_rows": True,
                                    "max_live_lights_in_a_tile": int(live.max())}
                if not lists:
                    k2args, k2kw, k2live, k2color = args, kw, live, color
        # Timings and bounds, band beside full frame.
        dev_ms = {"k6": graph_ms(lambda: raster_tiles.raster_tiles(*bargs, **g, y0=y0), 20),
                  "k3": graph_ms(lambda: raster_tiles.raster_depth(*bargs, **g, y0=y0), 20),
                  "k7": graph_ms(lambda: lighting_cuda.shade_tiles(*sargs, **bskw), 20)}
        if whole:
            dev_ms["k2"] = graph_ms(lambda: fused.fused_tiles(*k2args, **k2kw), 20)
            dev_ms["k8"] = graph_ms(lambda: bump.bump_tiles(bwork, inv_vp, y0=y0, **bkw), 20)
        line["device_ms"] = dev_ms
        line["full_frame_device_ms"] = full_ms
        emit(line)
        if not whole:
            continue
        pairs = int(b.counts.sum())
        box_px = raster_box_pixels(*bargs, ntx, TH, TW, y0)
        cov = per_tile_covered(planes[raster_tiles.PLANE_DEPTH], TH, TW)
        k6_b = bound(pairs * 128 + 4 * (2 * NT + 1) + 4 * planes.numel(), box_px * RASTER_OPS_PER_RECORD_PIXEL)
        k3_b = bound(pairs * 128 + 4 * (2 * NT + 1) + 4 * depth.numel(), box_px * RASTER_OPS_PER_RECORD_PIXEL)
        n_planes, plane = sargs[0].shape[0], sargs[0][0].numel()
        k7_pairs = int((cov * tl.counts.reshape(NT)).sum())
        k7_b = bound(4 * (plane + (n_planes - 1) * int(cov.sum()) + int(tl.counts.sum()) + NT + 32 + hdr.numel())
                     + 32 * L, int(cov.sum()) * SHADE_OPS_PER_PIXEL + k7_pairs * SHADE_OPS_PER_PIXEL_LIGHT)
        k2_b = bound(pairs * 128 + 4 * (2 * NT + 1) + 4 * (lt.numel() + mats.numel() + 32) + 4 * k2color.numel()
                     + 4 * NT, box_px * RASTER_OPS_PER_RECORD_PIXEL + int(cov.sum()) * SHADE_OPS_PER_PIXEL
                     + int((cov * k2live).sum()) * SHADE_OPS_PER_PIXEL_LIGHT)
        b_cov = int((planes[raster_tiles.PLANE_MID] >= 0).sum())
        k8_b = bound(4 * (plane + 9 * b_cov + 16), b_cov * BUMP_OPS_PER_PIXEL)
        src = "d3d12_deferred_renderer_tpu_torch/csrc/"
        tpu = "d3d12_deferred_renderer_tpu/ops/"
        for key, name, file, replaces, err, call, plain, bnd in (
            ("k6_band", "raster_tiles (band)", "raster.cu", "raster_pallas.py:956",
             float((planes - pplanes).abs().max()), lambda: raster_tiles.raster_tiles(*bargs, **g, y0=y0),
             lambda: raster_tiles.raster_tiles_reference(*bargs, **g, y0=y0), k6_b),
            ("k3_band", "raster_depth (band)", "raster.cu", "raster_pallas.py:856", 0.0,
             lambda: raster_tiles.raster_depth(*bargs, **g, y0=y0),
             lambda: raster_tiles.raster_depth_reference(*bargs, **g, y0=y0), k3_b),
            ("k7_band", "shade_tiles (band)", "shade.cu", "lighting_pallas.py:95",
             float((hdr - phdr).abs().max()), lambda: lighting_cuda.shade_tiles(*sargs, **bskw),
             lambda: lighting_cuda.shade_tiles_reference(*sargs, **bskw), k7_b),
            ("k2_band", "fused_tiles (band)", "fused.cu", "fused.py:726", line["k2"]["inkernel_cull"]["max_abs_err"],
             lambda: fused.fused_tiles(*k2args, **k2kw), lambda: fused.fused_tiles_reference(*k2args, **k2kw),
             k2_b),
            ("k8_band", "bump_tiles (band)", "bump.cu", "bump.py:196", 0.0,
             lambda: bump.bump_tiles(bwork, inv_vp, y0=y0, **bkw),
             lambda: bump.bump_tiles_reference(bwork, inv_vp, y0=y0, **bkw), k8_b),
        ):
            kernels[key] = dict(
                name=name, route="cuda", source=src + file, replaces=tpu + replaces, launches=0,
                max_abs_err=err, ms=cuda_ms(call, 20), plain_ms=cuda_ms(plain, 1), **bnd, library_ms=None,
                device_ms=dev_ms[key[:2]], full_frame_device_ms=full_ms[key[:2]], band=f"rows {y0}-{y0 + bh - 1}",
            )


def band_path_phase(tp, state0, c1_state0, dev, kernels) -> None:
    """render_sharded's paths (BAND_PATHS_3 in 3 ranks, BAND_PATHS_4 in 4)
    and the mesh paths (MESH_PATHS_3, MESH_PATHS_4) in the same spawns, the
    ranks sharing this card through a gloo group, then dryrun_multichip(4):
    each rank's launches (every kernel of the path launched once a frame),
    the summed overflow 0 at every call, the ranks' frames equal, and the
    last frames against the single-device render_stats of the same state
    at the same clock (the staged frame for the triangle shards).  One line
    a path; the band kernels' launches go to the kernels line, the mesh
    paths' setup launches to its setup entries."""
    import torch

    from d3d12_deferred_renderer_tpu_torch.parallel import dryrun, run_bands, sharded
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import run_calls

    scenes = {label: tp.arrays_from_state(c1_state0 if changes is None else state0)
              for label, changes, _ in BAND_PATHS_3 + BAND_PATHS_4}
    band_launches = {"raster_tiles": 0, "raster_depth": 0, "shade_tiles": 0, "fused_tiles": 0, "bump_tiles": 0}
    mesh_launches = {w: 0 for w in ("setup_triangles", "fused_tiles", "raster_depth", "setup_depth_triangles",
                                    "raster_tiles", "shade_tiles", "bump_tiles")}
    for n, paths, mpaths in ((3, BAND_PATHS_3, MESH_PATHS_3), (4, BAND_PATHS_4, MESH_PATHS_4)):
        t0 = time.perf_counter()
        calls = [(bands_job, (scenes, paths)), (mesh_paths_job, (tp.arrays_from_state(state0), mpaths))]
        ranks = run_bands(n, run_calls, (calls,), device="cuda", timeout_s=420.0)
        spawn_s = time.perf_counter() - t0
        for k, (label, changes, contract) in enumerate(paths):
            res = [r[0][k] for r in ranks]
            cfg = band_path_config(tp, changes)
            frames = res[0]["frames"]
            expect = {w: 0 for w in res[0]["launches"]}
            expect.update({w: c * frames for w, c in BAND_PATH_LAUNCHES[label].items()})
            for r in res:
                check(r["frames"] == frames and r["launches"] == expect,
                      f"bands {label}: rank {r['rank']} launches {r['launches']}, expected {expect}")
                check(r["sampled_overflow"] == res[0]["sampled_overflow"] and r["frame_sum"] == res[0]["frame_sum"],
                      f"bands {label}: ranks disagree")
            for w in band_launches:
                band_launches[w] += sum(r["launches"][w] for r in res)
            # Each shadow map is one depth-only setup and one depth raster of
            # the whole map, not of a band.
            band_launches["raster_depth"] -= sum(r["launches"]["setup_depth_triangles"] for r in res)
            check(max(res[0]["sampled_overflow"]) == 0,
                  f"bands {label}: overflow {res[0]['sampled_overflow']} over the orbit")
            last = band_sweep_states(tp, c1_state0 if changes is None else state0, cfg)[-1]
            single, stats = tp.render_stats(last, cfg)
            check(int(stats["overflow"]) == 0, f"bands {label}: single-device overflow {int(stats['overflow'])}")
            frame = torch.from_numpy(res[0]["frame"]).to(dev)
            check(frame.shape == single.shape, f"bands {label}: frame shape {tuple(frame.shape)}")
            st = frame_stats(frame, single)
            if contract == "exact":
                check(st["max_u8"] == 0, f"bands {label}: assembled frame vs single device: {st}")
            else:
                check(st["max_u8"] <= 1 and st["frac_diff"] < 2e-3,
                      f"bands {label}: assembled frame vs single device: {st}")
            covered = float((frame.amax(-1) > 0).double().mean())
            check(covered > 0.02, f"bands {label}: frame nearly blank ({covered})")
            emit({"phase": "bands", "ok": True, "path": label, "ranks": n, "band_rows": cfg.height // n,
                  "resolution": f"{cfg.width}x{cfg.height}", "frames_per_rank": frames,
                  "launches_per_rank": {w: c for w, c in res[0]["launches"].items() if c},
                  "sampled_steps": len(res[0]["sampled_overflow"]), "sampled_overflow": res[0]["sampled_overflow"],
                  "vs_single_device": st, "covered_frac": covered,
                  "ms_per_frame_by_rank": [min(p[0] for p in r["passes"]) for r in res],
                  "host_ms_per_frame_by_rank": [min(p[1] for p in r["passes"]) for r in res],
                  "timing": "CUDA events around 10 frames of each rank, best of 2 passes; the ranks share "
                            "one card, so this shows correctness, not speed",
                  "spawn_and_run_seconds": spawn_s})
        for k, (label, changes, entry, sizes, names, kw, n_frames) in enumerate(mpaths):
            res = [r[1][k] for r in ranks]
            cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, **changes)
            rendered = res[0]["frames_rendered"]
            expect = {w: 0 for w in res[0]["launches"]}
            expect.update({w: c * rendered for w, c in MESH_PATH_LAUNCHES[label].items()})
            for r in res:
                check(r["launches"] == expect, f"mesh {label}: rank {r['rank']} launches {r['launches']}, "
                                               f"expected {expect}")
                check(r["overflow"] == res[0]["overflow"] and r["frames_sum"] == res[0]["frames_sum"],
                      f"mesh {label}: ranks disagree")
                for w in mesh_launches:
                    mesh_launches[w] += r["launches"][w]
            check(max(res[0]["overflow"]) == 0, f"mesh {label}: overflow {res[0]['overflow']}")
            # The frames of the last call against one device at the same clocks.
            single_cfg = cfg if entry == "frames" else dataclasses.replace(cfg, fused=False)
            times = [float(t) for t in tp.parallel.animation_times(mesh_path_starts()[-1], n_frames, device=dev)]
            got = torch.from_numpy(res[0]["frames"]).to(dev)
            check(got.shape[0] == (1 if entry == "tri" else n_frames), f"mesh {label}: {got.shape[0]} frames")
            worst = None
            for i in range(got.shape[0]):
                single, stats = tp.render_stats(sharded._with_time(state0, times[i]), single_cfg)
                check(int(stats["overflow"]) == 0, f"mesh {label}: single-device overflow {int(stats['overflow'])}")
                st = frame_stats(got[i], single)
                check(st["max_u8"] <= 1 and st["frac_diff"] < 2e-3, f"mesh {label}: frame {i} vs single device: {st}")
                worst = st if worst is None or st["frac_diff"] > worst["frac_diff"] else worst
            emit({"phase": "bands", "ok": True, "path": label, "entry": entry, "ranks": n,
                  "mesh": dict(zip(names, sizes)), "declared": list(names), "branch": res[0]["branch"],
                  "resolution": f"{cfg.width}x{cfg.height}", "frames_a_call": n_frames,
                  "frames_per_rank": rendered,
                  "launches_per_rank": {w: c for w, c in res[0]["launches"].items() if c},
                  "overflow_by_call": res[0]["overflow"], "vs_single_device_worst_frame": worst,
                  "single_device": "staged (fused=False)" if entry != "frames" else "the config's own",
                  "bytes_across_ranks_per_frame_by_rank": [r["bytes_per_frame"] for r in res],
                  "ms_per_frame_by_rank": [min(r["ms_per_frame"]) for r in res],
                  "host_ms_per_frame_by_rank": [min(r["host_ms_per_frame"]) for r in res],
                  "timing": f"CUDA events around each of {MESH_CALLS - 1} calls, best, over the frames a rank "
                            "renders a call; the ranks share one card, so this shows correctness, not speed",
                  "spawn_and_run_seconds": spawn_s})
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(4, device="cuda", timeout_s=300.0)
    for steps, launches in dry:
        check(steps == ["staged", "kernels", "three_axis"], f"dryrun steps {steps}")
        for w in mesh_launches:
            mesh_launches[w] += launches[w]
    check(all(d[1]["fused_tiles"] > 0 for d in dry), "dryrun: the kernel step never launched the fused kernel")
    emit({"phase": "bands", "ok": True, "path": "dryrun_multichip", "ranks": 4, "steps": dry[0][0],
          "launches_by_rank": [{w: c for w, c in d[1].items() if c} for d in dry],
          "spawn_and_run_seconds": time.perf_counter() - t0})
    for key, w in (("k6_band", "raster_tiles"), ("k3_band", "raster_depth"), ("k7_band", "shade_tiles"),
                   ("k2_band", "fused_tiles"), ("k8_band", "bump_tiles")):
        kernels[key]["launches"] = band_launches[w]
        check(band_launches[w] > 0, f"{w} never launched on the band paths")
    # The mesh paths' and the dry run's launches: K6, K7, K8 and K2 on bands
    # and composited sub-bands; K1, and with shadows K4 and K3, on the whole
    # stream and the whole shadow map.
    for key, w in (("k6_band", "raster_tiles"), ("k7_band", "shade_tiles"), ("k8_band", "bump_tiles"),
                   ("k2_band", "fused_tiles"), ("setup", "setup_triangles"),
                   ("setup_depth", "setup_depth_triangles"), ("raster_depth", "raster_depth")):
        kernels[key]["launches"] += mesh_launches[w]
    for w, c in mesh_launches.items():
        check(c > 0, f"{w} never launched on the mesh paths and the dry run")
    emit({"phase": "mesh_paths_launches", "ok": True, "launches": mesh_launches})


def time_staged(root: str, passes: int = 3) -> int:
    """The --time-staged mode (see the module docstring)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import lighting, lighting_cuda, raster_tiles, setup_cuda, shadows
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import frame_matrices, setup_frame_triangles
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=False)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=24))
    state = tp.make_scene(geo, cfg, lights=tp.random_point_lights(256, cfg=cfg, radius=1.2, device=dev),
                          placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=dev), device=dev)
    state = tp.animate(state, cfg.yaw_per_frame, cfg)
    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    grid = dict(nty=-(-H // TH), ntx=-(-W // TW), tile_h=TH, tile_w=TW)
    NT = grid["nty"] * grid["ntx"]
    tris, _ = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    gb = tp.render_gbuffer(state, cfg)
    model, view_proj, mvp = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    tl = lighting.cull_lights_to_tiles(gb.depth, state.lights, cfg, view_proj, tile=(TH, TW),
                                       max_per_tile=min(256, cfg.max_live_lights_per_tile), inv_vp=inv_vp)
    sargs = (lighting_cuda.gbuffer_planes(gb, grid["nty"] * TH, grid["ntx"] * TW),
             lighting_cuda.build_light_table(state.lights), tl.indices.reshape(NT, -1), tl.counts.reshape(NT),
             lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inv_vp, W, H))
    heavy = sargs[3].clone()
    heavy[int(torch.argmax(heavy))] = 0
    no_heavy = (*sargs[:3], heavy, sargs[4])
    no_lights = (*sargs[:3], torch.zeros_like(sargs[3]), sargs[4])
    g = state.geometry
    k1_args = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id, mvp, model, W, H)
    S = dataclasses.replace(cfg, **CONFIG4_FLAGS).shadow_map_size
    k4_args = (g.fv_pos_cols, g.tri_mesh_id,
               xmath.matmul4_fma(model, shadows.light_view_proj(state.lights.direction)), S, S)
    fns = {"K1": lambda: setup_cuda.setup_triangles(*k1_args),
           "K4": lambda: setup_cuda.setup_depth_triangles(*k4_args),
           "K6": lambda: raster_tiles.raster_tiles(b.counts, b.offs, b.stream, **grid),
           "K7": lambda: lighting_cuda.shade_tiles(*sargs, **grid, gamma=cfg.gamma),
           "K7_without_heaviest_tile": lambda: lighting_cuda.shade_tiles(*no_heavy, **grid, gamma=cfg.gamma),
           "K7_without_point_lights": lambda: lighting_cuda.shade_tiles(*no_lights, **grid, gamma=cfg.gamma),
           "K8": bump_call(tp, raster_tiles.raster_tiles(b.counts, b.offs, b.stream, **grid), inv_vp, cfg)[0]}
    times = {k: [graph_ms(f, 50) for _ in range(passes)] for k, f in fns.items()}
    emit({"phase": "time_staged", "root": os.path.abspath(root), "device_ms": times,
          "best_device_ms": {k: min(v) for k, v in times.items()},
          "setup_threads": setup_source(cuda_build.CSRC_DIR)[1],
          "setup_ptxas": setup_ptxas(cuda_build.BuildInfo.log),
          "bump_ptxas": ptxas_lines(cuda_build.BuildInfo.log, "bump_tile_kernel"),
          "timing": "device ms per call, 50 calls replayed from one CUDA graph, per pass"})
    print(card_name_and_limit(), flush=True)
    return 0


def bump_call(tp, planes, inv_vp, cfg):
    """(kernel, plain version) of K8 on the staged flagship's raster planes
    [8, Hp, Wp], each a function of no arguments returning its normals
    [3, Hp, Wp], for the wrappers of the checkout that `tp` was imported
    from: the in-place wrappers' kernel on one copy of the planes (its
    first call bumps them once) and plain version on a fresh copy; the
    older out-of-place wrappers (those with bump_planes) both on the
    fragments restacked into 7 planes."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump, raster_tiles

    H, W, TH, TW = cfg.height, cfg.width, cfg.tile_h, cfg.tile_w
    kw = dict(tile_h=TH, tile_w=TW, strength=cfg.bump_strength, freq=cfg.bump_frequency)
    if hasattr(bump, "bump_planes"):  # the out-of-place signature
        args = (bump.bump_planes(raster_tiles.fragments_from_planes(planes, H, W), *planes.shape[1:]),
                bump.bump_uniforms(inv_vp, W, H))
        kw.update(nty=planes.shape[1] // TH, ntx=planes.shape[2] // TW)
        return (lambda: bump.bump_tiles(*args, **kw)), (lambda: bump.bump_tiles_reference(*args, **kw))
    work = planes.clone()
    kw.update(width=W, height=H)
    return ((lambda: bump.bump_tiles(work, inv_vp, **kw)[1:4]),
            (lambda: bump.bump_tiles_reference(planes.clone(), inv_vp, **kw)[1:4]))


# --time-bump's copies of csrc/bump.cu: regular-expression substitutions in
# bump.cuh and bump.cu, at least one of which must match.  fp32_math takes
# float32 intrinsics for sin_rn and rsqrt_rn (wrong bits, timing only);
# staging_only leaves the bump's arithmetic out (the out-of-place kernel copies
# each normal through, the in-place kernel writes none).
BUMP_ABLATIONS = {
    "as_is": (),
    "fp32_math": ((r"(float sin_rn\(float x\) \{)[^}]*\}", r"\1 return __sinf(x); }"),
                  (r"(float rsqrt_rn\(float x\) \{)[^}]*\}", r"\1 return rsqrtf(x); }")),
    "staging_only": ((r"bump::bump_pixel\(s_pl, tile_h, tile_w, i, n, strength, w2pf, nb\);",
                      "nb[0] = n[0], nb[1] = n[1], nb[2] = n[2];"),
                     (r"(bool perturb\([^{]*\{)", r"\1\n  return false;")),
}


def time_bump(root: str, passes: int = 3) -> int:
    """The --time-bump mode (see the module docstring)."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.ops import lighting, raster_tiles
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import frame_matrices, setup_frame_triangles
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=False, **CONFIG4_FLAGS)
    _, state = flagship_scene(tp, cfg, dev)
    state = tp.animate(state, cfg.yaw_per_frame, cfg)
    grid = dict(nty=-(-cfg.height // cfg.tile_h), ntx=-(-cfg.width // cfg.tile_w), tile_h=cfg.tile_h,
                tile_w=cfg.tile_w)
    tris, _ = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, **grid)
    inv_vp = lighting.inverse_view_proj(frame_matrices(state, cfg)[1])
    want = bump_call(tp, planes, inv_vp, cfg)[1]()

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR)
    library = cuda_build.library
    try:
        procs = {}
        for name, subs in BUMP_ABLATIONS.items():
            src = os.path.join(tmp, name)
            shutil.copytree(cuda_build.CSRC_DIR, src)
            hits = 0
            for fname in ("bump.cuh", "bump.cu"):
                path = os.path.join(src, fname)
                with open(path) as fh:
                    text = fh.read()
                for pattern, repl in subs:
                    text, n = re.subn(pattern, repl, text)
                    hits += n
                with open(path, "w") as fh:
                    fh.write(text)
            check(hits > 0 or not subs, f"--time-bump: no substitution of {name} matched {root}'s sources")
            procs[name] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", src, "-shared", "-o",
                 os.path.join(tmp, f"libbump_{name}.so"), os.path.join(src, "bump.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = {n: p.communicate()[0] for n, p in procs.items()}
        check(all(p.returncode == 0 for p in procs.values()), f"nvcc failed: {logs}")
        fns, libs = {}, {}
        for name in BUMP_ABLATIONS:
            lib = libs[name] = ctypes.CDLL(os.path.join(tmp, f"libbump_{name}.so"))
            lib.bump_tiles_launch.argtypes = list(cuda_build.SIGNATURES["bump_tiles_launch"])
            lib.bump_tiles_launch.restype = ctypes.c_int
            cuda_build.library = lambda lib=lib: lib  # the wrapper's library, while this copy runs
            fns[name] = bump_call(tp, planes, inv_vp, cfg)[0]
            if name == "as_is":
                got = fns[name]()
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"K8 of {root} differs from its plain version")
        times = {n: [] for n in fns}
        for _ in range(passes):  # the copies in turns
            for n, fn in fns.items():
                cuda_build.library = lambda lib=libs[n]: lib
                times[n].append(graph_ms(fn, 50))
        emit({"phase": "time_bump", "root": os.path.abspath(root), "device_ms": times,
              "best_device_ms": {k: min(v) for k, v in times.items()}, "bit_equal": True,
              "ptxas": {n: ptxas_lines(logs[n], "bump_tile_kernel") for n in logs},
              "timing": "device ms per call, 50 calls replayed from one CUDA graph, per pass"})
    finally:
        cuda_build.library = library
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_name_and_limit(), flush=True)
    return 0


def time_setup_blocks(sizes=(64, 128, 256), passes: int = 3) -> int:
    """The --time-setup-blocks mode (see the module docstring)."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import shadows
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        TriSetup, frame_matrices, setup_depth_reference, setup_triangles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    src, _ = setup_source(cuda_build.CSRC_DIR)
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR)
    try:
        procs = {}
        for n in sizes:
            cu = os.path.join(tmp, f"setup_{n}.cu")
            with open(cu, "w") as fh:
                fh.write(SETUP_THREADS_DECL.sub(f"constexpr int kThreads = {n};", src, count=1))
            procs[n] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-shared",
                 "-o", os.path.join(tmp, f"libsetup_{n}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = {n: p.communicate()[0] for n, p in procs.items()}
        check(all(p.returncode == 0 for p in procs.values()), f"nvcc failed: {logs}")
        libs = {}
        for n in sizes:
            lib = libs[n] = ctypes.CDLL(os.path.join(tmp, f"libsetup_{n}.so"))
            for name in ("setup_triangles_launch", "setup_depth_launch"):
                getattr(lib, name).argtypes = list(cuda_build.SIGNATURES[name])
                getattr(lib, name).restype = ctypes.c_int

        dev = torch.device("cuda", 0)
        cfg = tp.FLAGSHIP_CONFIG
        _, state = flagship_scene(tp, cfg, dev)
        state = tp.animate(state, cfg.yaw_per_frame, cfg)
        model, _, mvp = frame_matrices(state, cfg)
        g = state.geometry
        T, M, S = g.tri_mesh_id.shape[0], mvp.shape[0], dataclasses.replace(cfg, **CONFIG4_FLAGS).shadow_map_size
        lmvp = xmath.matmul4_fma(model, shadows.light_view_proj(state.lights.direction))
        refs = {"K1": setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                                mvp, model, cfg.width, cfg.height),
                "K4": setup_depth_reference(g.fv_pos_cols, g.tri_mesh_id, lmvp, S, S)}

        def launcher(lib, kernel, n):
            out = TriSetup(packed=torch.empty((2 * T, 32), device=dev), aabb=torch.empty((2 * T, 4), device=dev),
                           valid=torch.empty(2 * T, dtype=torch.bool, device=dev))
            ptrs = (out.packed.data_ptr(), out.aabb.data_ptr(), out.valid.data_ptr())

            def fn():
                stream = torch.cuda.current_stream().cuda_stream
                if kernel == "K1":
                    err = lib.setup_triangles_launch(
                        g.fv_pos_cols.data_ptr(), g.fv_nrm_cols.data_ptr(), g.fv_uv_cols.data_ptr(),
                        g.tri_mesh_id.data_ptr(), mvp.data_ptr(), model.data_ptr(), T, M,
                        float(cfg.width), float(cfg.height), 1, *ptrs, stream)  # cull back
                else:
                    err = lib.setup_depth_launch(g.fv_pos_cols.data_ptr(), g.tri_mesh_id.data_ptr(), lmvp.data_ptr(),
                                                 T, M, float(S), float(S), 0, *ptrs, stream)  # cull none
                cuda_build.raise_on_error(err, f"{kernel} at {n} threads")
            return fn, out

        fns = {}
        for n in sizes:
            for kernel in ("K1", "K4"):
                fn, out = launcher(libs[n], kernel, n)
                fn()
                torch.cuda.synchronize()
                check(setup_equal(out, refs[kernel]), f"{kernel} at {n} threads differs from the plain version")
                fns[(kernel, n)] = fn
        times = {f"{k}@{n}": [] for k, n in fns}
        for _ in range(passes):  # the block sizes in turns
            for (k, n), fn in fns.items():
                times[f"{k}@{n}"].append(graph_ms(fn, 50))
        # The launch the kernel's own valid flags replace: the flags from
        # record field 28, as a second kernel.
        packed = refs["K1"].packed
        times["valid_from_records"] = [graph_ms(lambda: packed[:, 28] > 0.0, 50) for _ in range(passes)]
        emit({"phase": "time_setup_blocks", "triangles": T, "device_ms": times,
              "best_device_ms": {k: min(v) for k, v in times.items()},
              "grid": {n: -(-T // n) for n in sizes}, "ptxas": {n: setup_ptxas(logs[n]) for n in sizes},
              "bit_equal": True,
              "timing": "device ms per call, 50 calls replayed from one CUDA graph, per pass"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_name_and_limit(), flush=True)
    return 0


def graph_only() -> int:
    """The --graph mode (see the module docstring)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import kernel_wrappers
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    wrappers = kernel_wrappers()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, fused=True)
    _, state0 = flagship_scene(tp, cfg, dev)
    _, c1_state0 = config1_scene(tp, tp.REFERENCE_CONFIG, dev)
    app_phase(tp, state0, cfg, c1_state0, tp.REFERENCE_CONFIG, wrappers)
    graph_phase(tp, state0, c1_state0, wrappers, card_name_and_limit())
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--graph"]:
        sys.exit(graph_only())
    if sys.argv[1:2] == ["--time-staged"] and len(sys.argv) == 3:
        sys.exit(time_staged(sys.argv[2]))
    if sys.argv[1:2] == ["--time-bump"] and len(sys.argv) == 3:
        sys.exit(time_bump(sys.argv[2]))
    if sys.argv[1:] == ["--time-setup-blocks"]:
        sys.exit(time_setup_blocks())
    sys.exit(main())
