"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile the hand-written kernels (csrc/*.cu) with nvcc.
2. k1      — the setup kernel against its plain PyTorch version on the
             flagship scene (23,906 triangles, 1920x1080): valid, mesh id and
             padding exact, float fields bit-equal or within rounding bounds.
3. k2      — the fused tile kernel against its plain version on the same
             binned input, at 256x64 and 1920x1080: equal per-tile overflow,
             max |du8| <= 1, fewer than 1% of pixels different.
4. main    — the flagship frame through the entry points (animate +
             render_stats, step_frame): a 64-step sweep of the whole yaw
             orbit with overflow 0, launch counts equal to the frames
             rendered, a frame that is not blank and agrees with the plain
             chain, and ms/frame from CUDA events over 3 x 30 frames.

Then the card's name and power limit (nvidia-smi), the kernels line, and the
last line {"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.  Needs one card; imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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
    from d3d12_deferred_renderer_tpu_torch.ops import fused
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    args = (
        binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
        fused.build_material_table(state.materials, cfg.gamma),
        fused.build_uniforms(state, cfg, view_proj),
    )
    kw = dict(
        nty=-(-cfg.height // cfg.tile_h), ntx=-(-cfg.width // cfg.tile_w),
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
    )
    return args, kw, binned


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.ops import fused, setup_cuda
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        TRI_MESH_ID, TRI_VALID, frame_matrices, setup_triangles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    check("jax" not in sys.modules, "the port imported jax")

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
    gp, rp = got.packed, ref.packed
    check(gp.shape == rp.shape == (2 * geo.num_triangles, 32), f"K1 shape {tuple(gp.shape)}")
    check(torch.equal(gp[:, TRI_MESH_ID], rp[:, TRI_MESH_ID]), "K1 mesh ids differ")
    check(torch.equal(gp[:, 30:32], rp[:, 30:32]), "K1 padding differs")
    flips = int((gp[:, TRI_VALID] != rp[:, TRI_VALID]).sum())
    check(flips == 0, f"K1 valid flags differ on {flips} records")
    exact = gp == rp
    close = torch.isclose(gp, rp, rtol=2e-4, atol=2e-4)
    bad = float((~(exact | close)).double().mean())
    check(float(exact.double().mean()) > 0.9 and bad < 1e-4, f"K1 records off: bad {bad}")
    check(bool(torch.isclose(got.aabb, ref.aabb, rtol=2e-4, atol=2e-3).all()), "K1 boxes off")
    k1_err = float((gp - rp).abs().max())
    k1_ms = cuda_ms(lambda: setup_cuda.setup_triangles(*k1_args), 200)
    k1_plain_ms = cuda_ms(lambda: setup_triangles_reference(*k1_args), 20)
    emit({
        "phase": "k1", "ok": True, "records": int(gp.shape[0]),
        "valid": int(got.valid.sum()), "bit_equal_frac": float(exact.double().mean()),
        "max_abs_err": k1_err, "aabb_max_abs_err": float((got.aabb - ref.aabb).abs().max()),
        "ms": k1_ms, "plain_ms": k1_plain_ms,
    })
    kernels["setup"] = dict(
        name="setup_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:254",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
    )

    # ---- 3. K2 against its plain version, small and full size ----
    k2 = {}
    small_cfg = dataclasses.replace(cfg, width=256, height=64)
    for label, kcfg, kstate in (
        ("256x64", small_cfg, tp.animate(small_scene(tp, small_cfg, dev), cfg.yaw_per_frame, cfg)),
        ("1920x1080", cfg, state),
    ):
        args, kw, binned = k2_inputs(tp, kstate, kcfg)
        color, tovf = fused.fused_tiles(*args, **kw)
        pcolor, ptovf = fused.fused_tiles_reference(*args, **kw)
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
            line["max_tris_in_a_tile"] = int(binned.counts.max())
            line["ms"] = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **kw), 2)
            kernels["fused"] = dict(
                name="fused_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/fused.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/fused.py:157",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
            )
        emit(line)
        k2[label] = line

    # ---- 4. the main path ----
    setup_cuda.setup_triangles.launches = 0
    fused.fused_tiles.launches = 0
    frames = 0
    state = state0
    for _ in range(2):  # warm-up
        state, frame = tp.step_frame(state, cfg)
        frames += 1
    # Whole-orbit overflow sweep: 64 steps of 2*pi/64 through the same path.
    sweep_ovf = []
    sweep = state
    for _ in range(64):
        sweep = tp.animate(sweep, 2.0 * math.pi / 64.0, cfg)
        _, stats = tp.render_stats(sweep, cfg)
        sweep_ovf.append(stats["overflow"])
        frames += 1
    sweep_max = int(torch.stack(sweep_ovf).max())
    check(sweep_max == 0, f"overflow {sweep_max} on the yaw orbit sweep")
    # Timing: 3 passes of 30 frames, each frame advancing the state.
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
    launches = {"setup_triangles": setup_cuda.setup_triangles.launches,
                "fused_tiles": fused.fused_tiles.launches}
    check(all(n == frames for n in launches.values()),
          f"launch counts {launches} != {frames} frames")
    kernels["setup"]["launches"] = launches["setup_triangles"]
    kernels["fused"]["launches"] = launches["fused_tiles"]

    check(frame.shape == (cfg.height, cfg.width, 3) and frame.dtype == torch.uint8, "frame shape")
    covered = float((frame.amax(-1) > 0).double().mean())
    check(covered > 0.2, f"main-path frame nearly blank ({covered})")
    # The last frame against the plain chain (plain setup, binning, plain
    # tile renderer) on the same state.
    model, view_proj, mvp = frame_matrices(state, cfg)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, cfg.width, cfg.height)
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles

    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    pcolor, _ = fused.fused_tiles_reference(
        binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
        fused.build_material_table(state.materials, cfg.gamma),
        fused.build_uniforms(state, cfg, view_proj),
        nty=-(-cfg.height // cfg.tile_h), ntx=-(-cfg.width // cfg.tile_w),
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_lights=L,
        ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma,
    )
    plain_frame = u8(pcolor[:, : cfg.height, : cfg.width]).permute(1, 2, 0)
    st = frame_stats(frame, plain_frame)
    check(st["max_u8"] <= 1 and st["frac_diff"] < 0.01, f"main-path frame vs plain chain: {st}")
    best = min(p[0] for p in passes)
    emit({
        "phase": "main", "ok": True, "resolution": f"{cfg.width}x{cfg.height}",
        "triangles": geo.num_triangles, "lights": L, "frames": frames,
        "sweep_steps": 64, "sweep_max_overflow": sweep_max, "launches": launches,
        "covered_frac": covered, "vs_plain_chain": st,
        "ms_per_frame": best, "fps": 1e3 / best,
        "passes_device_ms": [p[0] for p in passes], "passes_host_ms": [p[1] for p in passes],
        "peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20,
    })

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"kernels": [kernels["setup"], kernels["fused"]]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
