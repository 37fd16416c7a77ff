"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — compile the hand-written kernels (csrc/*.cu) with nvcc, one
             process per source, all started together.
2. k1      — the setup kernel against its plain PyTorch version on the
             flagship scene (23,906 triangles, 1920x1080): valid, mesh id and
             padding exact, float fields bit-equal or within rounding bounds.
3. k2      — the fused tile kernel against its plain version on the same
             binned input, at 256x64 and 1920x1080: equal per-tile overflow,
             max |du8| <= 1, fewer than 1% of pixels different.
4. k6      — the tile raster kernel against its plain version on the same
             binned input at 256x64, 1280x720 (config 1) and 1920x1080
             (flagship scene): depth, mesh id and pad planes bit-equal,
             normal and uv planes within 2e-6, equal overflow.
5. k7      — the G-buffer lighting kernel against its plain version on the
             flagship G-buffer (256 lights), without and with a visibility
             plane: HDR within rtol 2e-4, atol 2e-5, after tonemap + gamma
             max |du8| <= 1 on fewer than 1% of pixels, equal tile counts.
6. main    — the fused flagship frame through the entry points (animate +
             render_stats, step_frame): a 64-step sweep of the whole yaw
             orbit with overflow 0, launch counts equal to the frames
             rendered, a frame that is not blank and agrees with the plain
             chain, and ms/frame from CUDA events over 3 x 30 frames.
7. staged  — one line for config 1 (the reference's frame: Lambert, cube +
             pyramid, 1280x720) and one for the staged flagship (fused=False,
             1920x1080, 256 lights): the same sweep, launch counts and timing
             through tp.step_frame / tp.render_stats; overflow 0 for config
             1, equal to the plain chain's at every 4th step for the flagship.

Then the card's name and power limit (nvidia-smi), the kernels line, and the
last line {"ok": true, "device": {...}}.  Without a CUDA device it exits 2
and prints no result.  Needs one card; imports no JAX.  Each main path runs
with every launch count set to 0 just before it and read just after.
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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate, and which of them it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def per_tile_covered(depth_planes, tile_h: int, tile_w: int):
    """Covered pixels (depth < 1) per tile [NT] of a [Hp, Wp] depth plane."""
    Hp, Wp = depth_planes.shape
    return (depth_planes < 1.0).reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w).sum((1, 3)).reshape(-1)


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


def staged_plain_chain(state, cfg, shade: bool = True):
    """The staged frame by the plain versions on the card: plain setup,
    binning, plain tile raster, G-buffer, Lambert or the light cull + plain
    lighting, post.  Returns (uint8 frame or None, overflow, light cull or
    None)."""
    import torch
    from d3d12_deferred_renderer_tpu_torch.ops import lighting, lighting_cuda, post
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
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, W, H)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    planes = raster_tiles_reference(binned.counts, binned.offs, binned.stream,
                                    nty=nty, ntx=ntx, tile_h=TH, tile_w=TW)
    gb = encode_gbuffer(fragments_from_planes(planes, H, W), state.materials, cfg)
    overflow, tl = binned.overflow, None
    if cfg.shading == "lambert":
        color = lighting.shade_lambert(gb, state.lights, cfg) if shade else None
    else:
        li = state.lights
        inv_vp = lighting.inverse_view_proj(view_proj)
        tl = lighting.cull_lights_to_tiles(
            gb.depth, li, cfg, view_proj, tile=(TH, TW),
            max_per_tile=min(li.num_point, cfg.max_live_lights_per_tile), inv_vp=inv_vp,
        )
        overflow = overflow + tl.overflow
        color = None
        if shade:
            hdr = lighting_cuda.shade_tiles_reference(
                lighting_cuda.gbuffer_planes(gb, nty * TH, ntx * TW),
                lighting_cuda.build_light_table(li), tl.indices.reshape(nty * ntx, -1),
                tl.counts.reshape(-1),
                lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H),
                nty=nty, ntx=ntx, tile_h=TH, tile_w=TW, gamma=cfg.gamma,
            )
            color = post.apply_post(hdr[:, :H, :W].permute(1, 2, 0), cfg)
    frame = post.to_uint8(color) if color is not None else None
    return frame, overflow, tl


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
    from d3d12_deferred_renderer_tpu_torch.ops import (
        fused, lighting, lighting_cuda, post, raster_tiles, setup_cuda,
    )
    from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
    from d3d12_deferred_renderer_tpu_torch.ops.transform import (
        TRI_MESH_ID, TRI_VALID, frame_matrices, setup_frame_triangles, setup_triangles_reference,
    )
    from d3d12_deferred_renderer_tpu_torch.utils import cuda_build

    check("jax" not in sys.modules, "the port imported jax")
    wrappers = (setup_cuda.setup_triangles, fused.fused_tiles, raster_tiles.raster_tiles,
                lighting_cuda.shade_tiles)

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
    M = mvp.shape[0]
    k1_bytes = T * (36 + 36 + 24 + 4) + 2 * M * 64 + 2 * T * (32 * 4 + 16)
    kernels["setup"] = dict(
        name="setup_triangles", route="cuda",
        source="d3d12_deferred_renderer_tpu_torch/csrc/setup.cu",
        replaces="d3d12_deferred_renderer_tpu/ops/setup_pallas.py:254",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
        **bound(k1_bytes, T * SETUP_OPS_PER_TRIANGLE), library_ms=None,
    )

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
            line["max_tris_in_a_tile"] = int(binned.counts.max())
            line["ms"] = cuda_ms(lambda: fused.fused_tiles(*args, **kw), 50)
            line["plain_ms"] = cuda_ms(lambda: fused.fused_tiles_reference(*args, **kw), 2)
            # The work this frame needs: the binned pairs at every tile pixel,
            # every covered pixel, and every covered pixel with each live
            # light of its tile (covered pixels from the tile raster kernel
            # on the same records).
            planes = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream,
                                               **{k: kw[k] for k in ("nty", "ntx", "tile_h", "tile_w")})
            cov = per_tile_covered(planes[raster_tiles.PLANE_DEPTH], kcfg.tile_h, kcfg.tile_w)
            P = kcfg.tile_h * kcfg.tile_w
            pairs = int(binned.counts.sum())
            k2_ops = (pairs * P * RASTER_OPS_PER_RECORD_PIXEL + int(cov.sum()) * SHADE_OPS_PER_PIXEL
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
                **bound(k2_bytes, k2_ops), library_ms=None,
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
        for p in (raster_tiles.PLANE_DEPTH, raster_tiles.PLANE_MID, raster_tiles.PLANE_PAD):
            check(torch.equal(planes[p], pplanes[p]), f"K6 plane {p} not bit-equal at {label}")
        err = float((planes - pplanes).abs().max())
        check(err <= 2e-6, f"K6 normal/uv planes off by {err} at {label}")
        check(int(binned.overflow) == int(pbinned.overflow), f"K6 overflow differs at {label}")
        covered = float((planes[raster_tiles.PLANE_MID] >= 0).double().mean())
        check(covered > 0.02, f"K6 planes nearly empty at {label}")
        line = {"phase": "k6", "ok": True, "size": label, "overflow": int(binned.overflow),
                "covered_frac": covered, "max_abs_err": err,
                "bit_equal_frac": float((planes == pplanes).double().mean()),
                "binned_pairs": int(binned.counts.sum()), "max_tris_in_a_tile": int(binned.counts.max())}
        if label == "1920x1080":
            line["ms"] = cuda_ms(lambda: raster_tiles.raster_tiles(*bargs, **kw), 100)
            line["plain_ms"] = cuda_ms(lambda: raster_tiles.raster_tiles_reference(*bargs, **kw), 2)
            pairs = int(binned.counts.sum())
            k6_bytes = pairs * 128 + 4 * (2 * binned.counts.numel() + 1) + 4 * planes.numel()
            line.update(bound(k6_bytes, pairs * TH * TW * RASTER_OPS_PER_RECORD_PIXEL))
            kernels["raster"] = dict(
                name="raster_tiles", route="cuda",
                source="d3d12_deferred_renderer_tpu_torch/csrc/raster.cu",
                replaces="d3d12_deferred_renderer_tpu/ops/raster_pallas.py:730",
                max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                **bound(k6_bytes, pairs * TH * TW * RASTER_OPS_PER_RECORD_PIXEL), library_ms=None,
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
        excess = float(((hdr - phdr).abs() - (2e-5 + 2e-4 * phdr.abs())).max())
        check(excess <= 0.0, f"K7 HDR outside rtol 2e-4, atol 2e-5 ({label}): excess {excess}")
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
        if label == "no_vis":
            line["ms"] = cuda_ms(lambda: lighting_cuda.shade_tiles(*sargs, **skw), 100)
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
                **bound(k7_bytes, k7_ops), library_ms=None,
            )
        emit(line)
    del gb, sargs, hdr, phdr, img

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
    model, view_proj, mvp = frame_matrices(state, cfg)
    g = state.geometry
    tris = setup_triangles_reference(g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id,
                                     mvp, model, cfg.width, cfg.height)
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
        expect = {"setup_triangles": frames, "fused_tiles": 0, "raster_tiles": frames,
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

    for key, name in (("setup", "setup_triangles"), ("fused", "fused_tiles"),
                      ("raster", "raster_tiles"), ("shade", "shade_tiles")):
        kernels[key]["launches"] = total_launches[name]
        check(total_launches[name] > 0, f"{name} never launched on the main paths")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kernels[n][k] for k in keys} for n in ("setup", "fused", "raster", "shade")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
