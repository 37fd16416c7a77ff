"""PyTorch port: the application path's frame loop on the CPU.

* render_batch and cfg.supersample against the JAX package: one jitted
  JAX render_batch of supersampled config-1 frames (96x48, Lambert) on a
  scene carried across as numpy arrays, held to the golden-image contract
  of tests/test_torch_staged.py for jitted JAX frames (at most 1 LSB on
  fewer than 0.1% of pixels), and the final clock equal.
* The JAX package's contracts of tests/test_frame.py:85 (render_batch
  bit-equal to sequential step_frame calls) and tests/test_scene_io.py:48
  (supersampling smooths edges), on the port.
* The port's own: the supersampled frame is the box average of the frame
  rendered at s times the size, rounded half to even.

The present queue, App, the profiler and the native sink are in
tests/test_torch_app.py.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr

import d3d12_deferred_renderer_tpu_torch as tp

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
CFG = tp.RendererConfig(width=96, height=48, use_pallas=False)


def _scene(cfg=CFG):
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, cfg, device="cpu")


def _pbr_scene(cfg):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, radius=1.2, device="cpu"),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"), device="cpu",
    )


def test_render_batch_and_supersample_match_jax():
    jcfg = dxr.RendererConfig(width=96, height=48, use_pallas=False, supersample=2)
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"), prefer_native=False)
                                     for m in ("cube", "pyramid")])
    jstate = dxr.make_scene(jgeo, jcfg)
    jfinal, jframes = jax.jit(lambda s: dxr.render_batch(s, jcfg, 3))(jstate)
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    pfinal, pframes = tp.render_batch(pstate, tp.RendererConfig(**dataclasses.asdict(jcfg)), 3)
    jframes = np.asarray(jframes)
    assert pframes.shape == jframes.shape == (3, 48, 96, 3) and pframes.dtype == torch.uint8
    diff = np.abs(jframes.astype(int) - pframes.numpy().astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    assert float(pfinal.time) == float(jfinal.time)
    assert (jframes.max(-1) > 0).mean() > 0.01  # not blank


def test_render_batch_of_no_frames_matches_jax():
    """render_batch(state, cfg, 0): the state as it was and an empty uint8
    [0, H, W, 3] batch on the state's device, as JAX's scan of length 0
    returns."""
    jcfg = dxr.RendererConfig(width=96, height=48, use_pallas=False)
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)])
    jstate = dxr.make_scene(jgeo, jcfg)
    jfinal, jframes = dxr.render_batch(jstate, jcfg, 0)
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    pfinal, pframes = tp.render_batch(pstate, tp.RendererConfig(**dataclasses.asdict(jcfg)), 0)
    assert tuple(pframes.shape) == np.asarray(jframes).shape == (0, 48, 96, 3)
    assert pframes.dtype == torch.uint8 and pframes.device == pstate.time.device
    assert pfinal is pstate and float(pfinal.time) == float(jfinal.time)


RENDER_CASES = {
    "reference_raster": CFG,
    "tile_raster": dataclasses.replace(CFG, use_pallas=True),
    "fused_pbr": dataclasses.replace(tp.FLAGSHIP_CONFIG, width=128, height=48, fused=True),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_batch_matches_sequential(case):
    """render_batch is bit-equal to N sequential step_frame calls and ends
    on their clock (test_frame.py:85)."""
    cfg = RENDER_CASES[case]
    state = _pbr_scene(cfg) if cfg.shading == "pbr" else _scene(cfg)
    final, frames = tp.render_batch(state, cfg, 3)
    assert frames.shape == (3, cfg.height, cfg.width, 3) and frames.dtype == torch.uint8
    s = state
    for i in range(3):
        s, f = tp.step_frame(s, cfg)
        assert torch.equal(frames[i], f), i
    assert float(final.time) == float(s.time)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_supersample_is_the_box_average(case, s):
    """cfg.supersample = s renders at s times the size through the same path
    and box-averages: each s x s block's integer sum over s^2, rounded half
    to even, with the high-resolution frame's overflow."""
    cfg = RENDER_CASES[case]
    state = tp.animate(_pbr_scene(cfg) if cfg.shading == "pbr" else _scene(cfg), 0.3, cfg)
    got, stats = tp.render_stats(state, dataclasses.replace(cfg, supersample=s))
    hi, hi_stats = tp.render_stats(state, dataclasses.replace(cfg, width=cfg.width * s, height=cfg.height * s))
    sums = hi.to(torch.int64).reshape(cfg.height, s, cfg.width, s, 3).sum(dim=(1, 3))
    q, r = sums // (s * s), sums % (s * s)
    up = (2 * r > s * s) | ((2 * r == s * s) & (q % 2 == 1))
    assert torch.equal(got, (q + up.to(torch.int64)).to(torch.uint8))
    assert int(stats["overflow"]) == int(hi_stats["overflow"]) == 0


def test_supersampling_smooths_edges():
    """test_scene_io.py:48: more distinct levels along silhouettes, and the
    interiors agree closely."""
    state = tp.animate(_scene())
    f1 = tp.render(state, CFG).numpy()
    f2 = tp.render(state, dataclasses.replace(CFG, supersample=2)).numpy()
    assert f1.shape == f2.shape == (48, 96, 3)
    assert len(np.unique(f2)) > len(np.unique(f1))
    interior = (f1.sum(-1) > 0) & (f2.sum(-1) > 0)
    assert np.abs(f1[interior].astype(int) - f2[interior].astype(int)).mean() < 12
