"""PyTorch port: the config-4 frame (shadows + procedural bump + bloom)
against the JAX package.

* The directional resolve kernel's plain version against JAX
  directional_resolve_pallas (interpret mode) on the same planes: within
  rtol 2e-4, atol 2e-5, the lighting kernel's contract (interpret mode
  contracts the GGX sums into fused multiply-adds, the port rounds each).
* The port's three config-4 frames through tp.render_stats on the CPU (the
  plain versions of every kernel): the staged frame (setup, tile raster,
  bump, shadow map, PCF, lighting, bloom), the fused frame with the
  deferred-directional split (tile renderer with bump and aux planes,
  shadow map, lit-tile PCF, resolve, bloom) and the unsplit fused frame
  without the in-kernel cull (depth prepass, per-tile light lists, shadow
  map, PCF from the prepass depth, tile renderer with bump and the
  visibility plane, bloom), each against the JAX package's
  staged frame (render_stats with use_pallas off, run op by op) on the same
  scene, given JAX's inverse view-projection: max |du8| <= 1 on fewer than
  2% of pixels (test_fused.py's config-4 contract), and equal overflow;
  each also with the window-gather PCF (shadow_window_gather), bit-equal
  to the frame without it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.fused import directional_resolve_pallas

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import fused

JCFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=True, shadows=True, normal_mapping=True,
    bloom=True, deferred_directional=True, inkernel_light_cull=True, max_lights_per_tile=128,
    shadow_vis_downsample=1, shadow_map_size=128,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def test_resolve_plain_matches_jax():
    rng = np.random.default_rng(12)
    H, W = 64, 256
    n = rng.normal(size=(3, H, W)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    depth = rng.uniform(0.95, 1.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 1.0
    mid = np.where(depth < 1.0, rng.integers(0, 6, (H, W)), -1).astype(np.float32)
    planes = np.concatenate([rng.uniform(0, 2, (3, H, W)).astype(np.float32), depth[None], n, mid[None]])
    vis = rng.uniform(0, 1, (H, W)).astype(np.float32)
    mats = np.zeros((8, 8), np.float32)
    mats[:6, :4] = rng.uniform(0.05, 0.95, (6, 4))
    mats[:6, 4] = rng.integers(1, 4, 6) / 3.0  # 2-bit roughness, as the G-buffer stores it
    light = tp.random_point_lights(4, cfg=TCFG, device="cpu")
    inv_vp = torch.linalg.inv(tp.ops.transform.frame_matrices(
        tp.make_scene(tp.build_scene_geometry([tp.procedural.cube(1.0)]), TCFG, device="cpu"), TCFG)[1])
    u = tp.ops.lighting_cuda.make_uniforms(torch.tensor([0.3, 1.0, -8.0]), light, TCFG, inv_vp, W, H)
    ref = directional_resolve_pallas(planes, vis, mats, u.numpy(), JCFG, n_mats=6, interpret=True)
    before = fused.directional_resolve.launches
    got = fused.directional_resolve(*(torch.from_numpy(a) for a in (planes, vis, mats)), u)
    assert fused.directional_resolve.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)
    covered = depth < 1.0
    assert float(np.abs(np.asarray(ref) - planes[:3])[:, covered].mean()) > 1e-3  # the term is there
    np.testing.assert_array_equal(got.numpy()[:, ~covered], planes[:3][:, ~covered])


@pytest.fixture(scope="module")
def jax_frame():
    """The JAX staged config-4 frame and its overflow on the small scene."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, JCFG, lights=dxr.random_point_lights(16, cfg=JCFG),
                                        placement="grid", materials=dxr.Materials.varied(geo.num_meshes)),
                         0.5, JCFG)
    frame, stats = dxr.frame.render_stats(jstate, dataclasses.replace(JCFG, use_pallas=False))
    return jstate, np.asarray(frame), int(stats["overflow"])


FUSED_PATHS = {
    "staged": dict(fused=False),
    "fused_split": dict(fused=True),
    "unsplit": dict(fused=True, deferred_directional=False, inkernel_light_cull=False),
}


FRAME_CASES = [(path, window) for window in (False, True) for path in FUSED_PATHS]


@pytest.mark.parametrize("fused_path, window", FRAME_CASES,
                         ids=[path + ("-window_pcf" if window else "") for path, window in FRAME_CASES])
def test_config4_frame_matches_jax_staged(jax_frame, fused_path, window, monkeypatch):
    """Given JAX's inverse view-projection: the two packages' LU inverses
    differ in the last bits, and a light-space tap within 1 ULP of a
    shadow-map texel then flips (without it, 1 pixel of 16,384 moves by 7
    LSB on this scene).  With the window-gather PCF (shadow_window_gather)
    each frame is also bit-equal to the same frame without it."""
    jstate, ref, jov = jax_frame
    monkeypatch.setattr(torch.linalg, "inv_ex", lambda a: (
        torch.from_numpy(np.array(jnp.linalg.inv(a.numpy()))), torch.zeros((), dtype=torch.int32)))
    state = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    cfg = dataclasses.replace(TCFG, shadow_window_gather=window, **FUSED_PATHS[fused_path])
    frame, stats = tp.render_stats(state, cfg)
    if window:
        quad, quad_stats = tp.render_stats(state, dataclasses.replace(cfg, shadow_window_gather=False))
        assert torch.equal(frame, quad) and int(quad_stats["overflow"]) == 0
    diff = np.abs(frame.numpy().astype(int) - ref.astype(int)).max(-1)
    assert frame.shape == ref.shape == (64, 256, 3)
    assert diff.max() <= 1, f"max u8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.02
    assert int(stats["overflow"]) == jov == 0
    assert (ref.max(-1) > 0).mean() > 0.2  # not blank
