"""PyTorch port: the staged frame, end to end, against the JAX package.

* Config 1 (the reference's frame: Lambert, cube + pyramid from the OBJ
  assets, loaded by the port's own loader) and the PBR frame through
  tp.step_frame on the CPU against the JAX package's golden images, with the
  contract of test_frame.py: at most 1 LSB on fewer than 0.1% of pixels.
  Config 1 runs on both rasterizer dispatches (cfg.use_pallas off: the
  reference raster; on: the tile raster's plain version).
* The staged PBR frame with cfg.use_pallas (the plain versions of the tile
  raster and lighting kernels) at 256x64 against the JAX chain composed by
  hand, since JAX render_stats takes its kernels only on a TPU: setup (op by
  op) -> rasterize_binned -> encode_gbuffer -> shade_pbr_tiled_pallas (both
  interpret=True) -> apply_post -> to_uint8.  Max |du8| <= 1, fewer than 1%
  of pixels different, equal overflow, also where the light cull overflows.
* The OBJ copy, the G-buffer pass and the scene carried across packages,
  and the default device.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import post as jpost
from d3d12_deferred_renderer_tpu.ops.gbuffer import encode_gbuffer as jax_encode
from d3d12_deferred_renderer_tpu.ops.lighting_pallas import shade_pbr_tiled_pallas
from d3d12_deferred_renderer_tpu.ops.raster_pallas import rasterize_binned as jax_rasterize_binned
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from d3d12_deferred_renderer_tpu.utils import read_png

import d3d12_deferred_renderer_tpu_torch as tp

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = torch.device("cpu")


def _golden_diff(frame, name):
    golden = read_png(os.path.join(GOLDEN, name))
    diff = np.abs(frame.numpy().astype(int) - golden.astype(int))
    return diff.max(), (diff > 0).mean()


def _reference_geometry():
    return tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj"))
                                    for m in ("cube", "pyramid")])


def _nth_frame(state, cfg, n):
    """Frame n of the reference loop: the animation clock advances every
    frame, so frames 1 .. n - 1 need not be drawn."""
    for _ in range(n - 1):
        state = tp.animate(state, cfg.yaw_per_frame, cfg)
    return tp.step_frame(state, cfg)


@pytest.mark.parametrize("name", ["cube", "pyramid"])
def test_obj_loader_matches_jax(name):
    path = os.path.join(ASSETS, f"{name}.obj")
    jm, pm = dxr.load_obj(path, prefer_native=False), tp.load_obj(path)
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(pm, f), getattr(jm, f))
        assert getattr(pm, f).dtype == getattr(jm, f).dtype
    assert pm.name == jm.name == name


@pytest.mark.parametrize("use_pallas", [False, True], ids=["reference_raster", "tile_raster"])
def test_reference_frame_matches_golden(use_pallas):
    """Config 1 at 160x90, frame 10 (test_frame.py's golden image)."""
    cfg = tp.RendererConfig(width=160, height=90, use_pallas=use_pallas)
    state = tp.make_scene(_reference_geometry(), cfg, device=CPU)
    state, frame = _nth_frame(state, cfg, 10)
    assert frame.shape == (90, 160, 3) and frame.dtype == torch.uint8
    dmax, frac = _golden_diff(frame, "reference_160x90_f10.png")
    assert dmax <= 1 and frac < 1e-3, (dmax, frac)
    _, stats = tp.render_stats(state, cfg)
    assert int(stats["overflow"]) == 0


def test_pbr_frame_matches_golden():
    """The PBR frame at 160x96, frame 3 (test_frame.py's golden image)."""
    cfg = tp.RendererConfig(width=160, height=96, use_pallas=False, shading="pbr")
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, device=CPU), placement="grid",
        materials=tp.Materials.varied(geo.num_meshes, device=CPU), device=CPU,
    )
    _, frame = _nth_frame(state, cfg, 3)
    dmax, frac = _golden_diff(frame, "pbr_160x96_f3.png")
    assert dmax <= 1 and frac < 1e-3, (dmax, frac)


def _jax_after_raster(frags, vp, state, cfg):
    gb = jax_encode(frags, state.materials, cfg)
    hdr, l_ovf = shade_pbr_tiled_pallas(gb, state.lights, cfg, vp, state.camera.eye,
                                        interpret=True, return_overflow=True)
    return jpost.to_uint8(jpost.apply_post(hdr, cfg)), l_ovf


STAGED = dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False)
STAGED_CASES = {
    "staged_flagship": (STAGED, 3.0),
    # Radius 8 reaches most of the scene: more live lights than 8 slots.
    "light_overflow": (dataclasses.replace(STAGED, max_live_lights_per_tile=8), 8.0),
}


@pytest.fixture(scope="module")
def staged_setup():
    """The JAX scene, its view-projection and its tile raster, which both
    cases share (they differ only in the lights and the live-light cap).
    The setup runs op by op, as the port's setup is pinned to it
    (tests/test_torch_setup.py): inside one jitted program XLA contracts a
    few of its products into fused multiply-adds, which moves
    near-silhouette pixels by up to 2 LSB."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, STAGED, placement="grid",
                                        materials=dxr.Materials.varied(geo.num_meshes)), 0.5, STAGED)
    tris, vp = jax_setup(jstate, STAGED)
    frags, r_ovf = jax.jit(lambda p, a: jax_rasterize_binned(p, a, STAGED, interpret=True,
                                                             return_overflow=True))(tris.packed, tris.aabb)
    return jstate, vp, frags, r_ovf


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_kernel_path_matches_jax_chain(staged_setup, case):
    cfg, radius = STAGED_CASES[case]
    jstate, vp, frags, r_ovf = staged_setup
    jstate = dataclasses.replace(jstate, lights=dxr.random_point_lights(24, cfg=cfg, radius=radius))
    jf, l_ovf = jax.jit(_jax_after_raster, static_argnums=(3,))(frags, vp, jstate, cfg)
    jov = r_ovf + l_ovf

    tcfg = tp.RendererConfig(**dataclasses.asdict(cfg))
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device=CPU)
    launches = (tp.ops.raster_tiles.raster_tiles.launches, tp.ops.lighting_cuda.shade_tiles.launches)
    pf, stats = tp.render_stats(pstate, tcfg)
    assert launches == (tp.ops.raster_tiles.raster_tiles.launches,
                        tp.ops.lighting_cuda.shade_tiles.launches)  # CPU: plain versions
    jf = np.asarray(jf)
    diff = np.abs(jf.astype(int) - pf.numpy().astype(int))
    assert pf.shape == jf.shape == (64, 256, 3)
    assert diff.max() <= 1, f"max u8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01
    assert int(stats["overflow"]) == int(jov)
    assert (int(jov) > 0) == (case == "light_overflow")
    assert (jf.max(-1) > 0).mean() > 0.2  # not blank


def test_render_gbuffer_matches_jax():
    """The geometry pass of config 1 on both raster dispatches, bit-equal to
    JAX raster_ref + encode_gbuffer on the same setup records."""
    cfg = dxr.RendererConfig(width=160, height=90, use_pallas=False)
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"),
                                                  prefer_native=False) for m in ("cube", "pyramid")])
    jstate = dxr.animate(dxr.make_scene(jgeo, cfg), 0.3)
    tcfg = tp.RendererConfig(**dataclasses.asdict(cfg))
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device=CPU)
    tris, _ = tp.ops.transform.setup_frame_triangles(pstate, tcfg)
    frags = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed.numpy(), 90, 160)
    ref = jax_encode(frags, jstate.materials, cfg)
    for use_pallas in (False, True):
        got = tp.render_gbuffer(pstate, dataclasses.replace(tcfg, use_pallas=use_pallas))
        for j, t in zip(ref, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (got.depth < 1.0).float().mean() > 0.01  # both meshes in view


def test_config1_scene_carried_across():
    """A config-1 scene made by each package from its own loader holds the
    same arrays, and arrays_from_state / scene_from_arrays carry a JAX
    state across bit for bit."""
    cfg = dxr.REFERENCE_CONFIG
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"),
                                                  prefer_native=False) for m in ("cube", "pyramid")])
    jstate = dxr.animate(dxr.make_scene(jgeo, cfg))
    pstate = tp.animate(tp.make_scene(_reference_geometry(), tp.REFERENCE_CONFIG, device=CPU))
    carried = tp.scene_from_arrays(tp.arrays_from_state(jstate), device=CPU)
    ja = tp.arrays_from_state(jstate)
    for other in (pstate, carried):
        pa = tp.arrays_from_state(other)
        assert sorted(pa) == sorted(ja)
        for key in ja:
            np.testing.assert_array_equal(pa[key], ja[key], err_msg=key)
            assert pa[key].dtype == ja[key].dtype, key


def test_make_scene_defaults_to_the_card():
    """Without device= a scene goes to the CUDA device; where there is none
    the call raises instead of building on the CPU."""
    geo = _reference_geometry()
    if torch.cuda.is_available():
        state = tp.make_scene(geo, tp.REFERENCE_CONFIG)
        assert state.position.device == torch.device("cuda", 0)
        assert tp.default_device().type == "cuda"
        return
    for make in (lambda: tp.make_scene(geo, tp.REFERENCE_CONFIG),
                 lambda: tp.random_point_lights(4),
                 lambda: tp.Materials.varied(2),
                 tp.default_device):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make()
