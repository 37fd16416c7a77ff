"""PyTorch port: shadow mapping (config 4) against the JAX package.

At 256x64 with a 128^2 shadow map on the small benchmark scene, the JAX
side run op by op (as the port's setup is pinned to it):

* orthographic_lh and light_view_proj bit-equal, on both sides of the
  up-vector switch;
* the depth-only light-view setup (the plain version of the depth-only
  setup kernel) against JAX's _fv_transform_cols(attrs=False) +
  _setup_cols: test_setup_pallas's contract, fields 12-26 zero;
* the shadow map bit-equal to JAX render_shadow_map on both raster
  dispatches, and the depth-only tile raster at the shadow map's 16 x 128
  tiles bit-equal to JAX rasterize_depth (interpret mode) and to the depth
  plane of the full tile raster;
* the samplers bit-equal; pack_cmp_windows bit-equal to JAX's window
  table; the window-gather PCF on JAX's blocker scene;
* calibrated light-view tiers (shadow_bin_tiers) in shadow_bin_config.

The PCF visibility against JAX's is in tests/test_torch_shadow_vis.py and
tests/test_torch_shadow_pcf.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import sampling as jsamp
from d3d12_deferred_renderer_tpu.ops import shadows as jsh
from d3d12_deferred_renderer_tpu.ops.raster_pallas import rasterize_depth as jax_rasterize_depth
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import _fv_transform_cols, _setup_cols
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from test_setup_pallas import _assert_setup_close
from test_shadows import _blocker_scene

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import raster_tiles, sampling, setup_cuda, shadows
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles

JCFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, shadows=True, shadow_map_size=128,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The JAX scene and its light-view records and shadow map, each
    computed once."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, JCFG, lights=dxr.random_point_lights(16, cfg=JCFG),
                                        placement="grid", materials=dxr.Materials.varied(geo.num_meshes)),
                         0.5, JCFG)
    lvp = jsh.light_view_proj(jstate.lights.direction)
    scfg = jsh.shadow_bin_config(JCFG, geo.num_triangles)
    model = dxr.xmath.model_matrix(jstate.position, jstate.orientation, jstate.scale)
    c, _, _ = _fv_transform_cols(jstate.geometry, model @ lvp, model, attrs=False)
    ltris = _setup_cols(c, None, None, jstate.geometry.tri_mesh_id, scfg, cull="none")
    sd, _, s_ovf = jsh.render_shadow_map(jstate, JCFG, return_overflow=True)
    return dict(jstate=jstate, tstate=tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu"),
                lvp=lvp, scfg=scfg, ltris=ltris, sd=sd, s_ovf=s_ovf)


def test_light_view_matrices_bit_equal(scene):
    np.testing.assert_array_equal(shadows.orthographic_lh(24.0, 24.0, 0.1, 60.0).numpy(),
                                  np.asarray(jsh.orthographic_lh(24.0, 24.0, 0.1, 60.0)))
    for d in (scene["jstate"].lights.direction, jnp.asarray([0.05, -1.0, 0.02], jnp.float32)):
        np.testing.assert_array_equal(shadows.light_view_proj(t(d)).numpy(),
                                      np.asarray(jsh.light_view_proj(d)))


def test_depth_setup_matches_jax(scene):
    ref = scene["ltris"]
    before = setup_cuda.setup_depth_triangles.launches
    scfg = shadows.shadow_bin_config(TCFG, scene["jstate"].geometry.tri_mesh_id.shape[0])
    got = shadows.setup_light_view_triangles(scene["tstate"], scfg, t(scene["lvp"]))
    assert setup_cuda.setup_depth_triangles.launches == before  # CPU: the plain version
    assert np.asarray(ref.valid).sum() > 100
    _assert_setup_close(got, ref, min_exact=0.9)
    assert not got.packed[:, 12:27].any()


@pytest.mark.parametrize("use_pallas", [True, False], ids=["tile_raster", "reference_raster"])
def test_shadow_map_matches_jax(scene, use_pallas):
    sd, lvp, ovf = shadows.render_shadow_map(scene["tstate"], dataclasses.replace(TCFG, use_pallas=use_pallas),
                                             return_overflow=True)
    np.testing.assert_array_equal(lvp.numpy(), np.asarray(scene["lvp"]))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(scene["sd"]))
    assert int(ovf) == int(scene["s_ovf"]) == 0
    assert 0.05 < float((sd < 1.0).double().mean()) < 1.0


def test_depth_raster_at_shadow_tiles_matches_jax(scene):
    """rasterize_depth on the 16 x 128 shadow tiles: bit-equal to JAX's
    depth kernel (interpret mode) and to the full tile raster's depth plane
    on the same binned records."""
    scfg, ltris = scene["scfg"], scene["ltris"]
    assert (scfg.tile_h, scfg.tile_w, scfg.max_tris_per_tile) == (16, 128, 4096)
    ref = jax.jit(lambda p, a: jax_rasterize_depth(p, a, scfg, interpret=True))(ltris.packed, ltris.aabb)
    tcfg = tp.RendererConfig(**dataclasses.asdict(scfg))
    packed, aabb = t(ltris.packed), t(ltris.aabb)
    valid = packed[:, 28] > 0.0
    before = raster_tiles.raster_depth.launches
    got, ovf = raster_tiles.rasterize_depth(packed, aabb, valid, tcfg, return_overflow=True)
    assert raster_tiles.raster_depth.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(ovf) == 0
    b = bin_triangles(packed, aabb, valid, tcfg)
    full = raster_tiles.raster_tiles_reference(b.counts, b.offs, b.stream, nty=8, ntx=1, tile_h=16, tile_w=128)
    assert torch.equal(full[raster_tiles.PLANE_DEPTH], got)


def _port_vis(scene, jcfg, lit_mask, depth=None, **kw):
    """The port's shadow_visibility on the scene's JAX inputs -> (vis, overflow)."""
    return shadows.shadow_visibility(
        t(scene["depth"] if depth is None else depth), t(scene["vp"]), t(scene["sd"]), t(scene["lvp"]),
        tp.RendererConfig(**dataclasses.asdict(jcfg)), return_overflow=True,
        lit_mask=None if lit_mask is None else t(lit_mask), inv_vp=t(scene["inv_vp"]), **kw,
    )


def test_samplers_bit_equal():
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    tex3 = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (40, 60, 2)).astype(np.float32)
    ref = rng.uniform(0, 1, (40, 60)).astype(np.float32)
    np.testing.assert_array_equal(sampling.sample_bilinear_cmp(t(tex), t(uv), t(ref), 2e-3).numpy(),
                                  np.asarray(jsamp.sample_bilinear_cmp(tex, uv, ref, 2e-3)))
    for img in (tex, tex3):
        np.testing.assert_array_equal(sampling.sample_bilinear(t(img), t(uv)).numpy(),
                                      np.asarray(jsamp.sample_bilinear(img, uv)))
        np.testing.assert_array_equal(sampling.sample_nearest(t(img), t(uv)).numpy(),
                                      np.asarray(jsamp.sample_nearest(img, uv)))


def test_window_on_blocker_scene_matches_jax():
    """JAX's own window-gather scene (tests/test_shadows.py): a cube over a
    ground plane, every 8 x 128 tile slot in use (shadow_tiles_cap -1):
    the port's window path bit-equal to its quad path and to JAX's."""
    cfg = dxr.RendererConfig(width=256, height=64, use_pallas=False, shading="pbr", shadows=True,
                             shadow_map_size=128, shadow_tiles_cap=-1, shadow_window_gather=True,
                             light_direction=(-0.1, -1.0, -0.1))
    state = _blocker_scene(cfg)
    # Both packages sample the same (jitted) JAX inputs.
    tris, vp = jax.jit(jax_setup, static_argnums=(1,))(state, cfg)
    depth = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, 64, 256).depth
    sd, lvp = jax.jit(jsh.render_shadow_map, static_argnums=(1,))(state, cfg)
    ref, jov = jsh.shadow_visibility(depth, vp, sd, lvp, cfg, return_overflow=True)
    blocker = dict(depth=depth, vp=vp, sd=sd, lvp=lvp, inv_vp=jnp.linalg.inv(vp))
    got, tov = _port_vis(blocker, cfg, None)
    quad, qov = _port_vis(blocker, dataclasses.replace(cfg, shadow_window_gather=False), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, quad)
    assert int(tov) == int(qov) == int(jov) == 0
    assert 0.0 < float((got < 1.0).double().mean()) < 0.9


@pytest.mark.parametrize("shape", [(128, 128), (37, 53), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_pack_cmp_windows_matches_jax(shape):
    """JAX's window table bit for bit, and window_texels reading its rows
    straight from the map (bases -1 .. S - 1 and off the map)."""
    rng = np.random.default_rng(sum(shape))
    tex = rng.uniform(0, 1, shape).astype(np.float32)
    got = sampling.pack_cmp_windows(t(tex))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsamp.pack_cmp_windows(tex)))
    Ht, Wt = shape
    yi = torch.from_numpy(rng.integers(-1, Ht, 500))
    xi = torch.from_numpy(rng.integers(-1, Wt, 500))
    rows = got[(yi + 1) * (Wt + 1) + (xi + 1)]
    assert torch.equal(sampling.window_texels(t(tex), xi, yi).reshape(500, 16), rows)
    assert torch.equal(sampling.window_texels(t(tex), xi, yi, 2).reshape(500, 4), rows[:, [0, 1, 4, 5]])


def test_calibrated_shadow_tiers_match_jax():
    tiers = (4, 32, 512, 256, 64, 16, 26112)
    jcfg = dataclasses.replace(JCFG, shadow_bin_tiers=tiers)
    got = shadows.shadow_bin_config(tp.RendererConfig(**dataclasses.asdict(jcfg)), 1234)
    assert dataclasses.asdict(got) == dataclasses.asdict(jsh.shadow_bin_config(jcfg, 1234))
    assert (got.bin_expand, got.bin_max_small, got.tile_h) == (4, 26112, 16)
