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
* the samplers bit-equal; dense, sparse and sparse + lit PCF visibility
  bit-equal (given JAX's inverse view-projection), with equal overflow,
  also where the tile cap overflows.
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
    """The JAX scene and its light-view records, camera depth and shadow
    map, each computed once."""
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
    tris, vp = jax_setup(jstate, JCFG)
    depth = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, 64, 256).depth
    return dict(jstate=jstate, tstate=tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu"),
                lvp=lvp, scfg=scfg, ltris=ltris, sd=sd, s_ovf=s_ovf, vp=vp, depth=depth,
                inv_vp=jnp.linalg.inv(vp))


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


VIS_CASES = {
    "dense": (dict(shadow_tiles_cap=0), False),
    "sparse": (dict(), False),
    "sparse_lit": (dict(), True),
    "cap_overflow": (dict(shadow_tiles_cap=3, shadow_tiles_cap_lit=0), False),
}


@pytest.mark.parametrize("case", sorted(VIS_CASES))
def test_visibility_matches_jax(scene, case):
    change, lit = VIS_CASES[case]
    jcfg = dataclasses.replace(JCFG, **change)
    lit_mask = np.random.default_rng(9).uniform(0, 1, (64, 256)) < 0.5 if lit else None
    ref, jov = jsh.shadow_visibility(scene["depth"], scene["vp"], scene["sd"], scene["lvp"], jcfg,
                                     return_overflow=True, lit_mask=lit_mask)
    got, tov = shadows.shadow_visibility(
        t(scene["depth"]), t(scene["vp"]), t(scene["sd"]), t(scene["lvp"]),
        tp.RendererConfig(**dataclasses.asdict(jcfg)), return_overflow=True,
        lit_mask=None if lit_mask is None else t(lit_mask), inv_vp=t(scene["inv_vp"]),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(tov) == int(jov) == (1 if case == "cap_overflow" else 0)
    assert 0.0 < float((got < 1.0).double().mean()) < 0.9  # some pixels in shadow
