"""PyTorch port: the band modes of the light cull, the lighting and the PCF
against the JAX package's band functions, on the same inputs.

A band is rows [y_offset, y_offset + band_h) of a taller frame.  At 256x64
(8 x 128 tiles) on the small benchmark scene, on the port's G-buffer (its
setup and reference raster on the CPU) given to both packages:

* the light cull (exact), shade_pbr_tiled and the lighting kernel's plain
  version with y_offset / full_height, at the tolerances of
  test_torch_lighting.py (rtol 2e-4, atol 2e-5) and equal overflow; the
  lighting kernel's band bit-equal to the full frame's rows on a band of
  whole tiles;
* dense shadow_visibility on a band bit-equal to JAX's, with equal
  overflow, also for a config whose whole frame takes the sparse path;
* binning's tier budgets scaled by the full frame's area.

(Split from tests/test_torch_band.py.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import lighting as jl
from d3d12_deferred_renderer_tpu.ops import raster_pallas as jrp
from d3d12_deferred_renderer_tpu.ops import shadows as jsh
from d3d12_deferred_renderer_tpu.ops.gbuffer import GBuffer as JGBuffer
from d3d12_deferred_renderer_tpu.ops.lighting_pallas import shade_pbr_tiled_pallas
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import binning, lighting, lighting_cuda, shadows
from d3d12_deferred_renderer_tpu_torch.ops.gbuffer import GBuffer, encode_gbuffer
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

CFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, max_tris_per_tile=2048, shadow_map_size=128,
    max_live_lights_per_tile=32,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(CFG))
TOL = dict(rtol=2e-4, atol=2e-5)


# (y_offset, band_h): bands of whole tiles, and one of 20 rows (a padded
# last tile row).
BANDS = [(24, 16), (40, 24), (30, 20)]


def t(a):
    return torch.from_numpy(np.array(a))


def _i32(a):
    return a.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def scene():
    """The JAX scene (24 lights of radius 3) and the port's state, and the
    port's view-projection and G-buffer of it (setup and reference raster
    on the CPU) as both packages' tensors, each computed once."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, CFG, lights=dxr.random_point_lights(24, cfg=CFG, radius=3.0),
                                        placement="grid", materials=dxr.Materials.varied(geo.num_meshes)),
                         0.5, CFG)
    tstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    tris, tvp = setup_frame_triangles(tstate, TCFG)
    tg = encode_gbuffer(rasterize_packed(tris.packed, CFG.height, CFG.width), tstate.materials, TCFG)
    vp = jnp.asarray(tvp.numpy())
    return dict(jstate=jstate, tstate=tstate, vp=vp, tvp=tvp, inv_vp=t(jnp.linalg.inv(vp)),
                jg=JGBuffer(*(jnp.asarray(a.numpy()) for a in tg)), tg=tg)


def test_band_binning_scales_budgets_by_the_full_frame():
    """A band of a 4K frame takes the full frame's tier budgets (area scale
    4), as JAX does: budgets scaled by a band's area (scale 1) overflow the
    large tier (171 triangles of footprint 9-64 tiles against 128)."""
    cfg = dataclasses.replace(CFG, width=3840, height=2160)
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, cfg, placement="grid"), 0.5, cfg)
    tris, _ = jax.jit(jax_setup, static_argnums=(1,))(jstate, cfg)
    tcfg = tp.RendererConfig(**dataclasses.asdict(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp, "FLAT_CELLS", 0)
        mp.setattr(binning, "FLAT_CELLS", 0)
        jb = jrp.bin_triangles(tris.packed, tris.aabb, tris.valid, cfg, band_h=1080, y_offset=540,
                               stream_src=tris.packed)
        tb = binning.bin_triangles(t(tris.packed), t(tris.aabb), t(tris.valid), tcfg, 1080, 540)
        # A config whose full frame is the band's area (3840 x 540: scale 1).
        band_scaled = binning.bin_triangles(t(tris.packed), t(tris.aabb), t(tris.valid),
                                            dataclasses.replace(tcfg, height=540), 1080, 540)
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts)[:, 0])
    assert int(tb.overflow) == int(jb.overflow) == 0
    assert int(band_scaled.overflow) > 0


_jax_cull = jax.jit(
    lambda depth, li, cfg, vp, tile, cap, y0, fh: jl.cull_lights_to_tiles(
        depth, li, cfg, vp, tile, max_per_tile=cap, y_offset=y0, full_height=fh),
    static_argnums=(2, 4, 5, 6, 7),
)


_jax_tiled = jax.jit(
    lambda gb, li, cfg, vp, eye, tile, y0, fh: jl.shade_pbr_tiled(
        gb, li, cfg, vp, eye, tile=tile, y_offset=y0, full_height=fh, return_overflow=True),
    static_argnums=(2, 5, 6, 7),
)


_jax_kernel = jax.jit(
    lambda gb, li, cfg, vp, eye, y0, fh: shade_pbr_tiled_pallas(
        gb, li, cfg, vp, eye, interpret=True, y_offset=y0, full_height=fh, return_overflow=True),
    static_argnums=(2, 5, 6),
)


def _band_gb(gb, y0, bh, cls):
    return cls(*(a[y0 : y0 + bh] for a in gb))


@pytest.mark.parametrize("y0,bh", BANDS, ids=[f"{y}+{h}" for y, h in BANDS])
def test_band_lighting_matches_jax(scene, y0, bh):
    H = CFG.height
    jg, tg = _band_gb(scene["jg"], y0, bh, JGBuffer), _band_gb(scene["tg"], y0, bh, GBuffer)
    jli, tli = scene["jstate"].lights, scene["tstate"].lights
    vp, tvp, eye, teye = scene["vp"], scene["tvp"], scene["jstate"].camera.eye, scene["tstate"].camera.eye
    for tile, cap in ((8, 64), ((8, 128), 4)):
        ref = _jax_cull(jg.depth, jli, CFG, vp, tile, cap, y0, H)
        got = lighting.cull_lights_to_tiles(tg.depth, tli, TCFG, tvp, tile, max_per_tile=cap,
                                            y_offset=y0, full_height=H)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
        assert int(got.overflow) == int(ref.overflow)
        assert int(got.counts.sum()) > 0

    tile = int(np.gcd.reduce([32, bh, CFG.width]))
    ref, jov = _jax_tiled(jg, jli, CFG, vp, eye, tile, y0, H)
    got, tov = lighting.shade_pbr_tiled(tg, tli, TCFG, tvp, teye, tile=tile, return_overflow=True,
                                        y_offset=y0, full_height=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert int(tov) == int(jov)

    # The lighting kernel's plain version: against JAX's kernel, and on a
    # band of whole tiles against the same rows of its full-frame call.
    ref, jov = _jax_kernel(jg, jli, CFG, vp, eye, y0, H)
    before = lighting_cuda.shade_tiles.launches
    got, tov = lighting_cuda.shade_pbr_tiled_kernel(tg, tli, TCFG, tvp, teye, return_overflow=True,
                                                    y_offset=y0, full_height=H)
    assert lighting_cuda.shade_tiles.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert int(tov) == int(jov)
    assert float(got.max()) > 0.0
    if bh % CFG.tile_h == 0:
        full = lighting_cuda.shade_pbr_tiled_kernel(scene["tg"], tli, TCFG, tvp, teye)
        assert torch.equal(_i32(got), _i32(full[y0 : y0 + bh]))


@pytest.mark.parametrize("cap", [0, 3], ids=["dense_cfg", "sparse_cfg"])
def test_band_visibility_is_dense_and_matches_jax(scene, cap):
    """A band always takes the dense PCF, as in JAX: bit-equal, and the
    overflow of a config whose whole frame takes the sparse path (and
    overflows its 3-tile cap there) is 0 on a band on both sides."""
    jcfg = dataclasses.replace(CFG, shadows=True, shadow_tiles_cap=cap)
    tcfg = tp.RendererConfig(**dataclasses.asdict(jcfg))
    sd, lvp = jax.jit(jsh.render_shadow_map, static_argnums=(1,))(scene["jstate"], jcfg)
    for y0, bh in BANDS:
        depth = scene["jg"].depth[y0 : y0 + bh]
        ref, jov = jsh.shadow_visibility(depth, scene["vp"], sd, lvp, jcfg, y_offset=y0,
                                         full_height=CFG.height, return_overflow=True)
        got, tov = shadows.shadow_visibility(t(depth), scene["tvp"], t(sd), t(lvp), tcfg, return_overflow=True,
                                             inv_vp=scene["inv_vp"], y_offset=y0, full_height=CFG.height)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert int(tov) == int(jov) == 0
    _, full_ovf = shadows.shadow_visibility(scene["tg"].depth, scene["tvp"], t(sd), t(lvp), tcfg,
                                            return_overflow=True, inv_vp=scene["inv_vp"])
    assert int(full_ovf) == (1 if cap == 3 else 0)
