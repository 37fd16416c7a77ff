"""PyTorch port: the band modes of the screen-row band path against the JAX
package's band functions, on the same numpy-seeded inputs.

A band is rows [y_offset, y_offset + band_h) of a taller frame.  At 256x64
(8 x 128 tiles) on the small benchmark scene, with JAX's setup records fed
to both packages:

* binning of a band, flat and sorted (FLAT_CELLS forced to 0 on both
  sides), also where the tier budgets overflow: counts, offsets, overflow
  and the record stream equal;
* rasterize_packed on band rows, and the tile raster's and the depth-only
  raster's plain versions on a band (the kernels' CPU twins, also on a band
  of 20 rows, whose last tile row is padded): depth and mesh id bit-equal
  to JAX's rasterize_packed(px, py) on the same rows (normal and uv within
  1e-5: jitted XLA contracts its interpolations differently), and every
  plane bit-equal (int32 views) to the same rows of the port's full-frame
  call;
* the bump kernel's plain version on a band of whole tiles (row offset
  y0): bit-equal to the same rows of the full frame's call, and within
  tests/test_torch_bump.py's contract of JAX's band bump (the block form
  over the band's world positions);
* render_fused's band mode (plain versions; the in-kernel cull, and the
  depth prepass with the per-tile lists) against JAX render_fused(...,
  interpret=True, band_h, y_offset): the linear HDR after Reinhard and
  gamma within 1 u8 on fewer than 1% of pixels (test_torch_fused.py's
  contract), equal overflow; the fused tile kernel's plain version on a
  band bit-equal to the full frame's rows.  (The fused band with shadows
  runs in tests/test_torch_parallel.py, against the port's single-device
  frame.)

The light cull, the lighting and the PCF on a band are in
tests/test_torch_band_light.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import bump as jbump
from d3d12_deferred_renderer_tpu.ops import lighting as jl
from d3d12_deferred_renderer_tpu.ops import raster_pallas as jrp
from d3d12_deferred_renderer_tpu.ops.fused import render_fused as jax_render_fused
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import binning, bump, fused, lighting_cuda, raster_tiles
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import TriSetup

CFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, max_tris_per_tile=2048, shadow_map_size=128,
    max_live_lights_per_tile=32,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(CFG))
# (y_offset, band_h): bands of whole tiles, and one of 20 rows (a padded
# last tile row).
BANDS = [(24, 16), (40, 24), (30, 20)]


def t(a):
    return torch.from_numpy(np.array(a))


def _i32(a):
    return a.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def scene():
    """The JAX scene (24 lights of radius 3), its setup records and the
    port's state, each computed once."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, CFG, lights=dxr.random_point_lights(24, cfg=CFG, radius=3.0),
                                        placement="grid", materials=dxr.Materials.varied(geo.num_meshes)),
                         0.5, CFG)
    tris, vp = jax.jit(jax_setup, static_argnums=(1,))(jstate, CFG)
    tstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    return dict(jstate=jstate, tstate=tstate, tris=tris, vp=vp, tvp=t(vp), inv_vp=t(jnp.linalg.inv(vp)),
                packed=t(tris.packed), aabb=t(tris.aabb), valid=t(tris.valid))


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _jax_band_bin(packed, aabb, valid, cfg, band_h, y_offset):
    return jrp.bin_triangles(packed, aabb, valid, cfg, band_h=band_h, y_offset=y_offset, stream_src=packed)


# One compiled JAX binning per path, each of its own function (jit caches
# by function): FLAT_CELLS is read at trace time (test_torch_binning.py).
_JAX_BIN = {path: jax.jit(lambda *a, **k: _jax_band_bin(*a, **k), static_argnames=("cfg", "band_h", "y_offset"))
            for path in ("sorted", "flat")}
BIN_CASES = {
    "default": {},
    # The big and small tier budgets overflow.
    "tier_overflow": dict(bin_expand=1, bin_expand_medium=2, bin_expand_large=3, bin_max_big=1,
                          bin_max_small=64),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
@pytest.mark.parametrize("path", ["sorted", "flat"])
def test_band_binning_matches_jax(scene, monkeypatch, path, case):
    cfg = dataclasses.replace(CFG, **BIN_CASES[case])
    if path == "sorted":
        monkeypatch.setattr(jrp, "FLAT_CELLS", 0)
        monkeypatch.setattr(binning, "FLAT_CELLS", 0)
    tris = scene["tris"]
    overflows = []
    for y0, bh in BANDS:
        jb = _JAX_BIN[path](tris.packed, tris.aabb, tris.valid, cfg=cfg, band_h=bh, y_offset=y0)
        tb = binning.bin_triangles(scene["packed"], scene["aabb"], scene["valid"],
                                   tp.RendererConfig(**dataclasses.asdict(cfg)), bh, y0)
        np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts)[:, 0])
        np.testing.assert_array_equal(tb.offs.numpy(), np.asarray(jb.offs))
        assert int(tb.overflow) == int(jb.overflow)
        np.testing.assert_array_equal(tb.stream.numpy(), np.asarray(jb.stream)[: tb.stream.shape[0], :32])
        assert int(tb.counts.sum()) > 0
        overflows.append(int(tb.overflow))
    assert (max(overflows) > 0) == (case == "tier_overflow" and path == "sorted")


# ---------------------------------------------------------------------------
# rasters
# ---------------------------------------------------------------------------


def _jax_band_raster(packed, y0, bh, W):
    ys = y0 + 0.5 + np.arange(bh, dtype=np.float32)
    xs = np.arange(W, dtype=np.float32) + 0.5
    py, px = np.meshgrid(ys, xs, indexing="ij")
    return jax.jit(jax_rasterize, static_argnums=(1, 2))(packed, bh, W, jnp.asarray(px), jnp.asarray(py))


def _frags_equal(got, ref):
    for name in ("depth", "normal", "uv", "mesh_id"):
        assert torch.equal(_i32(getattr(got, name)), _i32(getattr(ref, name))), name


@pytest.mark.parametrize("y0,bh", BANDS, ids=[f"{y}+{h}" for y, h in BANDS])
def test_band_rasters_match_jax_and_full_rows(scene, y0, bh):
    W = CFG.width
    ref = _jax_band_raster(np.array(scene["tris"].packed), y0, bh, W)
    got = rasterize_packed(scene["packed"], bh, W, y0)
    full = rasterize_packed(scene["packed"], CFG.height, W)
    np.testing.assert_array_equal(got.mesh_id.numpy(), np.asarray(ref.mesh_id))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(ref.uv), rtol=0, atol=1e-5)
    assert bool((got.mesh_id >= 0).any())
    _frags_equal(got, type(full)(*(a[y0 : y0 + bh] for a in full)))

    # The tile raster's and the depth raster's plain versions on the band.
    before = raster_tiles.raster_tiles.launches, raster_tiles.raster_depth.launches
    args = (scene["packed"], scene["aabb"], scene["valid"], TCFG)
    band = raster_tiles.rasterize_binned(*args, band_h=bh, y_offset=y0)
    depth = raster_tiles.rasterize_depth(*args, band_h=bh, y_offset=y0)
    assert (raster_tiles.raster_tiles.launches, raster_tiles.raster_depth.launches) == before
    whole = raster_tiles.rasterize_binned(*args)
    _frags_equal(band, type(whole)(*(a[y0 : y0 + bh] for a in whole)))
    assert torch.equal(depth, band.depth)
    _frags_equal(band, got)


@pytest.mark.parametrize("y0,bh", [b for b in BANDS if b[1] % 8 == 0],
                         ids=[f"{y}+{h}" for y, h in BANDS if h % 8 == 0])
def test_band_bump_matches_full_rows_and_jax(scene, y0, bh):
    """The bump kernel's plain version on a band of whole tiles (its row
    offset y0): all 8 planes bit-equal to the same rows of the full frame's
    call; the normals within test_torch_bump.py's contract (5e-4, fewer
    than 1% of values beyond 1e-4) of JAX's band bump, the block form over
    reconstruct_world_positions(..., y_offset, full_height) of the band's
    rasterize_packed fragments."""
    H, W = CFG.height, CFG.width
    jcfg = dataclasses.replace(CFG, normal_mapping=True)
    kw = dict(width=W, height=H, tile_h=8, tile_w=128, strength=jcfg.bump_strength, freq=jcfg.bump_frequency)

    def bumped(band_h, off):
        b = binning.bin_triangles(scene["packed"], scene["aabb"], scene["valid"], TCFG, band_h, off)
        planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, nty=band_h // 8, ntx=2, tile_h=8,
                                           tile_w=128, y0=off)
        return bump.bump_tiles(planes, scene["inv_vp"], y0=off, **kw)

    band = bumped(bh, y0)
    assert torch.equal(_i32(band), _i32(bumped(H, 0)[:, y0 : y0 + bh]))
    jfr = _jax_band_raster(np.array(scene["tris"].packed), y0, bh, W)
    world = jl.reconstruct_world_positions(jfr.depth, scene["vp"], jcfg, y_offset=y0, full_height=H)
    ref = np.asarray(jbump.apply_normal_mapping(jfr, world, jcfg, jcfg.bump_strength, jcfg.bump_frequency).normal)
    d = np.abs(band[1:4].permute(1, 2, 0).numpy() - ref)
    assert d.max() <= 5e-4 and (d > 1e-4).mean() < 0.01, (d.max(), (d > 1e-4).mean())
    assert (ref != np.asarray(jfr.normal)).any(-1).mean() > 0.2  # the band was bumped


# ---------------------------------------------------------------------------
# lighting

# ---------------------------------------------------------------------------
# the fused tile renderer
# ---------------------------------------------------------------------------

FUSED = dataclasses.replace(CFG, fused=True, use_pallas=False, inkernel_light_cull=True)
FUSED_CASES = {
    "inkernel_cull": (FUSED, (24, 16)),
    # The depth prepass and the light cull's per-tile lists.
    "lists": (dataclasses.replace(FUSED, inkernel_light_cull=False), (32, 32)),
}
_jax_fused_jit = jax.jit(
    functools.partial(jax_render_fused, interpret=True, return_overflow=True),
    static_argnames=("cfg", "band_h", "y_offset"),
)


def _u8(hdr, gamma):
    x = torch.pow(torch.clamp(hdr / (1.0 + hdr), min=0.0), 1.0 / gamma)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32)


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_band_matches_jax(scene, case):
    cfg, (y0, bh) = FUSED_CASES[case]
    jhdr, jov = _jax_fused_jit(scene["jstate"], cfg=cfg, band_h=bh, y_offset=y0)
    setup = (TriSetup(packed=scene["packed"], aabb=scene["aabb"], valid=scene["valid"]), scene["tvp"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "setup_frame_triangles", lambda s, c: setup)
        mp.setattr(fused, "inverse_view_proj", lambda vp: scene["inv_vp"])
        hdr, ov = fused.render_fused(scene["tstate"], tp.RendererConfig(**dataclasses.asdict(cfg)),
                                     return_overflow=True, band_h=bh, y_offset=y0)
    assert hdr.shape == (bh, CFG.width, 3)
    diff = (_u8(hdr, cfg.gamma) - _u8(t(jhdr), cfg.gamma)).abs().amax(-1)
    assert int(diff.max()) <= 1 and float((diff > 0).double().mean()) < 0.01
    assert int(ov) == int(jov)
    assert float((hdr.amax(-1) > 0).double().mean()) > 0.2
    with pytest.raises(ValueError, match="multiple of tile_h"):
        fused.render_fused(scene["tstate"], tp.RendererConfig(**dataclasses.asdict(cfg)), band_h=12)


def test_fused_tile_kernel_band_equals_full_rows(scene):
    """The plain tile renderer on a band of whole tiles: the band's binning
    and U_Y0 give the same rows as the full frame's call, bit for bit."""
    tcfg = tp.RendererConfig(**dataclasses.asdict(FUSED))
    li, L = scene["tstate"].lights, scene["tstate"].lights.num_point
    tables = (fused.build_light_table(li), fused.build_material_table(scene["tstate"].materials, tcfg.gamma))

    def run(bh, y0):
        b = binning.bin_triangles(scene["packed"], scene["aabb"], scene["valid"], tcfg, bh, y0)
        u = lighting_cuda.make_uniforms(scene["tstate"].camera.eye, li, tcfg, scene["inv_vp"], tcfg.width,
                                        tcfg.height, y0)
        return fused.fused_tiles(b.counts, b.offs, b.stream, *tables, u, nty=bh // 8, ntx=2, tile_h=8,
                                 tile_w=128, n_lights=L, ik_slots=fused.live_light_slots(tcfg, L),
                                 gamma=tcfg.gamma, hdr_out=True)

    full, full_ovf = run(64, 0)
    band, band_ovf = run(24, 40)
    assert torch.equal(_i32(band), _i32(full[:, 40:64]))
    assert torch.equal(band_ovf, full_ovf[10:])
