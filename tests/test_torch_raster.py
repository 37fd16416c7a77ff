"""PyTorch port: the tile rasterizer against the JAX tile rasterizer.

The JAX setup's records go through the port's binning and the plain version
of the tile raster kernel (raster_tiles_reference, which the port's wrapper
runs on CPU tensors); JAX rasterize_binned runs as the JAX tests run it on
the CPU (interpret=True).  Contract: all 8 planes bit-equal (depth, normal,
uv, mesh id; the pad plane zero) and equal overflow, at a grid that divides
the frame, at one with padded tiles, and where the per-tile triangle cap
overflows.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.raster_pallas import rasterize_binned as jax_rasterize_binned
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import raster_tiles
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed

BASE = dxr.RendererConfig(width=256, height=64, tile_h=8, tile_w=128, max_tris_per_tile=256)
CASES = {
    "256x64": BASE,
    "200x60_padded": dataclasses.replace(BASE, width=200, height=60),
    # 16 triangles per tile: the ground plane and sphere tiles drop records.
    "tri_overflow": dataclasses.replace(BASE, max_tris_per_tile=16),
}

_jax_setup = jax.jit(jax_setup, static_argnums=(1,))
_jax_raster = jax.jit(
    lambda packed, aabb, cfg: jax_rasterize_binned(packed, aabb, cfg, interpret=True,
                                                   return_overflow=True),
    static_argnums=(2,),
)


def _records(cfg):
    """The setup records of the scene at cfg's frame size.  The setup does not
    read the per-tile cap: cases that differ only in it share one compile."""
    cfg = dataclasses.replace(cfg, max_tris_per_tile=BASE.max_tris_per_tile)
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.animate(dxr.make_scene(geo, cfg, placement="grid"), 0.7, cfg)
    return _jax_setup(state, cfg)[0]


def _port_planes(tris, cfg):
    tcfg = tp.RendererConfig(**dataclasses.asdict(cfg))
    packed, aabb, valid = (torch.from_numpy(np.array(a)) for a in (tris.packed, tris.aabb, tris.valid))
    binned = bin_triangles(packed, aabb, valid, tcfg)
    nty, ntx = -(-cfg.height // cfg.tile_h), -(-cfg.width // cfg.tile_w)
    planes = raster_tiles.raster_tiles_reference(
        binned.counts, binned.offs, binned.stream, nty=nty, ntx=ntx,
        tile_h=cfg.tile_h, tile_w=cfg.tile_w,
    )
    return planes, int(binned.overflow), tcfg


@pytest.fixture(scope="module")
def rasters():
    """case -> (JAX FragmentPlanes, JAX overflow, port planes, port overflow, records)."""
    out = {}
    for name, cfg in CASES.items():
        tris = _records(cfg)
        jf, jov = _jax_raster(tris.packed, tris.aabb, cfg)
        planes, pov, _ = _port_planes(tris, cfg)
        out[name] = (jf, int(jov), planes, pov, tris)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tile_raster_matches_jax(rasters, case):
    jf, jov, planes, pov, _ = rasters[case]
    cfg = CASES[case]
    got = raster_tiles.fragments_from_planes(planes, cfg.height, cfg.width)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(jf.depth))
    np.testing.assert_array_equal(got.normal.numpy(), np.asarray(jf.normal))
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(jf.uv))
    np.testing.assert_array_equal(got.mesh_id.numpy(), np.asarray(jf.mesh_id))
    assert not planes[raster_tiles.PLANE_PAD].any()
    assert pov == jov
    assert (got.mesh_id.numpy() >= 0).mean() > 0.2  # the frame is not empty


def test_triangle_overflow_is_loud(rasters):
    assert rasters["tri_overflow"][3] == rasters["tri_overflow"][1] > 0
    assert rasters["256x64"][3] == 0


def test_binned_raster_equals_reference_raster(rasters):
    """Without overflow the tile raster is the whole-frame reference raster,
    bit for bit (the port's raster_ref is the oracle of every raster)."""
    cfg = CASES["256x64"]
    tris = rasters["256x64"][4]
    packed = torch.from_numpy(np.array(tris.packed))
    ref = rasterize_packed(packed, cfg.height, cfg.width)
    got, ovf = raster_tiles.rasterize_binned(
        packed, torch.from_numpy(np.array(tris.aabb)), torch.from_numpy(np.array(tris.valid)),
        tp.RendererConfig(**dataclasses.asdict(cfg)), return_overflow=True,
    )
    assert int(ovf) == 0
    for f in ("depth", "normal", "uv", "mesh_id"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_wrapper_runs_plain_version_on_cpu(rasters):
    """On CPU tensors the kernel wrapper is the plain version and launches
    nothing."""
    cfg = CASES["200x60_padded"]
    tris = rasters["200x60_padded"][4]
    packed, aabb, valid = (torch.from_numpy(np.array(a)) for a in (tris.packed, tris.aabb, tris.valid))
    binned = bin_triangles(packed, aabb, valid, tp.RendererConfig(**dataclasses.asdict(cfg)))
    before = raster_tiles.raster_tiles.launches
    got = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream,
                                    nty=8, ntx=2, tile_h=8, tile_w=128)
    assert raster_tiles.raster_tiles.launches == before
    assert torch.equal(got, rasters["200x60_padded"][2])
