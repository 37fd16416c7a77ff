"""PyTorch port: the fused tile renderer against the JAX mono-kernel.

The plain version of the fused tile kernel (fused_tiles_reference, which the
port's wrapper runs on CPU tensors) is fed the JAX setup's records through
the port's binning, and its frame is held against JAX render_fused run as
the JAX tests run it on the CPU (interpret=True), at a grid that divides the
frame and at one with padded tiles.  Contract (test_fused.py): max |du8| <= 1,
fewer than 1% of pixels different, and equal overflow counts, including a
case where the in-kernel light cull overflows its slots.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.fused import render_fused as jax_render_fused
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting_cuda
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.lighting import inverse_view_proj
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed

BASE = dxr.RendererConfig(
    width=256, height=64, tile_h=8, tile_w=128, shading="pbr", use_pallas=False,
    max_tris_per_tile=2048, inkernel_light_cull=True,
)
CASES = {
    "256x64": (BASE, 3.0),
    "200x60_padded": (dataclasses.replace(BASE, width=200, height=60), 3.0),
    # Radius 50 reaches every tile: all 24 lights live per covered tile,
    # beyond the 16 compaction slots of max_live_lights_per_tile=8.
    "light_overflow": (
        dataclasses.replace(BASE, max_lights_per_tile=32, max_live_lights_per_tile=8), 50.0),
}

_jax_frame = jax.jit(
    functools.partial(jax_render_fused, interpret=True, return_overflow=True),
    static_argnums=(1,),
)


def _state(cfg, radius):
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.make_scene(
        geo, cfg, lights=dxr.random_point_lights(24, cfg=cfg, radius=radius),
        placement="grid", materials=dxr.Materials.varied(geo.num_meshes),
    )
    return dxr.animate(state, cfg.yaw_per_frame, cfg)


def _port_frame(state, cfg):
    """The JAX setup's records -> port binning -> plain tile renderer."""
    tris, view_proj = jax_setup(state, cfg)
    packed = torch.from_numpy(np.array(tris.packed))
    tcfg = tp.RendererConfig(**dataclasses.asdict(cfg))
    binned = bin_triangles(
        packed, torch.from_numpy(np.array(tris.aabb)), torch.from_numpy(np.array(tris.valid)), tcfg
    )
    port_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    nty, ntx = -(-cfg.height // cfg.tile_h), -(-cfg.width // cfg.tile_w)
    L = port_state.lights.num_point
    color, tile_overflow = fused.fused_tiles_reference(
        binned.counts, binned.offs, binned.stream,
        fused.build_light_table(port_state.lights),
        fused.build_material_table(port_state.materials, cfg.gamma),
        lighting_cuda.make_uniforms(port_state.camera.eye, port_state.lights, tcfg,
                                    inverse_view_proj(torch.from_numpy(np.array(view_proj))),
                                    cfg.width, cfg.height),
        nty=nty, ntx=ntx, tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_lights=L,
        ik_slots=fused.live_light_slots(tcfg, L), gamma=cfg.gamma,
    )
    frame = torch.round(torch.clamp(color[:, : cfg.height, : cfg.width], 0.0, 1.0) * 255.0)
    overflow = int(binned.overflow) + int(tile_overflow.sum())
    return frame.to(torch.uint8).permute(1, 2, 0).numpy(), overflow, tris


@pytest.fixture(scope="module")
def frames():
    """case -> (JAX frame, JAX overflow, port frame, port overflow, records)."""
    out = {}
    for name, (cfg, radius) in CASES.items():
        state = _state(cfg, radius)
        jf, jov = _jax_frame(state, cfg)
        pf, pov, tris = _port_frame(state, cfg)
        out[name] = (np.asarray(jf), int(jov), pf, pov, tris)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tile_renderer_matches_jax(frames, case):
    jf, jov, pf, pov, _ = frames[case]
    assert pf.shape == jf.shape
    diff = np.abs(jf.astype(int) - pf.astype(int))
    assert diff.max() <= 1, f"max u8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01
    assert pov == jov
    assert (jf.max(-1) > 0).mean() > 0.2  # the frame is not blank


def test_light_overflow_is_loud(frames):
    _, jov, _, pov, _ = frames["light_overflow"]
    assert pov == jov > 0


def test_raster_oracle_matches_jax(frames):
    """The port's reference rasterizer against JAX raster_ref on the same
    records (the first 400 slots: the ground plane and the first sphere):
    winners and depths exact, normals to float32 rounding."""
    cfg = CASES["256x64"][0]
    packed = np.array(frames["256x64"][4].packed)[:400]
    ref = jax_rasterize(packed, cfg.height, cfg.width)
    got = rasterize_packed(torch.from_numpy(packed), cfg.height, cfg.width)
    assert (got.mesh_id.numpy() >= 0).mean() > 0.2
    np.testing.assert_array_equal(got.mesh_id.numpy(), np.asarray(ref.mesh_id))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal), rtol=0, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper is the plain version and launches
    nothing."""
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=128, height=16, fused=True)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=2, rings=6, segments=8))
    state = tp.make_scene(geo, cfg, lights=tp.random_point_lights(8, cfg=cfg, device="cpu"),
                          placement="grid", device="cpu")
    tris, view_proj = tp.ops.transform.setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    args = (binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
            fused.build_material_table(state.materials, cfg.gamma),
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inverse_view_proj(view_proj),
                                        cfg.width, cfg.height))
    kw = dict(nty=2, ntx=1, tile_h=8, tile_w=128, n_lights=8,
              ik_slots=fused.live_light_slots(cfg, 8), gamma=cfg.gamma)
    before = fused.fused_tiles.launches
    got = fused.fused_tiles(*args, **kw)
    ref = fused.fused_tiles_reference(*args, **kw)
    assert fused.fused_tiles.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
