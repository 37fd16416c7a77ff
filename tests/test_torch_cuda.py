"""PyTorch port: each CUDA kernel against its plain PyTorch version, and the
staged frame through the entry points, on the card.

These tests need a CUDA device and skip without one.  This file imports no
JAX (the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py makes the same comparisons at the flagship size.
"""
import dataclasses

import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import fused, lighting, lighting_cuda, raster_tiles, setup_cuda
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.transform import (
    frame_matrices,
    setup_frame_triangles,
    setup_triangles_reference,
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scene(cfg, dev, n_lights=24, radius=3.0):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(n_lights, cfg=cfg, radius=radius, device=dev),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=dev), device=dev,
    )
    return tp.animate(state, cfg.yaw_per_frame, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_setup_kernel_matches_plain(cull):
    """Bit-equal records and boxes: both round every operation once, in one
    order."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=640, height=384)
    state = _scene(cfg, dev)
    model, _, mvp = frame_matrices(state, cfg)
    g = state.geometry
    args = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id, mvp, model,
            cfg.width, cfg.height)
    before = setup_cuda.setup_triangles.launches
    got = setup_cuda.setup_triangles(*args, cull=cull)
    ref = setup_triangles_reference(*args, cull=cull)
    torch.cuda.synchronize()
    assert setup_cuda.setup_triangles.launches == before + 1
    assert torch.equal(got.packed, ref.packed)
    assert torch.equal(got.aabb, ref.aabb)


@pytest.mark.cuda
@pytest.mark.parametrize("size,live,radius", [
    ((256, 64), 128, 3.0), ((200, 60), 128, 3.0), ((256, 64), 8, 50.0),
], ids=["256x64", "200x60_padded", "light_overflow"])
def test_tile_kernel_matches_plain(size, live, radius):
    """Equal per-tile overflow, frames within 1 u8 LSB."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=size[0], height=size[1], fused=True,
                              max_live_lights_per_tile=live)
    state = _scene(cfg, dev, radius=radius)
    tris, view_proj = setup_frame_triangles(state, cfg)
    binned = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    args = (binned.counts, binned.offs, binned.stream, fused.build_light_table(state.lights),
            fused.build_material_table(state.materials, cfg.gamma),
            fused.build_uniforms(state, cfg, view_proj))
    kw = dict(nty=-(-cfg.height // 8), ntx=-(-cfg.width // 128), tile_h=8, tile_w=128,
              n_lights=L, ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma)
    before = fused.fused_tiles.launches
    got, got_ovf = fused.fused_tiles(*args, **kw)
    ref, ref_ovf = fused.fused_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fused.fused_tiles.launches == before + 1
    assert torch.equal(got_ovf, ref_ovf)
    assert (int(got_ovf.sum()) > 0) == (live == 8)
    d = (torch.round(got.clamp(0, 1) * 255) - torch.round(ref.clamp(0, 1) * 255)).abs()
    assert float(d.max()) <= 1.0
    assert float((d > 0).double().mean()) < 0.01


@pytest.mark.cuda
def test_wrappers_reject_bad_input():
    dev = _cuda()
    pos = torch.zeros((3, 3, 4), device=dev)
    mvp = torch.zeros((1, 4, 4), device=dev)
    with pytest.raises(TypeError):
        setup_cuda.setup_triangles(pos, pos, pos[:, :2].contiguous(), torch.zeros(4, device=dev),
                                   mvp, mvp, 8, 8)
    with pytest.raises(ValueError):
        setup_cuda.setup_triangles(pos, pos, pos[:, :2].contiguous(),
                                   torch.zeros(4, dtype=torch.int32, device=dev),
                                   mvp.cpu(), mvp, 8, 8)


# ---- the staged frame: tile raster (K6) and G-buffer lighting (K7) kernels ----


def _binned(cfg, dev):
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    return state, bin_triangles(tris.packed, tris.aabb, tris.valid, cfg), view_proj


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(256, 64), (200, 60)], ids=["256x64", "200x60_padded"])
def test_raster_kernel_matches_plain(size):
    """Depth, mesh id and pad planes bit-equal; normal and uv bit-equal or
    within 2e-6."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=size[0], height=size[1], fused=False)
    _, binned, _ = _binned(cfg, dev)
    kw = dict(nty=-(-cfg.height // 8), ntx=-(-cfg.width // 128), tile_h=8, tile_w=128)
    before = raster_tiles.raster_tiles.launches
    got = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream, **kw)
    ref = raster_tiles.raster_tiles_reference(binned.counts, binned.offs, binned.stream, **kw)
    torch.cuda.synchronize()
    assert raster_tiles.raster_tiles.launches == before + 1
    for p in (raster_tiles.PLANE_DEPTH, raster_tiles.PLANE_MID, raster_tiles.PLANE_PAD):
        assert torch.equal(got[p], ref[p]), p
    assert float((got - ref).abs().max()) <= 2e-6
    assert float((got[raster_tiles.PLANE_MID] >= 0).double().mean()) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("vis", [False, True], ids=["no_vis", "vis"])
def test_shade_kernel_matches_plain(vis):
    """Linear HDR within rtol 2e-4, atol 2e-5 (the JAX kernel's contract)."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=False)
    state = _scene(cfg, dev)
    gb = tp.render_gbuffer(state, cfg)
    visp = None
    if vis:
        visp = torch.rand((64, 256), generator=torch.Generator().manual_seed(11)).to(dev)
    _, view_proj, _ = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    tl = lighting.cull_lights_to_tiles(gb.depth, state.lights, cfg, view_proj, tile=(8, 128),
                                       max_per_tile=24, inv_vp=inv_vp)
    args = (lighting_cuda.gbuffer_planes(gb, 64, 256, visp),
            lighting_cuda.build_light_table(state.lights), tl.indices.reshape(16, -1),
            tl.counts.reshape(16),
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inv_vp, 256, 64))
    kw = dict(nty=8, ntx=2, tile_h=8, tile_w=128, gamma=cfg.gamma)
    before = lighting_cuda.shade_tiles.launches
    got = lighting_cuda.shade_tiles(*args, **kw)
    ref = lighting_cuda.shade_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert lighting_cuda.shade_tiles.launches == before + 1
    assert int(tl.counts.max()) > 0
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["config1", "staged_flagship"])
def test_staged_step_frame_on_the_card(config):
    """tp.step_frame on the card launches the setup and tile raster kernels
    (and, for PBR, the lighting kernel) once a frame, and agrees with the
    same frame rendered by the plain versions on the CPU."""
    dev = _cuda()
    if config == "config1":
        cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=320, height=180)
        geo = tp.build_scene_geometry([tp.procedural.cube(1.0), tp.procedural.cube(0.7)])
        state = tp.make_scene(geo, cfg, device=dev)
    else:
        cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=False)
        state = _scene(cfg, dev)
    counters = (setup_cuda.setup_triangles, raster_tiles.raster_tiles, lighting_cuda.shade_tiles)
    before = [k.launches for k in counters]
    for _ in range(3):
        state, frame = tp.step_frame(state, cfg)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(counters, before)]
    assert launched == [3, 3, 3 if cfg.shading == "pbr" else 0]
    cpu_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    plain, stats = tp.render_stats(cpu_state, cfg)
    assert int(stats["overflow"]) == 0
    d = (frame.cpu().int() - plain.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01
    assert float((frame.amax(-1) > 0).double().mean()) > 0.02


@pytest.mark.cuda
def test_make_scene_defaults_to_the_card():
    _cuda()
    geo = tp.build_scene_geometry([tp.procedural.cube(1.0)])
    state = tp.make_scene(geo, tp.REFERENCE_CONFIG)
    for t in (state.position, state.geometry.fv_pos_cols, state.lights.direction,
              state.materials.albedo, state.camera.eye, state.time):
        assert t.device == torch.device("cuda", 0)


@pytest.mark.cuda
def test_staged_wrappers_reject_bad_input():
    dev = _cuda()
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    offs = torch.zeros(3, dtype=torch.int32, device=dev)
    stream = torch.zeros((4, 32), device=dev)
    kw = dict(nty=1, ntx=2, tile_h=8, tile_w=128)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        raster_tiles.raster_tiles(counts.cpu(), offs, stream, **kw)
    with pytest.raises(TypeError):
        raster_tiles.raster_tiles(counts.float(), offs, stream, **kw)
    with pytest.raises(ValueError):
        raster_tiles.raster_tiles(counts, offs, torch.zeros((32, 4), device=dev).t(), **kw)
    planes = torch.zeros((9, 8, 256), device=dev)
    args = [planes, torch.zeros((1, 8), device=dev), torch.zeros((2, 4), dtype=torch.int32, device=dev),
            counts, torch.zeros(32, device=dev)]
    skw = dict(nty=1, ntx=2, tile_h=8, tile_w=128, gamma=2.2)
    for i, bad in ((3, counts.cpu()), (1, torch.zeros((2, 16), device=dev)[:, ::2]),
                   (2, args[2].long()), (3, counts[:1]), (0, planes[:8])):
        broken = list(args)
        broken[i] = bad
        with pytest.raises((ValueError, TypeError)):
            lighting_cuda.shade_tiles(*broken, **skw)
