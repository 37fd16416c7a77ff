"""PyTorch port: each CUDA kernel against its plain PyTorch version, and the
staged frame through the entry points, on the card.

These tests need a CUDA device and skip without one.  This file imports no
JAX (the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py makes the same comparisons at the flagship size.
"""
import dataclasses

import numpy as np
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


# The setup kernels' cases: the benchmark scene; the near-clip scene of
# test_torch_setup.py (triangles straddle the near plane); one triangle; 333
# triangles (no multiple of any block size the kernel was timed at); 600
# instances of a cube (600 meshes, each with its own matrices).
SETUP_CASES = ["benchmark", "near_clip", "one_triangle", "ragged_333", "instanced_600"]


def _setup_case(case, dev):
    """(face-vertex columns (pos, nrm, uv, mesh id), model, mvp, lights'
    direction, cfg) of a setup case."""
    if case == "near_clip":
        cfg = tp.RendererConfig(width=256, height=128, eye=(0.0, 0.2, -0.6), at=(0.0, 0.0, 1.0), z_near=0.25)
        geo = tp.build_scene_geometry([tp.procedural.cube(1.0), tp.procedural.torus(0.8, 0.3, 8, 12)])
        state = tp.animate(tp.make_scene(geo, cfg, device=dev))
    elif case == "instanced_600":
        cfg = tp.RendererConfig(width=256, height=128)
        geo = tp.build_instanced_geometry([tp.procedural.cube(1.0)], [0] * 600)
        state = tp.animate(tp.make_scene(geo, cfg, placement="grid", device=dev))
    else:
        cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=640, height=384)
        state = _scene(cfg, dev)
    model, _, mvp = frame_matrices(state, cfg)
    g = state.geometry
    cols = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id)
    if case in ("one_triangle", "ragged_333"):
        valid = setup_triangles_reference(*cols, mvp, model, cfg.width, cfg.height, cull="none").valid
        first = int(torch.nonzero(valid)[0]) // 2 if case == "one_triangle" else 0
        n = 1 if case == "one_triangle" else 333
        cols = tuple(c[..., first:first + n].contiguous() for c in cols)
    return cols, model, mvp, state.lights.direction, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["back", "front", "none"])
@pytest.mark.parametrize("case", SETUP_CASES)
def test_setup_kernel_matches_plain(case, cull):
    """Records, boxes and valid flags bit-equal (int32 views, the sign of
    zero too): both round every operation once, in one order."""
    dev = _cuda()
    cols, model, mvp, _, cfg = _setup_case(case, dev)
    args = (*cols, mvp, model, cfg.width, cfg.height)
    before = setup_cuda.setup_triangles.launches
    got = setup_cuda.setup_triangles(*args, cull=cull)
    ref = setup_triangles_reference(*args, cull=cull)
    torch.cuda.synchronize()
    assert setup_cuda.setup_triangles.launches == before + 1
    assert torch.equal(got.packed.view(torch.int32), ref.packed.view(torch.int32))
    assert torch.equal(got.aabb.view(torch.int32), ref.aabb.view(torch.int32))
    assert torch.equal(got.valid, ref.valid)
    assert case == "one_triangle" or int(ref.valid.sum()) > 0
    if case == "near_clip" and cull == "back":
        assert bool(ref.valid[1::2].any()), "the near-clip scene never clips"


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_setup_kernel_clockwise_front_matches_the_cpu_setup(cull):
    """setup_frame_triangles(front_ccw=False) on the card (K1, with cull
    "back" and "front" swapped in the wrapper) against the same call on a
    CPU copy of the state (the plain version, bit-equal to JAX's setup:
    tests/test_torch_setup.py): records, boxes and valid flags bit-equal.
    near_clip=False, which the kernel has no mode for, is refused."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=640, height=384)
    state = _scene(cfg, dev)
    cpu_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    assert torch.equal(frame_matrices(state, cfg)[2].cpu().view(torch.int32),
                       frame_matrices(cpu_state, cfg)[2].view(torch.int32))
    before = setup_cuda.setup_triangles.launches
    got, _ = setup_frame_triangles(state, cfg, cull=cull, front_ccw=False)
    torch.cuda.synchronize()
    assert setup_cuda.setup_triangles.launches == before + 1
    ref, _ = setup_frame_triangles(cpu_state, cfg, cull=cull, front_ccw=False)
    assert torch.equal(got.packed.cpu().view(torch.int32), ref.packed.view(torch.int32))
    assert torch.equal(got.aabb.cpu().view(torch.int32), ref.aabb.view(torch.int32))
    assert torch.equal(got.valid.cpu(), ref.valid)
    assert int(ref.valid.sum()) > 0
    with pytest.raises(ValueError, match="near_clip"):
        setup_frame_triangles(state, cfg, near_clip=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_setup_kernel_is_one_launch(kernel):
    """A setup call launches its kernel once and nothing else: the kernel
    writes the valid flags itself."""
    from torch.profiler import ProfilerActivity, profile

    from d3d12_deferred_renderer_tpu_torch.ops import shadows

    dev = _cuda()
    cols, model, mvp, light_dir, cfg = _setup_case("benchmark", dev)
    if kernel == "K1":
        wrapper = setup_cuda.setup_triangles
        call = lambda: wrapper(*cols, mvp, model, cfg.width, cfg.height)  # noqa: E731
    else:
        from d3d12_deferred_renderer_tpu_torch import xmath

        wrapper = setup_cuda.setup_depth_triangles
        lmvp = xmath.matmul4_fma(model, shadows.light_view_proj(light_dir))
        call = lambda: wrapper(cols[0], cols[3], lmvp, 256, 256)  # noqa: E731
    call()
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "setup_kernel" in kernels[0], kernels
    assert out.valid.dtype == torch.bool and int(out.valid.sum()) > 0

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
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg,
                                        lighting.inverse_view_proj(view_proj), cfg.width, cfg.height))
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
    """All 8 planes bit-equal (compared as int32: the depth's sign of zero
    too)."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=size[0], height=size[1], fused=False)
    _, binned, _ = _binned(cfg, dev)
    kw = dict(nty=-(-cfg.height // 8), ntx=-(-cfg.width // 128), tile_h=8, tile_w=128)
    before = raster_tiles.raster_tiles.launches
    got = raster_tiles.raster_tiles(binned.counts, binned.offs, binned.stream, **kw)
    ref = raster_tiles.raster_tiles_reference(binned.counts, binned.offs, binned.stream, **kw)
    torch.cuda.synchronize()
    assert raster_tiles.raster_tiles.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float((got[raster_tiles.PLANE_MID] >= 0).double().mean()) > 0.2


def _ties_and_signed_zeros(counts, offs, stream):
    """The binned records with, in each tile's segment, the first two
    records at z = -0.0 and the third at +0.0, then copies of its first
    eight records (another mesh id, the third at -0.0) after the segment:
    equal-z ties that the later copy must lose, -0.0 and +0.0 winners."""
    c, o, st = counts.cpu(), offs.cpu(), stream.cpu()
    segs = []
    for t in range(c.numel()):
        seg = st[int(o[t]) : int(o[t]) + int(c[t])].clone()
        seg[:2, 6:9] = -0.0
        seg[2:3, 6:9] = 0.0
        dup = seg[:8].clone()
        dup[:, 27] += 1000.0
        dup[2:3, 6:9] = -0.0
        segs.append(torch.cat([seg, dup]))
    n = torch.tensor([s.shape[0] for s in segs], dtype=torch.int32)
    offs2 = torch.cat([torch.zeros(1, dtype=torch.int32), torch.cumsum(n, 0).to(torch.int32)])
    return n.to(stream.device), offs2.to(stream.device), torch.cat(segs).to(stream.device)


@pytest.mark.cuda
@pytest.mark.parametrize("records_per_block", [8, raster_tiles.TILE_RECORDS_PER_BLOCK], ids=["R8", "R_default"])
def test_raster_kernel_visibility_buffer_is_exact(records_per_block):
    """K6's work items merged in its visibility buffer: all 8 planes
    bit-equal to the serial plain version with a tile's records split over
    many blocks, on records with equal-z ties and signed-zero depths (the
    serial walk's -0.0 winners stay -0.0), and the depth plane equal to the
    depth kernel's (torch.equal: -0.0 == +0.0)."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=False)
    _, binned, _ = _binned(cfg, dev)
    counts, offs, stream = _ties_and_signed_zeros(binned.counts, binned.offs, binned.stream)
    assert int(counts.max()) > 32  # the densest tile splits at R = 8
    kw = dict(nty=8, ntx=2, tile_h=8, tile_w=128)
    got = raster_tiles.raster_tiles(counts, offs, stream, **kw, records_per_block=records_per_block)
    ref = raster_tiles.raster_tiles_reference(counts, offs, stream, **kw)
    depth = raster_tiles.raster_depth(counts, offs, stream, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    bits = ref[raster_tiles.PLANE_DEPTH].view(torch.int32)
    assert bool((bits == torch.iinfo(torch.int32).min).any()) and bool((bits == 0).any())
    assert not bool((ref[raster_tiles.PLANE_MID] >= 1000).any())  # the later copies lose
    assert torch.equal(got[raster_tiles.PLANE_DEPTH], depth)


@pytest.mark.cuda
@pytest.mark.parametrize("vis", [False, True], ids=["no_vis", "vis"])
def test_shade_kernel_matches_plain(vis):
    """Linear HDR bit-equal to the plain version (the JAX kernel's contract
    is rtol 2e-4, atol 2e-5)."""
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
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("vis", [False, True], ids=["no_vis", "vis"])
def test_shade_kernel_edge_tiles(vis):
    """K7 bit-equal to its plain version: a tile at
    the 128-light cap, tiles with no light, warps of background only."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=False)
    state = _scene(cfg, dev, n_lights=160, radius=50.0)
    gb = tp.render_gbuffer(state, cfg)
    gb = gb._replace(depth=gb.depth.clone())
    gb.depth[:2] = 1.0  # the first two rows of the top tiles: background warps
    _, view_proj, _ = frame_matrices(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    tl = lighting.cull_lights_to_tiles(gb.depth, state.lights, cfg, view_proj, tile=(8, 128),
                                       max_per_tile=128, inv_vp=inv_vp)
    counts = tl.counts.reshape(16).clone()
    assert int(counts.max()) == 128
    counts[3] = counts[10] = 0
    visp = torch.rand((64, 256), generator=torch.Generator().manual_seed(3)).to(dev) if vis else None
    args = (lighting_cuda.gbuffer_planes(gb, 64, 256, visp), lighting_cuda.build_light_table(state.lights),
            tl.indices.reshape(16, -1), counts,
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inv_vp, 256, 64))
    kw = dict(nty=8, ntx=2, tile_h=8, tile_w=128, gamma=cfg.gamma)
    ref = lighting_cuda.shade_tiles_reference(*args, **kw)
    got = lighting_cuda.shade_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float(ref.abs().amax()) > 0.0


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


# ---- the config-4 kernels: depth-only setup (K4), depth raster (K3), bump
# (K8), directional resolve (K5) and the tile renderer's variants (K2) ----

CONFIG4 = dataclasses.replace(
    tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True, shadows=True, normal_mapping=True,
    bloom=True, deferred_directional=True, inkernel_light_cull=True, max_lights_per_tile=128,
    shadow_vis_downsample=1, shadow_map_size=256,
)


@pytest.mark.cuda
@pytest.mark.parametrize("cull", ["none", "back", "front"])
@pytest.mark.parametrize("case", SETUP_CASES)
def test_depth_setup_kernel_matches_plain(case, cull):
    """Light-view records, boxes and valid flags bit-equal (int32 views),
    fields 12-26 zero, on the setup kernel's cases."""
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import shadows
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_depth_reference

    dev = _cuda()
    cols, model, _, light_dir, _ = _setup_case(case, dev)
    mvp = xmath.matmul4_fma(model, shadows.light_view_proj(light_dir))
    before = setup_cuda.setup_depth_triangles.launches
    got = setup_cuda.setup_depth_triangles(cols[0], cols[3], mvp, 256, 256, cull=cull)
    ref = setup_depth_reference(cols[0], cols[3], mvp, 256, 256, cull=cull)
    torch.cuda.synchronize()
    assert setup_cuda.setup_depth_triangles.launches == before + 1
    assert torch.equal(got.packed.view(torch.int32), ref.packed.view(torch.int32))
    assert torch.equal(got.aabb.view(torch.int32), ref.aabb.view(torch.int32))
    assert torch.equal(got.valid, ref.valid)
    assert not got.packed[:, 12:27].any()
    assert case == "one_triangle" or int(ref.valid.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused_frame", [True, False], ids=["fused", "staged"])
def test_instanced_600_step_frame_on_the_card(fused_frame):
    """600 meshes (instances of a cube): tp.step_frame on the card agrees
    with the same frame rendered by the plain versions on the CPU, max
    |du8| <= 1 on fewer than 1% of pixels, overflow 0 on both devices.
    The per-tile cap is raised from the flagship's 512: the far rows of the
    grid pile 703 triangles into one tile of this 256 x 128 frame."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=128, fused=fused_frame,
                              max_tris_per_tile=1024)
    geo = tp.build_instanced_geometry([tp.procedural.cube(1.0)], [0] * 600)
    state = tp.make_scene(geo, cfg, lights=tp.random_point_lights(16, cfg=cfg, radius=3.0, device=dev),
                          placement="grid", materials=tp.Materials.varied(geo.num_meshes, device=dev), device=dev)
    state, frame = tp.step_frame(state, cfg)
    _, card_stats = tp.render_stats(state, cfg)
    torch.cuda.synchronize()
    cpu_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    plain, stats = tp.render_stats(cpu_state, cfg)
    assert int(card_stats["overflow"]) == 0 and int(stats["overflow"]) == 0
    d = (frame.cpu().int() - plain.int()).abs().amax(-1)
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01
    assert float((frame.amax(-1) > 0).double().mean()) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 128), (8, 128)], ids=["shadow_16x128", "screen_8x128"])
def test_depth_raster_kernel_matches_plain(tile):
    """Depth bit-equal to the plain version and to the full tile raster
    kernel's depth plane on the same binned records."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows

    dev = _cuda()
    state = _scene(CONFIG4, dev)
    scfg = dataclasses.replace(shadows.shadow_bin_config(CONFIG4, state.geometry.tri_mesh_id.shape[0]),
                               tile_h=tile[0], tile_w=tile[1])
    tris = shadows.setup_light_view_triangles(state, scfg, shadows.light_view_proj(state.lights.direction))
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg)
    kw = dict(nty=256 // tile[0], ntx=2, tile_h=tile[0], tile_w=tile[1])
    before = raster_tiles.raster_depth.launches
    got = raster_tiles.raster_depth(b.counts, b.offs, b.stream, **kw)
    ref = raster_tiles.raster_depth_reference(b.counts, b.offs, b.stream, **kw)
    torch.cuda.synchronize()
    assert raster_tiles.raster_depth.launches == before + 1
    assert torch.equal(got, ref)
    assert 0.05 < float((got < 1.0).double().mean()) < 1.0
    if tile[0] * tile[1] <= 1024:
        full = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, **kw)
        assert torch.equal(full[raster_tiles.PLANE_DEPTH], got)


@pytest.mark.cuda
@pytest.mark.parametrize("records_per_block", [16, raster_tiles.DEPTH_RECORDS_PER_BLOCK],
                         ids=["R16", "R_default"])
def test_depth_raster_kernel_splits_heavy_tiles(records_per_block):
    """K3 on the flagship scene's 1024^2 shadow map, whose densest tiles hold
    thousands of records, so a tile splits over many blocks merged by an
    atomic minimum: equal to the serial plain version, and with one
    few records' z set to -0.0, -0.0 where the serial walk keeps it and +0.0
    (never the bits 0x80000000) in the kernel's depth."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows

    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, width=1920, height=1080, shadow_map_size=1024)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=24))
    state = tp.animate(tp.make_scene(geo, cfg, lights=tp.random_point_lights(16, cfg=cfg, device=dev),
                                     placement="grid", device=dev), cfg.yaw_per_frame, cfg)
    scfg = shadows.shadow_bin_config(cfg, geo.num_triangles)
    tris = shadows.setup_light_view_triangles(state, scfg, shadows.light_view_proj(state.lights.direction))
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, scfg)
    assert int(b.overflow) == 0 and int(b.counts.max()) > 8 * records_per_block
    S = cfg.shadow_map_size
    kw = dict(nty=S // scfg.tile_h, ntx=S // scfg.tile_w, tile_h=scfg.tile_h, tile_w=scfg.tile_w)
    stream = b.stream.clone()
    # The first records of the densest tile at z = -0.0: they win their pixels.
    row = int(b.offs[int(torch.argmax(b.counts))])
    stream[row : row + 8, 6:9] = -0.0
    got = raster_tiles.raster_depth(b.counts, b.offs, stream, records_per_block=records_per_block, **kw)
    ref = raster_tiles.raster_depth_reference(b.counts, b.offs, stream, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    neg_zero = ref.view(torch.int32) == torch.iinfo(torch.int32).min
    assert bool(neg_zero.any())
    assert not bool((got.view(torch.int32) == torch.iinfo(torch.int32).min).any())
    assert 0.05 < float((got < 1.0).double().mean()) < 1.0


def _fragments(cfg, dev):
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    return state, raster_tiles.rasterize_binned(tris.packed, tris.aabb, tris.valid, cfg), view_proj


def _raster_planes(cfg, dev, y0=0, band_h=None):
    """The tile raster kernel's planes [8, Hp, Wp] of the benchmark scene's
    frame (rows [y0, y0 + band_h) with band_h) and the frame's inverse
    view-projection."""
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    bh = band_h or cfg.height
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg, band_h, y0)
    planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, nty=-(-bh // cfg.tile_h),
                                       ntx=-(-cfg.width // cfg.tile_w), tile_h=cfg.tile_h, tile_w=cfg.tile_w, y0=y0)
    return planes, lighting.inverse_view_proj(view_proj)


def _bump_kw(cfg):
    return dict(width=cfg.width, height=cfg.height, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                strength=cfg.bump_strength, freq=cfg.bump_frequency)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1920, 1080), (200, 60)], ids=["1920x1080", "200x60_padded"])
def test_bump_kernel_matches_plain(size):
    """The bump kernel on the tile raster's planes, in place, one launch:
    every plane bit-equal (int32 views) to its plain version's: both round
    every operation once, sin in double precision alike, and the kernels'
    rsqrt equals the plain version's everywhere
    (test_bump_rsqrt_matches_plain_everywhere)."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump

    dev = _cuda()
    W, H = size
    cfg = dataclasses.replace(CONFIG4, width=W, height=H, fused=False)
    planes, inv_vp = _raster_planes(cfg, dev)
    before = bump.bump_tiles.launches
    got = bump.bump_tiles(planes.clone(), inv_vp, **_bump_kw(cfg))
    ref = bump.bump_tiles_reference(planes.clone(), inv_vp, **_bump_kw(cfg))
    torch.cuda.synchronize()
    assert bump.bump_tiles.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float((got[1:4, :H, :W] != planes[1:4, :H, :W]).any(0).double().mean()) > 0.1


@pytest.mark.cuda
def test_bump_kernel_band_matches_plain_and_full_rows():
    """The bump kernel on rows 360-719 of a 1920x1080 frame (its row offset
    y0 = 360): every plane bit-equal to its plain version's and to the same
    rows of the whole frame's call."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump

    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, width=1920, height=1080, fused=False)
    planes, inv_vp = _raster_planes(cfg, dev, 360, 360)
    full, _ = _raster_planes(cfg, dev)
    got = bump.bump_tiles(planes.clone(), inv_vp, y0=360, **_bump_kw(cfg))
    ref = bump.bump_tiles_reference(planes.clone(), inv_vp, y0=360, **_bump_kw(cfg))
    whole = bump.bump_tiles(full, inv_vp, **_bump_kw(cfg))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), whole[:, 360:720].view(torch.int32))
    assert float((got[1:4] != planes[1:4]).any(0).double().mean()) > 0.1


@pytest.mark.cuda
def test_bump_rsqrt_matches_plain_everywhere():
    """The exhaustive check behind the kernels' float32 rsqrt: over every
    float32 bit pattern with the sign bit clear, its bits equal the plain
    versions' float64 1 / sqrt rounded once."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump

    assert bump.rsqrt_mismatches(_cuda()) == 0


@pytest.mark.cuda
def test_resolve_kernel_matches_plain():
    """HDR within rtol 2e-4, atol 2e-5 (the lighting kernel's contract);
    the two share the plain directional GGX operation for operation."""
    dev = _cuda()
    cfg = CONFIG4
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    u = lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inv_vp, 256, 64)
    mats = fused.build_material_table(state.materials, cfg.gamma)
    L = state.lights.num_point
    out, _ = fused.fused_tiles_reference(
        b.counts, b.offs, b.stream, fused.build_light_table(state.lights), mats, u,
        nty=8, ntx=2, tile_h=8, tile_w=128, n_lights=L, ik_slots=fused.live_light_slots(cfg, L),
        gamma=cfg.gamma, bump=(cfg.bump_strength, cfg.bump_frequency), aux=True)
    vis = torch.rand((64, 256), generator=torch.Generator().manual_seed(5)).to(dev)
    before = fused.directional_resolve.launches
    got = fused.directional_resolve(out, vis, mats, u)
    ref = fused.directional_resolve_reference(out, vis, mats, u)
    torch.cuda.synchronize()
    assert fused.directional_resolve.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)
    assert float((got - out[:3]).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bump", "hdr_out", "split"])
def test_tile_kernel_variants_match_plain(variant):
    """The tile renderer's config-4 variants: equal tile overflow, color
    within 1 u8 LSB on fewer than 1% of pixels (after tonemap and gamma for
    linear HDR); with the split, the depth and mesh-id planes bit-equal to
    the tile raster kernel's on the same binned records, and the depth,
    normal and mesh-id planes bit-equal to the plain version's."""
    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, width=200, height=60)
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    L = state.lights.num_point
    args = (b.counts, b.offs, b.stream, fused.build_light_table(state.lights),
            fused.build_material_table(state.materials, cfg.gamma),
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg,
                                        lighting.inverse_view_proj(view_proj), cfg.width, cfg.height))
    kw = dict(nty=8, ntx=2, tile_h=8, tile_w=128, n_lights=L, ik_slots=fused.live_light_slots(cfg, L),
              gamma=cfg.gamma, bump=(cfg.bump_strength, cfg.bump_frequency) if variant != "hdr_out" else None,
              hdr_out=variant != "bump", aux=variant == "split")
    before = fused.fused_tiles.launches
    got, got_ovf = fused.fused_tiles(*args, **kw)
    ref, ref_ovf = fused.fused_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fused.fused_tiles.launches == before + 1
    assert got.shape == ref.shape == (8 if variant == "split" else 3, 64, 256)
    assert torch.equal(got_ovf, ref_ovf)
    if variant == "split":
        planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, nty=8, ntx=2, tile_h=8, tile_w=128)
        assert torch.equal(got[3], planes[raster_tiles.PLANE_DEPTH])
        assert torch.equal(got[7], planes[raster_tiles.PLANE_MID])
        # Depth, the bumped and quantized normal, and mesh id bit-equal.
        assert torch.equal(got[3:8], ref[3:8])
    color = [c[:3] for c in (got, ref)]
    if kw["hdr_out"]:
        color = [tp.ops.post.gamma_encode(tp.ops.post.reinhard(c), cfg.gamma) for c in color]
    d = (torch.round(color[0].clamp(0, 1) * 255) - torch.round(color[1].clamp(0, 1) * 255)).abs()
    assert float(d.max()) <= 1.0 and float((d > 0).double().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["staged", "fused_split"])
def test_config4_step_frame_on_the_card(config):
    """tp.step_frame of config 4 on the card launches each kernel of its
    path once a frame and agrees with the same frame rendered by the plain
    versions on the CPU: max |du8| <= 1 on fewer than 2% of pixels (the
    JAX package's config-4 contract), overflow 0.  The CPU frame takes the
    card's inverse view-projection: the two devices' LU inverses differ in
    the last bits, and a PCF tap that close to a shadow-map texel flips."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump

    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, fused=config == "fused_split")
    state = _scene(cfg, dev, n_lights=16)
    counters = (setup_cuda.setup_triangles, setup_cuda.setup_depth_triangles, raster_tiles.raster_depth,
                fused.fused_tiles, fused.directional_resolve, raster_tiles.raster_tiles, bump.bump_tiles,
                lighting_cuda.shade_tiles)
    before = [k.launches for k in counters]
    for _ in range(3):
        state, frame = tp.step_frame(state, cfg)
    torch.cuda.synchronize()
    launched = [k.launches - n for k, n in zip(counters, before)]
    fused_path = [3, 3, 3, 3, 3, 0, 0, 0]
    staged_path = [3, 3, 3, 0, 0, 3, 3, 3]
    assert launched == (fused_path if config == "fused_split" else staged_path)
    cpu_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    inv_ex = torch.linalg.inv_ex
    try:
        torch.linalg.inv_ex = lambda a: tuple(x.to(a.device) for x in inv_ex(a.to(dev)))
        plain, stats = tp.render_stats(cpu_state, cfg)
    finally:
        torch.linalg.inv_ex = inv_ex
    assert int(stats["overflow"]) == 0
    d = (frame.cpu().int() - plain.int()).abs().amax(-1)
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.02
    assert float((frame.amax(-1) > 0).double().mean()) > 0.2


# ---- the fused frame's depth prepass: K2 fed by per-tile light lists, with
# the shadow-visibility plane, and the row scatter (K9) ----


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lists", "lists_vis", "lists_vis_bump_hdr", "lists_bump_aux"])
def test_list_fed_tile_kernel_matches_plain(variant):
    """K2 reading the prepass's per-tile light lists (and the visibility
    plane): zero tile overflow, color within 1 u8 LSB on fewer than 1% of
    pixels (after tonemap and gamma for linear HDR); with aux the depth and
    mesh-id planes bit-equal to the tile raster kernel's, and the depth,
    normal and mesh-id planes bit-equal to the plain version's."""
    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, width=200, height=60, inkernel_light_cull=False)
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    grid = dict(nty=8, ntx=2, tile_h=8, tile_w=128)
    depth = raster_tiles.raster_depth(b.counts, b.offs, b.stream, **grid)[:60, :200]
    L = state.lights.num_point
    tl = lighting.cull_lights_to_tiles(depth, state.lights, cfg, view_proj, tile=(8, 128),
                                       max_per_tile=min(L, cfg.max_live_lights_per_tile), inv_vp=inv_vp)
    vis = None
    if "vis" in variant:
        vis = torch.rand((64, 256), generator=torch.Generator().manual_seed(7)).to(dev)
    args = (b.counts, b.offs, b.stream, fused.build_light_table(state.lights),
            fused.build_material_table(state.materials, cfg.gamma),
            lighting_cuda.make_uniforms(state.camera.eye, state.lights, cfg, inv_vp, 200, 60))
    aux = "aux" in variant
    kw = dict(**grid, n_lights=L, ik_slots=0, gamma=cfg.gamma,
              bump=(cfg.bump_strength, cfg.bump_frequency) if "bump" in variant else None,
              hdr_out="hdr" in variant, aux=aux, vis=vis,
              light_ids=fused.pad_light_ids_to_chunk(tl.indices.reshape(16, -1)),
              light_counts=tl.counts.reshape(-1))
    before = fused.fused_tiles.launches
    got, got_ovf = fused.fused_tiles(*args, **kw)
    ref, ref_ovf = fused.fused_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fused.fused_tiles.launches == before + 1
    assert int(tl.counts.max()) > 0
    assert torch.equal(got_ovf, ref_ovf) and not bool(got_ovf.any())
    if aux:
        planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, **grid)
        assert torch.equal(got[3], planes[raster_tiles.PLANE_DEPTH])
        assert torch.equal(got[7], planes[raster_tiles.PLANE_MID])
        assert torch.equal(got[3:8], ref[3:8])
    color = [c[:3] for c in (got, ref)]
    if kw["hdr_out"] or aux:
        color = [tp.ops.post.gamma_encode(tp.ops.post.reinhard(c), cfg.gamma) for c in color]
    d = (torch.round(color[0].clamp(0, 1) * 255) - torch.round(color[1].clamp(0, 1) * 255)).abs()
    assert float(d.max()) <= 1.0 and float((d > 0).double().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fused_listfed", "config4_fused_unsplit"])
def test_prepass_step_frame_on_the_card(config):
    """tp.step_frame of the fused frame with the depth prepass: the depth
    raster once a frame for the prepass (twice with the shadow map), the
    tile renderer once, no resolve; the frame agrees with the same frame
    rendered by the plain versions on the CPU (given the card's inverse):
    max |du8| <= 1 on fewer than 2% of pixels, overflow 0."""
    dev = _cuda()
    if config == "fused_listfed":
        cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True,
                                  inkernel_light_cull=False)
    else:
        cfg = dataclasses.replace(CONFIG4, deferred_directional=False, inkernel_light_cull=False)
    state = _scene(cfg, dev, n_lights=16)
    counters = (setup_cuda.setup_triangles, setup_cuda.setup_depth_triangles, raster_tiles.raster_depth,
                fused.fused_tiles, fused.directional_resolve)
    before = [k.launches for k in counters]
    for _ in range(3):
        state, frame = tp.step_frame(state, cfg)
    torch.cuda.synchronize()
    launched = [k.launches - n for k, n in zip(counters, before)]
    assert launched == ([3, 0, 3, 3, 0] if config == "fused_listfed" else [3, 3, 6, 3, 0])
    cpu_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    inv_ex = torch.linalg.inv_ex
    try:
        torch.linalg.inv_ex = lambda a: tuple(x.to(a.device) for x in inv_ex(a.to(dev)))
        plain, stats = tp.render_stats(cpu_state, cfg)
    finally:
        torch.linalg.inv_ex = inv_ex
    assert int(stats["overflow"]) == 0
    d = (frame.cpu().int() - plain.int()).abs().amax(-1)
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.02
    assert float((frame.amax(-1) > 0).double().mean()) > 0.2


# ---- the window-gather PCF (shadow_window_gather): plain PyTorch on the
# card; a 128^2 map keeps the small frame's bad quads under the automatic
# cap (a 256^2 map over 256x64 pixels has 854 of them, over its 512) ----

WINDOW_CONFIG4 = dataclasses.replace(CONFIG4, shadow_map_size=128)


@pytest.mark.cuda
@pytest.mark.parametrize("bad_quads_cap", [-1, 8], ids=["auto_cap", "cap_8"])
def test_window_visibility_on_the_card_matches_cpu(bad_quads_cap):
    """The window visibility on the card bit-equal to the CPU's on the same
    inputs (the frame's prepass depth and shadow map, one inverse), with
    equal overflow: 0 under the automatic cap, where it also equals the
    card's quad path; 1 at 8 bad quads."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows

    dev = _cuda()
    cfg = dataclasses.replace(WINDOW_CONFIG4, shadow_window_gather=True, shadow_bad_quads_cap=bad_quads_cap)
    state = _scene(cfg, dev, n_lights=16)
    tris, view_proj = setup_frame_triangles(state, cfg)
    b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg)
    depth = raster_tiles.raster_depth(b.counts, b.offs, b.stream, nty=8, ntx=2, tile_h=8, tile_w=128)[:64, :256]
    sd, lvp = shadows.render_shadow_map(state, cfg)
    args = (depth, view_proj, sd, lvp)
    inv_vp = lighting.inverse_view_proj(view_proj)
    got, ovf = shadows.shadow_visibility(*args, cfg, return_overflow=True, inv_vp=inv_vp)
    cpu, cpu_ovf = shadows.shadow_visibility(*(a.cpu() for a in args), cfg, return_overflow=True,
                                             inv_vp=inv_vp.cpu())
    quad = shadows.shadow_visibility(*args, dataclasses.replace(cfg, shadow_window_gather=False), inv_vp=inv_vp)
    assert torch.equal(got.cpu(), cpu)
    assert int(ovf) == int(cpu_ovf) == (1 if bad_quads_cap == 8 else 0)
    assert torch.equal(got, quad) == (bad_quads_cap != 8)
    assert 0.0 < float((got < 1.0).double().mean()) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["config4_fused_split", "config4_fused_unsplit", "config4_staged"])
def test_window_gather_frames_on_the_card(config, monkeypatch):
    """The three config-4 frames at 256x64 on the card: with
    shadow_window_gather bit-equal to the same frame without it, through
    the window rows, overflow 0, at three clocks."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows

    dev = _cuda()
    cfg = {"config4_fused_split": WINDOW_CONFIG4,
           "config4_fused_unsplit": dataclasses.replace(WINDOW_CONFIG4, deferred_directional=False,
                                                        inkernel_light_cull=False),
           "config4_staged": dataclasses.replace(WINDOW_CONFIG4, fused=False)}[config]
    window_calls = []
    window_rows = shadows._pcf_window_rows
    monkeypatch.setattr(shadows, "_pcf_window_rows", lambda *a, **k: (window_calls.append(1), window_rows(*a, **k))[1])
    state = _scene(cfg, dev, n_lights=16)
    for _ in range(3):
        state = tp.animate(state, cfg.yaw_per_frame, cfg)
        window, w_stats = tp.render_stats(state, dataclasses.replace(cfg, shadow_window_gather=True))
        quad, q_stats = tp.render_stats(state, cfg)
        assert torch.equal(window, quad)
        assert int(w_stats["overflow"]) == int(q_stats["overflow"]) == 0
    assert len(window_calls) == 3
    assert float((window.amax(-1) > 0).double().mean()) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 8192])
def test_row_scatter_kernel_matches_plain(n):
    """Bit-equal to out[idx] = val on a permutation."""
    from d3d12_deferred_renderer_tpu_torch.ops import scatter

    dev = _cuda()
    g = torch.Generator().manual_seed(n)
    idx = torch.randperm(n, generator=g).to(torch.int32).to(dev)
    val = torch.randint(0, 1 << 30, (n, 128), generator=g, dtype=torch.int32).to(dev)
    before = scatter.row_scatter.launches
    got = scatter.row_scatter(idx, val)
    ref = scatter.row_scatter_reference(idx, val)
    torch.cuda.synchronize()
    assert scatter.row_scatter.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_overflow_warning_on_the_card(capsys):
    """render on the card warns of a frame's overflow at a later render
    call, without synchronising on the frame: two frames that overflow, the
    first frame's message after the second call (the first frame finished
    in between), and none while a frame is still pending."""
    dev = _cuda()
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=1)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device=dev)
    overflow = int(tp.render_stats(state, cfg)[1]["overflow"])
    assert overflow > 0
    torch.cuda.synchronize()
    tp.frame._pending_overflow.clear()
    capsys.readouterr()
    tp.render(state, cfg)
    assert capsys.readouterr().out == ""
    torch.cuda.synchronize()
    tp.render(state, cfg)
    assert capsys.readouterr().out == tp.frame.OVERFLOW_WARNING.format(n=overflow) + "\n"
    assert len(tp.frame._pending_overflow) == 1


# The screen-row band path: bands of a 640 x 360 frame, 3 of 120 rows
# (whole 8-row tiles) and 4 of 90 (a padded last tile row).
BAND_CASES = [(120, 120), (90, 90)]


def _u8_frame(hdr, gamma):
    """Linear HDR [3, h, w] -> u8 [h, w, 3] as int32 (Reinhard, gamma)."""
    x = torch.pow(torch.clamp(hdr / (1.0 + hdr), min=0.0), 1.0 / gamma)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32).permute(1, 2, 0)


def _close_u8(a, b, frac):
    d = (a - b).abs().amax(-1)
    return int(d.max()) <= 1 and float((d > 0).double().mean()) < frac


@pytest.mark.cuda
@pytest.mark.parametrize("y0,bh", BAND_CASES, ids=["120_rows", "90_rows_padded"])
def test_band_kernels_match_plain_and_full_rows(y0, bh):
    """K6, K3, K7 and (on whole tiles) K2 on a band: against their plain
    versions on the same band inputs (K6 planes and K7 HDR bit-equal as
    int32, K3 torch.equal, K2 within 1 u8 on < 1% and equal tile overflow)
    and against the same rows of the full-frame kernel (bit-equal as int32
    on whole tiles; K6 and K3 on the padded band too; K7 there within 1 u8
    on < 1%: its band-local tiles cull their own lights)."""
    from d3d12_deferred_renderer_tpu_torch.ops.gbuffer import encode_gbuffer

    dev = _cuda()
    i32 = torch.int32
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=640, height=360, fused=False)
    H, W = cfg.height, cfg.width
    state = _scene(cfg, dev)
    tris, view_proj = setup_frame_triangles(state, cfg)
    inv_vp = lighting.inverse_view_proj(view_proj)
    li, L = state.lights, state.lights.num_point
    lt = fused.build_light_table(li)
    mats = fused.build_material_table(state.materials, cfg.gamma)

    def run(band_h, off):
        g = dict(nty=-(-band_h // 8), ntx=5, tile_h=8, tile_w=128)
        NT = g["nty"] * 5
        b = bin_triangles(tris.packed, tris.aabb, tris.valid, cfg, band_h, off)
        bargs = (b.counts, b.offs, b.stream)
        planes = raster_tiles.raster_tiles(*bargs, **g, y0=off)
        depth = raster_tiles.raster_depth(*bargs, **g, y0=off)
        gb = encode_gbuffer(raster_tiles.fragments_from_planes(planes, band_h, W), state.materials, cfg)
        tl = lighting.cull_lights_to_tiles(gb.depth, li, cfg, view_proj, tile=(8, 128), max_per_tile=L,
                                           inv_vp=inv_vp, y_offset=off, full_height=H)
        sargs = (lighting_cuda.gbuffer_planes(gb, g["nty"] * 8, W), lt, tl.indices.reshape(NT, -1),
                 tl.counts.reshape(NT), lighting_cuda.make_uniforms(state.camera.eye, li, cfg, inv_vp, W, H, off))
        hdr = lighting_cuda.shade_tiles(*sargs, **g, gamma=cfg.gamma)
        k2 = ((*bargs, lt, mats, sargs[4]),
              dict(g, n_lights=L, ik_slots=fused.live_light_slots(cfg, L), gamma=cfg.gamma, hdr_out=True))
        color, tovf = fused.fused_tiles(*k2[0], **k2[1])
        return dict(g=g, bargs=bargs, planes=planes, depth=depth, sargs=sargs, hdr=hdr, k2=k2, color=color,
                    tovf=tovf)

    full, band = run(H, 0), run(bh, y0)
    g, bargs = band["g"], band["bargs"]
    pplanes = raster_tiles.raster_tiles_reference(*bargs, **g, y0=y0)
    pdepth = raster_tiles.raster_depth_reference(*bargs, **g, y0=y0)
    phdr = lighting_cuda.shade_tiles_reference(*band["sargs"], **g, gamma=cfg.gamma)
    torch.cuda.synchronize()
    assert torch.equal(band["planes"].view(i32), pplanes.view(i32))
    assert torch.equal(band["planes"][:, :bh].view(i32), full["planes"][:, y0 : y0 + bh].view(i32))
    assert torch.equal(band["depth"], pdepth)
    assert torch.equal(band["depth"][:bh].view(i32), full["depth"][y0 : y0 + bh].view(i32))
    assert float((band["planes"][raster_tiles.PLANE_MID, :bh] >= 0).double().mean()) > 0.02
    assert torch.equal(band["hdr"].view(i32), phdr.view(i32))
    rows = full["hdr"][:, y0 : y0 + bh]
    if bh % 8 == 0:
        assert torch.equal(band["hdr"].view(i32), rows.view(i32))
        pcolor, ptovf = fused.fused_tiles_reference(*band["k2"][0], **band["k2"][1])
        torch.cuda.synchronize()
        assert torch.equal(band["tovf"], ptovf)
        assert _close_u8(_u8_frame(band["color"], cfg.gamma), _u8_frame(pcolor, cfg.gamma), 0.01)
        assert torch.equal(band["color"].view(i32), full["color"][:, y0 : y0 + bh].view(i32))
    else:
        assert _close_u8(_u8_frame(band["hdr"][:, :bh], cfg.gamma), _u8_frame(rows, cfg.gamma), 0.01)


def _one_rank_group():
    import torch.distributed as dist

    from d3d12_deferred_renderer_tpu_torch.parallel import make_rows_group
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import free_port

    make_rows_group(0, 1, f"tcp://localhost:{free_port()}", torch.device("cuda", 0), timeout_s=60.0)
    return dist


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["staged", "fused"])
def test_render_sharded_one_rank_on_the_card(config):
    """render_sharded on a one-rank group (gloo: ranks share the card) is
    the single-device frame: bit for bit on the staged path (the same
    kernels and post), within 1 u8 on < 0.2% fused (the band's post runs
    after the kernel, the whole frame's tonemap inside it)."""
    from d3d12_deferred_renderer_tpu_torch.parallel import render_sharded

    dev = _cuda()
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=640, height=360, fused=config == "fused")
    state = _scene(cfg, dev)
    dist = _one_rank_group()
    try:
        frame, stats = render_sharded(state, cfg, return_stats=True)
    finally:
        dist.destroy_process_group()
    single, sstats = tp.render_stats(state, cfg)
    assert int(stats["overflow"]) == int(sstats["overflow"]) == 0
    if config == "staged":
        assert torch.equal(frame, single)
    else:
        assert _close_u8(frame.to(torch.int32), single.to(torch.int32), 2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fused", "staged_unaligned", "config4_staged"])
def test_render_sharded_two_ranks_share_the_card(config):
    """Two band ranks on one card (gloo, spawned processes with a deadline;
    run_bands's default device): the assembled frame within 1 u8 on < 0.2%
    of the single-device frame, overflow 0 summed; 360 rows in 2 bands of
    180 (no multiple of 8) take the staged branch; the staged config 4 runs
    the bump kernel on each band's raster planes."""
    from d3d12_deferred_renderer_tpu_torch.parallel import run_bands
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import sharded_frames

    dev = _cuda()
    height = 360 if config == "staged_unaligned" else 368
    base = dataclasses.replace(CONFIG4, fused=False) if config == "config4_staged" else tp.FLAGSHIP_CONFIG
    cfg = dataclasses.replace(base, width=640, height=height, fused=config != "config4_staged")
    state = _scene(cfg, dev)
    ranks = run_bands(2, sharded_frames, ([(tp.arrays_from_state(state), cfg)],), timeout_s=300.0)
    single, sstats = tp.render_stats(state, cfg)
    for (frame, overflow), in ranks:
        assert overflow == int(sstats["overflow"]) == 0
        assert _close_u8(torch.from_numpy(frame).to(dev, torch.int32), single.to(torch.int32), 2e-3)


@pytest.mark.cuda
def test_render_tri_sharded_two_ranks_share_the_card():
    """render_tri_sharded in 2 ranks sharing the card (gloo) on the staged
    config 4 at 256x64: each rank's slice through K6, the composite, K8 on
    its 32-row composited sub-band, the shadow map (K4, K3) and K7, once
    each; the composited planes bit-equal (int32 views: the depth's sign of
    zero too) to the single-device tile raster's, the frame within 1 u8 on
    < 0.2% of the single-device staged frame, overflow 0 summed."""
    from d3d12_deferred_renderer_tpu_torch.parallel import run_bands, sharded
    from d3d12_deferred_renderer_tpu_torch.parallel.launch import counted, mesh_frames, run_calls, tri_planes

    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, fused=False)
    state = _scene(cfg, dev)
    arrays = tp.arrays_from_state(state)
    calls = [(counted, (mesh_frames, ([(arrays, cfg, (2,), ("tri",), "tri", {})],))),
             (tri_planes, ([(arrays, cfg, (2,), ("tri",), "tri", None)],))]
    ranks = run_bands(2, run_calls, (calls,), timeout_s=300.0)
    single, sstats = tp.render_stats(state, cfg)
    tris, _ = setup_frame_triangles(state, cfg)
    ref = sharded._stack_planes(raster_tiles.rasterize_binned(tris.packed, tris.aabb, tris.valid, cfg)).cpu()
    for ((frames, launches), (planes,)) in ranks:
        ((frame, overflow),) = frames
        assert overflow == int(sstats["overflow"]) == 0
        assert _close_u8(torch.from_numpy(frame).to(dev, torch.int32), single.to(torch.int32), 2e-3)
        assert {w: c for w, c in launches.items() if c} == {
            "setup_triangles": 1, "raster_tiles": 1, "bump_tiles": 1, "setup_depth_triangles": 1,
            "raster_depth": 1, "shade_tiles": 1}
        assert torch.equal(torch.from_numpy(planes).view(torch.int32), ref.view(torch.int32))


# ---- the application path (runtime/, render_batch, supersampling) ----

FUSED_SMALL = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=256, height=128, fused=True)


@pytest.mark.cuda
def test_present_queue_push_waits_for_no_other_frame():
    """push starts its frame's copy and presents the oldest frame waiting on
    that frame's event only: behind a long device sleep and a newer frame,
    push returns at once while the stream is still busy, and the newer
    frame's bytes come out right later."""
    import time

    from d3d12_deferred_renderer_tpu_torch.runtime import PresentQueue

    dev = _cuda()
    shape = (1080, 1920, 3)
    q = PresentQueue(depth=1)
    for i in range(3):  # warm the caching host allocator's pinned blocks
        q.push(torch.full(shape, i, dtype=torch.uint8, device=dev))
    list(q.drain())
    torch.cuda.synchronize()
    assert q.push(torch.full(shape, 7, dtype=torch.uint8, device=dev)) is None
    torch.cuda._sleep(int(2e9))  # over half a second of device time
    newer = torch.full(shape, 9, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    out = q.push(newer)
    dt = time.perf_counter() - t0
    busy = not torch.cuda.current_stream(dev).query()
    assert busy and dt < 0.1, (busy, dt)
    assert isinstance(out, np.ndarray) and out.shape == shape and (out == 7).all()
    last = q.present_next()
    assert (last == 9).all() and q.frames_presented == 5 and q.in_flight == 0


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True], ids=["present_queue", "delta_queue"])
def test_app_frames_equal_step_frame_on_the_card(delta):
    from d3d12_deferred_renderer_tpu_torch.runtime import App

    dev = _cuda()
    state = _scene(FUSED_SMALL, dev)
    presented = []
    with App(state, FUSED_SMALL, present_callback=lambda i, f: presented.append((i, f)),
             delta_present=delta) as app:
        app.run(8)
    assert [i for i, _ in presented] == list(range(8))
    s = state
    for _, f in presented:
        s, ref = tp.step_frame(s, FUSED_SMALL)
        np.testing.assert_array_equal(f, ref.cpu().numpy())
    assert torch.equal(app.state.time, s.time)


@pytest.mark.cuda
def test_delta_queue_bit_identical_on_the_card():
    """The same frames through a queue fed on the card and one fed on the
    CPU: every present equals its frame and both queues count the same
    bytes and misses (the pack's bytes do not depend on the device)."""
    from d3d12_deferred_renderer_tpu_torch.runtime import DeltaPresentQueue

    dev = _cuda()
    rng = np.random.default_rng(3)
    cur = np.zeros((64, 256, 3), np.uint8)
    frames = []
    for i in range(40):
        cur = cur.copy()
        if i % 13 == 12:
            cur[:] = rng.integers(0, 256, cur.shape, dtype=np.uint8)  # every tile: a tile miss
        elif i % 7 == 6:
            cur[8:16, 64:192] = i  # whole tiles: a pixel miss once calibrated
        else:
            cur[rng.integers(0, 64), rng.integers(0, 256), 0] = i
        frames.append(cur)
    queues = [DeltaPresentQueue(64, 256, depth=3) for _ in range(2)]
    outs = [[], []]
    for f in frames:
        for q, out, t in zip(queues, outs, (torch.from_numpy(f).to(dev), torch.from_numpy(f))):
            got = q.push(t)
            if got is not None:
                out.append(got)
    for q, out in zip(queues, outs):
        out.extend(q.drain())
        q.close()
    for f, a, b in zip(frames, *outs):
        np.testing.assert_array_equal(a, f)
        np.testing.assert_array_equal(b, f)
    gpu, cpu = queues
    assert (gpu.bytes_transferred, gpu.transfer_misses) == (cpu.bytes_transferred, cpu.transfer_misses)
    assert gpu.transfer_misses >= 2 and gpu.bytes_transferred < gpu.bytes_full


@pytest.mark.cuda
def test_render_batch_on_the_card():
    """render_batch replays step_frame_jit's graph: the wrappers launch their
    kernels only in the warm-up frame and the capture (2), the frames are
    replays, bit-equal to step_frame's; a second batch replays the cached
    graph."""
    dev = _cuda()
    state = _scene(FUSED_SMALL, dev)
    tp.step_frame_jit.cache_clear()
    before = fused.fused_tiles.launches
    final, frames = tp.render_batch(state, FUSED_SMALL, 4)
    assert fused.fused_tiles.launches - before == 2
    assert torch.equal(tp.render_batch(state, FUSED_SMALL, 4)[1], frames)
    assert fused.fused_tiles.launches - before == 2
    s = state
    for i in range(4):
        s, f = tp.step_frame(s, FUSED_SMALL)
        assert torch.equal(frames[i], f), i
    assert torch.equal(final.time, s.time)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["fused", "staged"])
def test_supersample_on_the_card(config):
    """supersample=2 is the box average (sum over 4, rounded half to even)
    of the frame rendered at twice the size, overflow 0."""
    dev = _cuda()
    cfg = dataclasses.replace(FUSED_SMALL, fused=config == "fused")
    state = _scene(cfg, dev)
    got, stats = tp.render_stats(state, dataclasses.replace(cfg, supersample=2))
    hi, _ = tp.render_stats(state, dataclasses.replace(cfg, width=2 * cfg.width, height=2 * cfg.height))
    sums = hi.to(torch.int64).reshape(cfg.height, 2, cfg.width, 2, 3).sum(dim=(1, 3))
    q, r = sums // 4, sums % 4
    want = (q + ((r > 2) | ((r == 2) & (q % 2 == 1))).to(torch.int64)).to(torch.uint8)
    assert torch.equal(got, want)
    assert int(stats["overflow"]) == 0


# ---- step_frame_jit: the frame captured once as a CUDA graph and replayed ----

def _graph_path(name, dev):
    """(cfg, state) of a main path at a small size: the seven of PERF.md
    section 4, supersample=2 on config 1 and the window-gather PCF."""
    if name.startswith("config1"):
        cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=320, height=180,
                                  supersample=2 if name == "config1_ss2" else 1)
        geo = tp.build_scene_geometry([tp.procedural.cube(1.0), tp.procedural.cube(0.7)])
        return cfg, tp.make_scene(geo, cfg, device=dev)
    cfg = {
        "fused_flagship": FUSED_SMALL,
        "staged_flagship": dataclasses.replace(FUSED_SMALL, fused=False),
        "fused_listfed": dataclasses.replace(FUSED_SMALL, inkernel_light_cull=False),
        "config4_fused_split": CONFIG4,
        "config4_fused_unsplit": dataclasses.replace(CONFIG4, deferred_directional=False, inkernel_light_cull=False),
        "config4_staged": dataclasses.replace(CONFIG4, fused=False),
        "config4_window": dataclasses.replace(WINDOW_CONFIG4, shadow_window_gather=True),
    }[name]
    return cfg, _scene(cfg, dev, n_lights=16)


GRAPH_PATHS = ["fused_flagship", "config1", "staged_flagship", "fused_listfed", "config4_fused_split",
               "config4_fused_unsplit", "config4_staged", "config1_ss2", "config4_window"]


def _states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tp.frame._leaves(a), tp.frame._leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graphed_frames_equal_eager(path):
    """8 frames of step_frame_jit bit-equal to 8 of step_frame from the same
    state, the states too, overflow 0 from the graph's count."""
    dev = _cuda()
    cfg, state = _graph_path(path, dev)
    tp.step_frame_jit.cache_clear()
    a = b = state
    for i in range(8):
        a, fa = tp.step_frame(a, cfg)
        b, fb = tp.step_frame_jit(b, cfg)
        assert torch.equal(fa, fb), (path, i)
        assert _states_equal(a, b), (path, i)
    (graph,) = tp.frame._graphs.values()
    assert int(graph.overflow) == 0
    assert float((fb.amax(-1) > 0).double().mean()) > 0.02


@pytest.mark.cuda
def test_graphed_frame_of_any_state():
    """Two scenes of one shape (other lights and materials) and an older
    state, interleaved through one captured graph: each gives step_frame's
    frame and state."""
    dev = _cuda()
    tp.step_frame_jit.cache_clear()
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    scenes = [tp.make_scene(geo, FUSED_SMALL, placement="grid", device=dev,
                            lights=tp.random_point_lights(24, seed=seed, cfg=FUSED_SMALL, radius=3.0, device=dev),
                            materials=tp.Materials.varied(geo.num_meshes, seed=seed, device=dev))
              for seed in (1, 2)]
    older = tp.animate(scenes[0], 0.4, FUSED_SMALL)
    for state in (scenes[0], scenes[1], older, scenes[0], older, scenes[1]):
        a, fa = tp.step_frame(state, FUSED_SMALL)
        b, fb = tp.step_frame_jit(state, FUSED_SMALL)
        assert torch.equal(fa, fb) and _states_equal(a, b)
    assert len(tp.frame._graphs) == 1


@pytest.mark.cuda
def test_graphed_results_are_values():
    """What step_frame_jit returns aliases nothing that a later call writes,
    and the caller's state is never written."""
    dev = _cuda()
    tp.step_frame_jit.cache_clear()
    state = _scene(FUSED_SMALL, dev)
    before = [t.clone() for t in tp.frame._leaves(state)]
    s1, f1 = tp.step_frame_jit(state, FUSED_SMALL)
    kept = (f1.clone(), [t.clone() for t in tp.frame._leaves(s1)])
    s2, f2 = tp.step_frame_jit(s1, FUSED_SMALL)
    tp.step_frame_jit(s2, FUSED_SMALL)
    torch.cuda.synchronize()
    assert not torch.equal(f1, f2)
    assert torch.equal(f1, kept[0]) and all(torch.equal(x, y) for x, y in zip(tp.frame._leaves(s1), kept[1]))
    assert all(torch.equal(x, y) for x, y in zip(tp.frame._leaves(state), before))
    # The leaves the frame passes through come back as the caller's own.
    assert s1.geometry.fv_pos_cols is state.geometry.fv_pos_cols and s1.time is not state.time


@pytest.mark.cuda
def test_host_read_in_the_frame_fails_the_capture(monkeypatch):
    """A host read injected into the captured region raises: no eager
    fallback, nothing cached; the next capture works."""
    dev = _cuda()
    tp.step_frame_jit.cache_clear()
    state = _scene(FUSED_SMALL, dev)
    animate = tp.frame.animate
    monkeypatch.setattr(tp.frame, "animate", lambda s, y, c: (float(s.time), animate(s, y, c))[1])
    with pytest.raises(RuntimeError, match="capturing the frame failed"):
        tp.step_frame_jit(state, FUSED_SMALL)
    assert not tp.frame._graphs
    monkeypatch.setattr(tp.frame, "animate", animate)
    assert torch.equal(tp.step_frame_jit(state, FUSED_SMALL)[1], tp.step_frame(state, FUSED_SMALL)[1])


@pytest.mark.cuda
def test_graph_refuses_and_debug_layer_runs_eager():
    """use_pallas=False (the plain versions' host loops) is refused before
    capture; under debug_layer the frame runs op by op, uncaptured."""
    from d3d12_deferred_renderer_tpu_torch.utils import debug_layer

    dev = _cuda()
    tp.step_frame_jit.cache_clear()
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=128, height=64, use_pallas=False)
    geo = tp.build_scene_geometry([tp.procedural.cube(1.0)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        tp.step_frame_jit(tp.make_scene(geo, cfg, device=dev), cfg)
    state = _scene(FUSED_SMALL, dev)
    with debug_layer():
        _, got = tp.step_frame_jit(state, FUSED_SMALL)
    assert not tp.frame._graphs
    assert torch.equal(got, tp.step_frame(state, FUSED_SMALL)[1])


@pytest.mark.cuda
def test_overflow_warning_under_replay(capsys):
    """The graph computes each frame's overflow count; the host copies it
    out after the replay and prints JAX's message once per offending frame,
    at a later call once that frame has finished (as render does)."""
    dev = _cuda()
    tp.step_frame_jit.cache_clear()
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=1)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device=dev)
    counts, s = [], state
    for _ in range(3):
        s = tp.animate(s, cfg.yaw_per_frame, cfg)
        counts.append(int(tp.render_stats(s, cfg)[1]["overflow"]))
    assert min(counts) > 0
    torch.cuda.synchronize()
    tp.frame._pending_overflow.clear()
    capsys.readouterr()
    for _ in range(3):
        state, _ = tp.step_frame_jit(state, cfg)
        torch.cuda.synchronize()
    want = "".join(tp.frame.OVERFLOW_WARNING.format(n=n) + "\n" for n in counts[:2])
    assert capsys.readouterr().out == want
    assert len(tp.frame._pending_overflow) == 1
