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


# ---- the config-4 kernels: depth-only setup (K4), depth raster (K3), bump
# (K8), directional resolve (K5) and the tile renderer's variants (K2) ----

CONFIG4 = dataclasses.replace(
    tp.FLAGSHIP_CONFIG, width=256, height=64, fused=True, shadows=True, normal_mapping=True,
    bloom=True, deferred_directional=True, inkernel_light_cull=True, max_lights_per_tile=128,
    shadow_vis_downsample=1, shadow_map_size=256,
)


@pytest.mark.cuda
def test_depth_setup_kernel_matches_plain():
    """Light-view records and boxes bit-equal, cull none, fields 12-26 zero."""
    from d3d12_deferred_renderer_tpu_torch import xmath
    from d3d12_deferred_renderer_tpu_torch.ops import shadows
    from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_depth_reference

    dev = _cuda()
    state = _scene(CONFIG4, dev)
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    mvp = xmath.matmul4_fma(model, shadows.light_view_proj(state.lights.direction))
    g = state.geometry
    before = setup_cuda.setup_depth_triangles.launches
    got = setup_cuda.setup_depth_triangles(g.fv_pos_cols, g.tri_mesh_id, mvp, 256, 256)
    ref = setup_depth_reference(g.fv_pos_cols, g.tri_mesh_id, mvp, 256, 256)
    torch.cuda.synchronize()
    assert setup_cuda.setup_depth_triangles.launches == before + 1
    assert torch.equal(got.packed, ref.packed) and torch.equal(got.aabb, ref.aabb)
    assert not got.packed[:, 12:27].any() and int(got.valid.sum()) > 100


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


@pytest.mark.cuda
def test_bump_kernel_matches_plain():
    """Normals within 1e-6 (bit-equal on the card): the kernel and the plain
    version round every operation once, sin and rsqrt in double precision
    alike."""
    from d3d12_deferred_renderer_tpu_torch.ops import bump

    dev = _cuda()
    cfg = dataclasses.replace(CONFIG4, width=200, height=60, fused=False)
    state, frags, view_proj = _fragments(cfg, dev)
    inv_vp = lighting.inverse_view_proj(view_proj)
    planes = bump.bump_planes(frags, 64, 256)
    args = (planes, bump.bump_uniforms(inv_vp, 200, 60))
    kw = dict(nty=8, ntx=2, tile_h=8, tile_w=128, strength=cfg.bump_strength, freq=cfg.bump_frequency)
    before = bump.bump_tiles.launches
    got = bump.bump_tiles(*args, **kw)
    ref = bump.bump_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bump.bump_tiles.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-6
    assert float((got[:, :60, :200] != planes[1:4, :60, :200]).any(0).double().mean()) > 0.2


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
