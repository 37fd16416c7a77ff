"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one.  This file imports no
JAX (the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py makes the same comparisons at the flagship size.
"""
import dataclasses

import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import fused, setup_cuda
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
