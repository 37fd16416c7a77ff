"""PyTorch port: triangle setup's winding and cull modes against the JAX setup.

setup_frame_triangles(front_ccw=False) maps to the kernel's fixed
counter-clockwise winding by swapping cull "back" and "front" ("none"
unchanged): records, boxes and valid flags bit-equal (int32 views) to JAX's
setup run op by op, for every cull mode and both windings, through the
setup kernel's plain version on the CPU.  (Split from
tests/test_torch_setup.py.)
"""
import dataclasses

import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles


def _benchmark(cfg):
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=6, rings=8, segments=12))
    return dxr.make_scene(geo, cfg, lights=dxr.random_point_lights(8, cfg=cfg), placement="grid")


@pytest.mark.parametrize("front_ccw", [True, False], ids=["ccw", "cw"])
@pytest.mark.parametrize("cull", ["back", "front", "none"])
def test_winding_matches_jax_bit_for_bit(cull, front_ccw):
    """setup_frame_triangles(front_ccw=False) maps to the kernel's fixed
    counter-clockwise winding by swapping cull "back" and "front" ("none"
    unchanged): records, boxes and valid flags bit-equal (int32 views) to
    JAX's setup run op by op, for every cull mode and both windings."""
    cfg = dxr.RendererConfig(width=128, height=64)
    state = dxr.animate(_benchmark(cfg))
    ref, _ = jax_setup(state, cfg, cull=cull, front_ccw=front_ccw)
    got, _ = setup_frame_triangles(tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu"),
                                   tp.RendererConfig(**dataclasses.asdict(cfg)), cull=cull, front_ccw=front_ccw)
    np.testing.assert_array_equal(got.packed.numpy().view(np.int32), np.asarray(ref.packed).view(np.int32))
    np.testing.assert_array_equal(got.aabb.numpy().view(np.int32), np.asarray(ref.aabb).view(np.int32))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(got.valid.sum()) < got.valid.numel()
