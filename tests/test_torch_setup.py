"""PyTorch port: triangle setup against the JAX setup.

The port's setup_frame_triangles (on the CPU: the plain version of the setup
kernel) and the JAX package's setup_frame_triangles (the XLA stacked-column
setup) on the same scene state, held to test_setup_pallas's contract:
structural fields exact, float fields bit-equal or within rounding
tolerance.  The port writes its matrix products and sums in a fixed order,
so on these scenes it is in fact bit-equal to the op-by-op JAX setup.  The
instanced_600 case (600 meshes, each triangle's matrices selected by its
mesh id) pins the many-mesh contract.  The winding and cull modes are in
tests/test_torch_winding.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from test_setup_pallas import _assert_setup_close

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import setup_cuda
from d3d12_deferred_renderer_tpu_torch.ops.transform import (
    frame_matrices,
    setup_frame_triangles,
    setup_triangles_reference,
)


def _benchmark(cfg):
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=6, rings=8, segments=12))
    return dxr.make_scene(geo, cfg, lights=dxr.random_point_lights(8, cfg=cfg), placement="grid")


def _near_clip(cfg):
    # Camera inside the scene: triangles straddle the near plane, so both
    # clip slots carry real output.
    geo = dxr.build_scene_geometry(
        [dxr.procedural.cube(1.0), dxr.procedural.torus(0.8, 0.3, 8, 12)]
    )
    return dxr.make_scene(geo, cfg)


def _instanced_600(cfg):
    # 600 instances of one cube: M = 600 meshes, each triangle's matrices
    # selected by its mesh id (the CUDA kernel reads them from global memory).
    geo = dxr.build_instanced_geometry([dxr.procedural.cube(1.0)], [0] * 600)
    return dxr.make_scene(geo, cfg, placement="grid")


CASES = {
    "benchmark": (
        dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=640, height=384), _benchmark, "back", 0.9),
    "near_clip": (
        dxr.RendererConfig(width=256, height=128, eye=(0.0, 0.2, -0.6), at=(0.0, 0.0, 1.0),
                           z_near=0.25),
        _near_clip, "back", 0.7),
    "cull_front": (dxr.RendererConfig(width=128, height=64), _benchmark, "front", 0.9),
    "cull_none": (dxr.RendererConfig(width=128, height=64), _benchmark, "none", 0.9),
    "instanced_600": (dxr.RendererConfig(width=128, height=64), _instanced_600, "back", 0.9),
}
# Cases whose JAX setup runs under jax.jit: op by op, every eager op would
# compile anew for the 600-mesh shapes (~7 s).  Jitted XLA contracts some
# products into FMAs, which _assert_setup_close's tolerance covers.
JIT_CASES = {"instanced_600"}


@pytest.fixture(scope="module")
def pairs():
    """case -> (JAX TriSetup, port TriSetup), each computed once."""
    out = {}
    for name, (cfg, build, cull, _) in CASES.items():
        state = dxr.animate(build(cfg))
        if name in JIT_CASES:
            ref = jax.jit(lambda s, cfg=cfg, cull=cull: jax_setup(s, cfg, cull=cull)[0])(state)
        else:
            ref, _ = jax_setup(state, cfg, cull=cull)
        port_state = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
        got, _ = setup_frame_triangles(port_state, tp.RendererConfig(**dataclasses.asdict(cfg)), cull=cull)
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_matches_jax(pairs, case):
    ref, got = pairs[case]
    assert np.asarray(ref.valid).sum() > 0  # the scene exercises real work
    _assert_setup_close(got, ref, min_exact=CASES[case][3])


def test_near_clip_case_clips(pairs):
    ref, got = pairs["near_clip"]
    assert np.asarray(ref.valid)[1::2].sum() > 0, "test scene never clips — weak test"
    np.testing.assert_array_equal(got.valid.numpy()[1::2], np.asarray(ref.valid)[1::2])


def test_unclipped_setup_matches_jax_on_the_cpu():
    """near_clip=False: T unclipped records (the JAX package's XLA setup
    only), bit-equal to JAX's on the near-clip scene, through the plain
    version; the kernel has no such mode, so CUDA tensors are refused."""
    cfg, build, _, _ = CASES["near_clip"]
    state = dxr.animate(build(cfg))
    ref, _ = jax_setup(state, cfg, near_clip=False)
    pstate = tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")
    got, _ = setup_frame_triangles(pstate, tp.RendererConfig(**dataclasses.asdict(cfg)), near_clip=False)
    assert got.packed.shape[0] == pstate.geometry.tri_mesh_id.shape[0]
    np.testing.assert_array_equal(got.packed.numpy().view(np.int32), np.asarray(ref.packed).view(np.int32))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.valid.sum()) > 0


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper returns the plain version's records
    and launches nothing."""
    cfg = tp.RendererConfig(width=128, height=64)
    geo = tp.build_scene_geometry([tp.procedural.cube(1.0)])
    state = tp.animate(tp.make_scene(geo, cfg, device="cpu"))
    model, _, mvp = frame_matrices(state, cfg)
    g = state.geometry
    args = (g.fv_pos_cols, g.fv_nrm_cols, g.fv_uv_cols, g.tri_mesh_id, mvp, model, 128, 64)
    before = setup_cuda.setup_triangles.launches
    got = setup_cuda.setup_triangles(*args)
    ref = setup_triangles_reference(*args)
    assert setup_cuda.setup_triangles.launches == before
    assert torch.equal(got.packed, ref.packed) and torch.equal(got.aabb, ref.aabb)
    assert int(got.valid.sum()) > 0
