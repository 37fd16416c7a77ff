"""PyTorch port: calibrate (autotune, autotune_shadow) against the JAX package.

On tests/test_calibrate.py's small scene (6 meshes, 16 lights, 256x128),
4 yaw steps: the port's calibration, run on the CPU (the reference raster,
the plain light cull, the plain depth-only setup), must derive the same
config and the same integer report as the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.calibrate import autotune as jax_autotune
from d3d12_deferred_renderer_tpu.calibrate import autotune_shadow as jax_autotune_shadow

import d3d12_deferred_renderer_tpu_torch as tp

BASE = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=128, use_pallas=False, fused=False, shadows=True,
)
CASES = {
    "autotune": (jax_autotune, tp.autotune, dict(shadow_map_size=128, shadow_tiles_cap=-1)),
    "autotune_shadow": (jax_autotune_shadow, tp.autotune_shadow, dict(shadow_map_size=256)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_calibration_matches_jax(case):
    jax_fn, port_fn, change = CASES[case]
    jcfg = dataclasses.replace(BASE, **change)
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=6, rings=8, segments=12))
    jstate = dxr.make_scene(geo, jcfg, lights=dxr.random_point_lights(16, cfg=jcfg, radius=1.2),
                            placement="grid", materials=dxr.Materials.varied(geo.num_meshes))
    jcal, jrep = jax_fn(jstate, jcfg, yaw_steps=4, margin=0.3)
    state = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    cal, rep = port_fn(state, tp.RendererConfig(**dataclasses.asdict(jcfg)), yaw_steps=4, margin=0.3)
    assert rep == jrep
    assert dataclasses.asdict(cal) == dataclasses.asdict(jcal)
    assert cal != tp.RendererConfig(**dataclasses.asdict(jcfg))  # the calibration changed something
    if case == "autotune":
        assert rep["measured"]["pairs_max"] > 0 and rep["measured"]["live_lights_max"] > 0
    else:
        assert np.all(np.asarray(rep["tiers"]) > 0)
