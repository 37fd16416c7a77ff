"""PyTorch port: validate_scene and the debug layer.

The JAX contracts of tests/test_debug_layer.py and
tests/test_sampling_debug.py:91-111: a good scene passes, each defect gets
JAX's message; a NaN light intensity raises FloatingPointError inside the
scope (staged and fused frames) and renders silently outside; the scope
restores the previous state on an exception.  (Split from
tests/test_torch_io.py.)
"""
import dataclasses
import os

import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.utils import debug_layer, validate_scene
from d3d12_deferred_renderer_tpu_torch.utils.debug import check_finite

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
CFG = tp.RendererConfig(width=96, height=48, use_pallas=False)


def _scene(cfg=CFG, lights=None):
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, cfg, lights=lights, device="cpu")


def test_validate_scene_accepts_good_state():
    validate_scene(_scene(), CFG)


BAD_STATES = {
    "tri_mesh_id out of range": lambda s: dataclasses.replace(s, geometry=dataclasses.replace(
        s.geometry, tri_mesh_id=s.geometry.tri_mesh_id + 5)),
    "tri_mesh_id length != triangle count": lambda s: dataclasses.replace(s, geometry=dataclasses.replace(
        s.geometry, tri_mesh_id=s.geometry.tri_mesh_id[1:])),
    "fv_uv_cols shape": lambda s: dataclasses.replace(s, geometry=dataclasses.replace(
        s.geometry, fv_uv_cols=s.geometry.fv_uv_cols[:, :1])),
    "materials.albedo shape": lambda s: dataclasses.replace(s, materials=dataclasses.replace(
        s.materials, albedo=s.materials.albedo[:1])),
    "non-finite mesh positions": lambda s: dataclasses.replace(s, position=s.position * float("nan")),
}


@pytest.mark.parametrize("defect", sorted(BAD_STATES))
def test_validate_scene_rejects(defect):
    with pytest.raises(ValueError, match="invalid scene state") as err:
        validate_scene(BAD_STATES[defect](_scene()), CFG)
    assert defect in str(err.value)


def test_validate_scene_rejects_odd_framebuffer():
    with pytest.raises(ValueError, match="odd framebuffer size 95x48"):
        validate_scene(_scene(), dataclasses.replace(CFG, width=95))


def _nan_lights(cfg):
    lights = tp.random_point_lights(8, cfg=cfg, radius=3.0, device="cpu")
    return dataclasses.replace(lights, point_intensity=torch.full((8,), float("nan")))


DEBUG_CASES = {
    "staged": dataclasses.replace(CFG, shading="pbr"),
    "fused": dataclasses.replace(tp.FLAGSHIP_CONFIG, width=128, height=48, fused=True),
}


@pytest.mark.parametrize("case", sorted(DEBUG_CASES))
def test_debug_layer_catches_nan_light(case):
    cfg = DEBUG_CASES[case]
    state = tp.animate(_scene(cfg, lights=_nan_lights(cfg)), 0.3, cfg)
    with debug_layer(nans=True, infs=False):
        with pytest.raises(FloatingPointError, match="NaN"):
            tp.render(state, cfg)
    frame = tp.render(state, cfg)  # no check outside the scope
    assert frame.shape == (48, cfg.width, 3)
    good = tp.animate(_scene(cfg, lights=tp.random_point_lights(8, cfg=cfg, device="cpu")), 0.3, cfg)
    with debug_layer():
        assert torch.equal(tp.render(good, cfg), tp.render(good, cfg))


def test_debug_layer_checks_what_it_is_asked():
    inf = torch.tensor([1.0, float("inf")])
    nan = torch.tensor([float("nan")])
    check_finite("outside", inf, nan)
    with debug_layer(nans=True, infs=False):
        check_finite("x", inf)
        with pytest.raises(FloatingPointError, match="NaN in the x"):
            check_finite("x", nan)
    with debug_layer(nans=False, infs=True):
        check_finite("x", nan, torch.zeros(2, dtype=torch.int32))
        with pytest.raises(FloatingPointError, match="Inf in the y"):
            check_finite("y", inf)


def test_debug_layer_restores_on_exception():
    with pytest.raises(RuntimeError):
        with debug_layer():
            with debug_layer(nans=False, infs=False):
                raise RuntimeError("boom")
    check_finite("after", torch.tensor([float("nan")]))  # off again
