"""PyTorch port: step_frame_jit, the frame as one program, on the CPU.

On a CPU state step_frame_jit runs step_frame (the caller chose the CPU, as
JAX's jitted step runs there too); on the card it replays a CUDA graph,
held bit-equal to step_frame in tests/test_torch_cuda.py and chip_smoke.py.
Here:

* the two goldens that JAX's step_frame_jit is held to
  (tests/test_frame.py:25-44, :128-150), with JAX's tolerances;
* bit-equal to step_frame over 3 frames; render_batch equal to N calls of
  step_frame_jit (N = 0 and 3); App.run goes through it;
* under debug_layer a frame on the card runs op by op; the overflow warning
  is printed once per offending frame; a configuration that cannot be
  captured yet is refused before capture, naming its ROADMAP.md item;
* xmath.perspective_fov_lh, now built on the host once per argument set,
  bit-equal to the device-built matrix it replaces and to JAX's;
* every name of the JAX package's __all__ is in the port's.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch import frame, xmath
from d3d12_deferred_renderer_tpu_torch.runtime import App, app
from d3d12_deferred_renderer_tpu_torch.utils import debug_layer, read_png

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _reference_scene(cfg):
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, cfg, device="cpu")


def _pbr_scene(cfg):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, device="cpu"), placement="grid",
                         materials=tp.Materials.varied(geo.num_meshes, device="cpu"), device="cpu")


GOLDENS = {
    "reference_160x90_f10": (tp.RendererConfig(width=160, height=90, use_pallas=False), _reference_scene, 10),
    "pbr_160x96_f3": (tp.RendererConfig(width=160, height=96, use_pallas=False, shading="pbr"), _pbr_scene, 3),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_step_frame_jit_meets_jax_golden(name):
    """JAX's contract for its step_frame_jit: at most 1 LSB off the golden
    PNG on fewer than 0.1% of the values."""
    cfg, scene, frames = GOLDENS[name]
    state = scene(cfg)
    for _ in range(frames):
        state, out = tp.step_frame_jit(state, cfg)
    diff = np.abs(out.numpy().astype(int) - read_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(int))
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    assert (diff > 0).mean() < 1e-3


def test_step_frame_jit_equals_step_frame():
    cfg = dataclasses.replace(tp.FLAGSHIP_CONFIG, width=128, height=64)
    a = b = _pbr_scene(cfg)
    for _ in range(3):
        a, fa = tp.step_frame(a, cfg)
        b, fb = tp.step_frame_jit(b, cfg)
        assert torch.equal(fa, fb)
        assert torch.equal(a.time, b.time) and torch.equal(a.orientation, b.orientation)


@pytest.mark.parametrize("n", [0, 3])
def test_render_batch_equals_step_frame_jit_calls(n):
    cfg = tp.RendererConfig(width=96, height=48, use_pallas=False)
    state = _reference_scene(cfg)
    end, batch = tp.render_batch(state, cfg, n)
    assert batch.shape == (n, cfg.height, cfg.width, 3) and batch.dtype == torch.uint8
    s = state
    for i in range(n):
        s, f = tp.step_frame_jit(s, cfg)
        assert torch.equal(batch[i], f)
    assert torch.equal(end.time, s.time)


def test_app_runs_through_step_frame_jit(monkeypatch):
    calls = []
    monkeypatch.setattr(app, "step_frame_jit", lambda s, c: (calls.append(c), tp.step_frame_jit(s, c))[1])
    cfg = tp.RendererConfig(width=64, height=32, use_pallas=False)
    with App(_reference_scene(cfg), cfg) as a:
        stats = a.run(4)
    assert stats.frames == 4 and calls == [cfg] * 4


def test_debug_layer_runs_the_frame_op_by_op():
    """A state on the card replays the graph, but not inside debug_layer,
    whose checks read every stage on the host (as jax_debug_nans re-runs a
    jitted function op by op); a CPU state always runs step_frame."""
    on_card = types.SimpleNamespace(time=types.SimpleNamespace(device=torch.device("cuda", 0)))
    cpu = _reference_scene(tp.RendererConfig(width=64, height=32))
    assert not frame._eager(on_card) and frame._eager(cpu)
    with debug_layer():
        assert frame._eager(on_card)
    # The checks run through step_frame_jit: a NaN light raises.
    cfg = tp.RendererConfig(width=64, height=32, use_pallas=False, shading="pbr")
    lights = tp.random_point_lights(4, cfg=cfg, device="cpu")
    state = tp.make_scene(tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, "cube.obj"))]), cfg,
                          lights=dataclasses.replace(lights, point_intensity=lights.point_intensity * float("nan")),
                          device="cpu")
    with debug_layer(), pytest.raises(FloatingPointError, match="NaN"):
        tp.step_frame_jit(state, cfg)


def test_overflow_warning_once_per_offending_frame(capsys):
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=1)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device="cpu")
    counts = []
    capsys.readouterr()
    for _ in range(2):
        counts.append(int(tp.render_stats(tp.animate(state, cfg.yaw_per_frame, cfg), cfg)[1]["overflow"]))
        state, _ = tp.step_frame_jit(state, cfg)
    assert min(counts) > 0
    assert capsys.readouterr().out == "".join(frame.OVERFLOW_WARNING.format(n=n) + "\n" for n in counts)


def test_uncapturable_config_is_refused_before_capture():
    cfg = tp.RendererConfig(width=64, height=32, use_pallas=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        frame._captured(_reference_scene(cfg), cfg)
    assert not frame._graphs


def _device_built_perspective(fov_y, aspect, z_near, z_far, device):
    """The matrix as xmath built it on the device before it moved to the
    host: the same float32 steps on 0-dim tensors of `device`."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    h = 1.0 / torch.tan((f32(fov_y) * 0.5).double()).float()
    w = h / aspect
    zn, zf = f32(z_near), f32(z_far)
    zr = zf / (zf - zn)
    z0, z1 = f32(0.0), f32(1.0)
    return torch.stack([torch.stack([w, z0, z0, z0]), torch.stack([z0, h, z0, z0]),
                        torch.stack([z0, z0, zr, z1]), torch.stack([z0, z0, -zr * zn, z0])])


def test_perspective_is_built_once_and_bit_equal():
    config4 = dict(shadows=True, normal_mapping=True, bloom=True, deferred_directional=True,
                   max_lights_per_tile=128)
    for cfg in (tp.REFERENCE_CONFIG, tp.FLAGSHIP_CONFIG, dataclasses.replace(tp.FLAGSHIP_CONFIG, **config4),
                tp.RendererConfig(width=160, height=96)):
        args = (cfg.fov_y, cfg.aspect, cfg.z_near, cfg.z_far)
        got = xmath.perspective_fov_lh(*args, device=torch.device("cpu"))
        assert xmath.perspective_fov_lh(*args, device=torch.device("cpu")) is got
        bits = got.numpy().view(np.int32)
        np.testing.assert_array_equal(bits, _device_built_perspective(*args, "cpu").numpy().view(np.int32))
        ref = jax.jit(dxr.xmath.perspective_fov_lh, static_argnums=(0, 1, 2, 3))(*args)
        np.testing.assert_array_equal(bits, np.asarray(ref, jnp.float32).view(np.int32))


def test_public_names_cover_jax():
    assert set(dxr.__all__) <= set(tp.__all__), sorted(set(dxr.__all__) - set(tp.__all__))
    assert "step_frame_jit" in tp.__all__ and tp.step_frame_jit is frame.step_frame_jit
