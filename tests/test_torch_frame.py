"""PyTorch port: the whole fused frame against JAX, and the drift guards.

* The slice: the port's step_frame against JAX animate + render_fused
  (interpret=True, as the JAX tests run it on the CPU), each package making
  the scene with its own numpy scene generators: max |du8| <= 1, fewer than
  1% of pixels different, equal overflow.
* Drift guards, kept together: the port carries copies of the JAX package's
  numpy-only modules and configs (that package imports JAX at import), so
  the configs must stay equal field for field, the numpy scene generators
  must give identical arrays, the overflow message must be JAX's, and the
  port must never import JAX.

The entry points' window-gather flag, instancing and the overflow warning
are in tests/test_torch_entry.py.
"""
import ast
import dataclasses
import functools
import importlib
import inspect
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.fused import render_fused as jax_render_fused

import d3d12_deferred_renderer_tpu_torch as tp

JCFG = dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=True)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def _jax_scene():
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return dxr.make_scene(
        geo, JCFG, lights=dxr.random_point_lights(24, cfg=JCFG, radius=1.2),
        placement="grid", materials=dxr.Materials.varied(geo.num_meshes),
    )


def _port_scene():
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, TCFG, lights=tp.random_point_lights(24, cfg=TCFG, radius=1.2, device="cpu"),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"),
        device="cpu",
    )


@pytest.fixture(scope="module")
def frames():
    jstate = dxr.animate(_jax_scene(), JCFG.yaw_per_frame, JCFG)
    render = jax.jit(
        functools.partial(jax_render_fused, interpret=True, return_overflow=True),
        static_argnums=(1,),
    )
    jf, jov = render(jstate, JCFG)
    pstate, pf = tp.step_frame(_port_scene(), TCFG)
    _, stats = tp.render_stats(pstate, TCFG)
    return np.asarray(jf), int(jov), pf.numpy(), int(stats["overflow"]), jstate, pstate


def test_step_frame_matches_jax(frames):
    jf, jov, pf, pov, _, _ = frames
    assert pf.shape == jf.shape == (64, 256, 3)
    diff = np.abs(jf.astype(int) - pf.astype(int))
    assert diff.max() <= 1, f"max u8 diff {diff.max()}"
    assert (diff > 0).mean() < 0.01
    assert pov == jov == 0
    assert (pf.max(-1) > 0).mean() > 0.2  # not blank


def test_animated_state_matches_jax(frames):
    *_, jstate, pstate = frames
    ja, pa = tp.arrays_from_state(jstate), tp.arrays_from_state(pstate)
    for key in ja:
        np.testing.assert_array_equal(pa[key], ja[key], err_msg=key)


@pytest.mark.parametrize("name", ["RendererConfig()", "REFERENCE_CONFIG", "FLAGSHIP_CONFIG"])
def test_configs_equal(name):
    if name == "RendererConfig()":
        jc, pc = dxr.RendererConfig(), tp.RendererConfig()
    else:
        jc, pc = getattr(dxr, name), getattr(tp, name)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.aspect == jc.aspect and pc.resolution == jc.resolution


@pytest.mark.parametrize("kw", [{}, dict(n=4, rings=8, segments=16)], ids=["flagship", "small"])
def test_numpy_scene_generators_identical(kw):
    jm, pm = dxr.procedural.benchmark_meshes(**kw), tp.procedural.benchmark_meshes(**kw)
    assert [m.name for m in pm] == [m.name for m in jm]
    for a, b in zip(jm, pm):
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype
    jg, pg = dxr.build_scene_geometry(jm), tp.build_scene_geometry(pm)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(getattr(pg, f.name), getattr(jg, f.name), err_msg=f.name)
    if not kw:
        assert pg.num_triangles == 23_906


@pytest.mark.parametrize("kw", [{}, dict(n_columns=6, n_orbs=4, rings=8, segments=12)], ids=["bench", "small"])
def test_colonnade_generator_identical(kw):
    """colonnade_meshes (calibrate's second scene) and its origin placement."""
    jm, pm = dxr.procedural.colonnade_meshes(**kw), tp.procedural.colonnade_meshes(**kw)
    assert [m.name for m in pm] == [m.name for m in jm]
    for a, b in zip(jm, pm):
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype
    jg, pg = dxr.build_scene_geometry(jm), tp.build_scene_geometry(pm)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(getattr(pg, f.name), getattr(jg, f.name), err_msg=f.name)
    ja = tp.arrays_from_state(dxr.make_scene(jg, JCFG, placement="origin"))
    pa = tp.arrays_from_state(tp.make_scene(pg, TCFG, placement="origin", device="cpu"))
    for key in ja:
        np.testing.assert_array_equal(pa[key], ja[key], err_msg=key)


def test_scene_state_identical():
    """make_scene, random_point_lights, Materials.varied and the face-vertex
    columns: the two packages' scenes hold identical arrays."""
    ja, pa = tp.arrays_from_state(_jax_scene()), tp.arrays_from_state(_port_scene())
    assert sorted(ja) == sorted(pa)
    for key in ja:
        np.testing.assert_array_equal(pa[key], ja[key], err_msg=key)
        assert pa[key].dtype == ja[key].dtype, key


def test_port_imports_no_jax():
    code = (
        "import sys, d3d12_deferred_renderer_tpu_torch as p, "
        "d3d12_deferred_renderer_tpu_torch.ops.setup_cuda, "
        "d3d12_deferred_renderer_tpu_torch.ops.fused, "
        "d3d12_deferred_renderer_tpu_torch.ops.raster_tiles, "
        "d3d12_deferred_renderer_tpu_torch.ops.lighting_cuda, "
        "d3d12_deferred_renderer_tpu_torch.ops.lighting, "
        "d3d12_deferred_renderer_tpu_torch.ops.post, "
        "d3d12_deferred_renderer_tpu_torch.ops.shadows, "
        "d3d12_deferred_renderer_tpu_torch.ops.sampling, "
        "d3d12_deferred_renderer_tpu_torch.ops.bump, "
        "d3d12_deferred_renderer_tpu_torch.ops.scatter, "
        "d3d12_deferred_renderer_tpu_torch.calibrate, "
        "d3d12_deferred_renderer_tpu_torch.models.obj, "
        "d3d12_deferred_renderer_tpu_torch.parallel, "
        "d3d12_deferred_renderer_tpu_torch.parallel.launch, "
        "d3d12_deferred_renderer_tpu_torch.parallel.dryrun, "
        "d3d12_deferred_renderer_tpu_torch.runtime, "
        "d3d12_deferred_renderer_tpu_torch.scene_io, "
        "d3d12_deferred_renderer_tpu_torch.utils.debug, "
        "d3d12_deferred_renderer_tpu_torch.utils.image, "
        "d3d12_deferred_renderer_tpu_torch.utils.native_build, "
        "d3d12_deferred_renderer_tpu_torch.models.native; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'d3d12_deferred_renderer_tpu.'))]; "
        "assert not bad and 'd3d12_deferred_renderer_tpu' not in sys.modules, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_overflow_warning_text_is_jax():
    """The port's overflow message is the one the JAX package's
    _warn_overflow prints (its one string literal, the message)."""
    jframe = importlib.import_module("d3d12_deferred_renderer_tpu.frame")
    tree = ast.parse(textwrap.dedent(inspect.getsource(jframe._warn_overflow)))
    texts = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str) and "overflow on {n}" in n.value]
    assert texts == [tp.frame.OVERFLOW_WARNING]
