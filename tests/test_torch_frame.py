"""PyTorch port: the whole fused frame against JAX, and the drift guards.

* The slice: the port's step_frame against JAX animate + render_fused
  (interpret=True, as the JAX tests run it on the CPU), each package making
  the scene with its own numpy scene generators: max |du8| <= 1, fewer than
  1% of pixels different, equal overflow.
* Drift guards, kept together: the port carries copies of the JAX package's
  numpy-only modules and configs (that package imports JAX at import), so
  the configs must stay equal field for field, the numpy scene generators
  and build_instanced_geometry must give identical arrays, and the
  port must never import JAX.
* Instancing (the JAX contract of tests/test_instancing.py): the port
  builds the columns of an instanced geometry as JAX does, and renders it
  as the duplicated geometry.
* The overflow warning of render: JAX's message on a frame that overflows
  a capacity cap, none on a frame that does not.
* Every entry point takes the shadow window gather (shadow_window_gather)
  and renders with it the frames it renders without it.
"""
import ast
import dataclasses
import functools
import importlib
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

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


def _one_rank_mesh(*names):
    """A mesh of one rank on every axis: the collectives of a one-rank
    axis return their input, so no process group is needed."""
    from d3d12_deferred_renderer_tpu_torch.parallel.mesh import Mesh

    return Mesh(names, (1,) * len(names), (0,) * len(names), (None,) * len(names), False)


# entry point -> (call(state, cfg) -> uint8 frames, whether it takes the
# sparse PCF path: whole frames do; bands and triangle shards are dense, as
# in the JAX package).
WINDOW_ENTRY_POINTS = {
    "render": (lambda s, c: tp.render(s, c), True),
    "step_frame": (lambda s, c: tp.step_frame(s, c)[1], True),
    "render_batch": (lambda s, c: tp.render_batch(s, c, 1)[1], True),
    "render_sharded": (lambda s, c: tp.parallel.render_sharded(s, c), False),
    "render_tri_sharded": (lambda s, c: tp.parallel.render_tri_sharded(s, c, _one_rank_mesh("tri")), False),
    "render_frames_batch_sharded": (lambda s, c: tp.parallel.render_frames_batch_sharded(
        s, torch.tensor([0.25]), c, _one_rank_mesh("frame", "rows")), False),
    "render_frames_batch_tri_sharded": (lambda s, c: tp.parallel.render_frames_batch_tri_sharded(
        s, torch.tensor([0.25]), c, _one_rank_mesh("frame", "tri")), False),
}


@pytest.mark.parametrize("entry", list(WINDOW_ENTRY_POINTS))
def test_entry_points_take_the_window_gather(entry, monkeypatch):
    """Every entry point renders with shadow_window_gather (the window-gather
    PCF, the last branch the port lacked) the frames it renders without it:
    through the window rows on whole frames, per pixel on bands and
    triangle shards."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows
    from d3d12_deferred_renderer_tpu_torch.parallel import sharded

    call, sparse = WINDOW_ENTRY_POINTS[entry]
    monkeypatch.setattr(sharded.BandGroup, "of", staticmethod(lambda group=None: sharded.BandGroup(None, 0, 1, False)))
    window_calls = []
    window_rows = shadows._pcf_window_rows
    monkeypatch.setattr(shadows, "_pcf_window_rows", lambda *a, **k: (window_calls.append(1), window_rows(*a, **k))[1])
    cfg = dataclasses.replace(TCFG, shadows=True, shadow_map_size=128)
    state = tp.animate(_port_scene(), 0.5, cfg)
    window = call(state, dataclasses.replace(cfg, shadow_window_gather=True))
    assert bool(window_calls) == sparse
    assert torch.equal(window, call(state, cfg))
    assert float((window.amax(-1) > 0).double().mean()) > 0.2


ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
INSTANCE_OF = [[1, 0], [0, 1, 0, 1, 0]]


def _pools():
    """The cube + pyramid pool, loaded by each package's Python OBJ loader."""
    names = ("cube", "pyramid")
    return ([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"), prefer_native=False) for m in names],
            [tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in names])


@pytest.mark.parametrize("instance_of", INSTANCE_OF, ids=["1_0", "0_1_0_1_0"])
def test_instanced_geometry_identical(instance_of):
    """build_instanced_geometry gives JAX's arrays, and from_host the
    columns of JAX's GeometryBuffers.from_host (each logical vertex resolved
    through vertex_source)."""
    jpool, ppool = _pools()
    jg, pg = dxr.build_instanced_geometry(jpool, instance_of), tp.build_instanced_geometry(ppool, instance_of)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(getattr(pg, f.name), getattr(jg, f.name), err_msg=f.name)
    assert pg.num_vertices == jg.num_vertices and pg.num_triangles == jg.num_triangles
    jb, pb = dxr.scene.GeometryBuffers.from_host(jg), tp.GeometryBuffers.from_host(pg, device="cpu")
    for name in ("fv_pos_cols", "fv_nrm_cols", "fv_uv_cols", "tri_mesh_id"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)


def test_instanced_frame_matches_duplicated():
    """Five instances of a two-mesh pool render exactly as five duplicated
    meshes (the port's CPU frame, whole-frame reference raster)."""
    cfg = tp.RendererConfig(width=160, height=90, use_pallas=False)
    _, pool = _pools()
    instance_of = INSTANCE_OF[1]
    states = [tp.make_scene(g, cfg, device="cpu") for g in (
        tp.build_instanced_geometry(pool, instance_of), tp.build_scene_geometry([pool[k] for k in instance_of]))]
    frames = [tp.render(s, cfg) for s in states]
    assert torch.equal(frames[0], frames[1])
    assert (frames[0].amax(-1) > 0).double().mean() > 0.05


def test_overflow_warning_text_is_jax():
    """The port's overflow message is the one the JAX package's
    _warn_overflow prints (its one string literal, the message)."""
    jframe = importlib.import_module("d3d12_deferred_renderer_tpu.frame")
    tree = ast.parse(textwrap.dedent(inspect.getsource(jframe._warn_overflow)))
    texts = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str) and "overflow on {n}" in n.value]
    assert texts == [tp.frame.OVERFLOW_WARNING]


@pytest.mark.parametrize("cap", [1, 256], ids=["tiny_cap", "default_cap"])
def test_render_warns_on_overflow(cap, capsys):
    """With a tile cap of one triangle the frame overflows and render prints
    JAX's message with the count; at the default cap it prints nothing."""
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=cap)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device="cpu")
    overflow = int(tp.render_stats(state, cfg)[1]["overflow"])
    capsys.readouterr()
    tp.render(state, cfg)
    out = capsys.readouterr().out
    if cap == 1:
        assert overflow > 0
        assert out == tp.frame.OVERFLOW_WARNING.format(n=overflow) + "\n"
        assert f"capacity overflow on {overflow} tiles" in out
        tp.render(state, dataclasses.replace(cfg, overflow_warn=False))
        assert capsys.readouterr().out == ""
    else:
        assert overflow == 0 and out == ""
