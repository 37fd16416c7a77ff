"""PyTorch port: checkpoints, PNG IO, the OBJ loaders and the debug layer.

* scene_io (the JAX contracts of tests/test_scene_io.py): a checkpoint
  saved mid-orbit resumes bit-exactly; a structure or shape mismatch raises
  ValueError matching "tree structure", a dtype mismatch "dtype mismatch".
  Checkpoints written by the JAX package's save_scene (with the fv_*
  buffers, without them as an older build wrote, and of an instanced
  scene) load into the port equal to convert.arrays_from_state of the JAX
  state.
* PNG: the port's write_png writes JAX's bytes, and each package reads the
  other's files.
* OBJ: the port's native and Python loaders equal to JAX's Python loader
  on the assets and on tests/test_native_loader.py's edge and degenerate
  cases (both raising where JAX raises); load_obj takes the native loader
  by default, and a native parse error propagates.
* validate_scene and debug_layer (tests/test_debug_layer.py,
  tests/test_sampling_debug.py:91-111): a good scene passes, each defect
  gets JAX's message; a NaN light intensity raises FloatingPointError
  inside the scope (staged and fused frames) and renders silently outside;
  the scope restores the previous state on an exception.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.models.obj import load_obj_python as jax_load_obj_python
from d3d12_deferred_renderer_tpu.scene_io import _without_fv
from d3d12_deferred_renderer_tpu.scene_io import save_scene as jax_save_scene
from d3d12_deferred_renderer_tpu.utils import read_png as jax_read_png
from d3d12_deferred_renderer_tpu.utils import write_png as jax_write_png

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.models import native
from d3d12_deferred_renderer_tpu_torch.models.obj import load_obj_python
from d3d12_deferred_renderer_tpu_torch.scene_io import load_scene, save_scene
from d3d12_deferred_renderer_tpu_torch.utils import debug_layer, read_png, validate_scene, write_png
from d3d12_deferred_renderer_tpu_torch.utils.debug import check_finite

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
CFG = tp.RendererConfig(width=96, height=48, use_pallas=False)


def _scene(cfg=CFG, lights=None):
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, cfg, lights=lights, device="cpu")


# ---- scene_io ----

def test_save_load_roundtrip_bitexact(tmp_path):
    state = _scene()
    for _ in range(7):
        state, _ = tp.step_frame(state, CFG)
    p = str(tmp_path / "scene.npz")
    save_scene(p, state)
    restored = load_scene(p, _scene())
    assert float(restored.time) == float(state.time)
    a, b = tp.arrays_from_state(state), tp.arrays_from_state(restored)
    for key in a:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert b[key].dtype == a[key].dtype
    assert torch.equal(tp.step_frame(state, CFG)[1], tp.step_frame(restored, CFG)[1])


def test_load_rejects_mismatched_structure(tmp_path):
    state = _scene()
    p = str(tmp_path / "scene.npz")
    save_scene(p, state)
    other = dataclasses.replace(state, lights=tp.random_point_lights(4, cfg=CFG, device="cpu"))
    with pytest.raises(ValueError, match="tree structure"):
        load_scene(p, other)
    data = dict(np.load(p))
    del data["lights.color"]
    np.savez_compressed(p, **data)
    with pytest.raises(ValueError, match="tree structure"):
        load_scene(p, state)


def test_checkpoint_dtype_mismatch_rejected(tmp_path):
    state = _scene()
    p = str(tmp_path / "x64.npz")
    save_scene(p, state)
    data = dict(np.load(p))
    data["position"] = data["position"].astype(np.float64)
    np.savez_compressed(p, **data)
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_scene(p, state)


def _jax_scenes():
    cfg = dxr.RendererConfig(width=96, height=32, use_pallas=False)
    cube = dxr.procedural.cube(1.0)
    plain = dxr.animate(dxr.make_scene(dxr.build_scene_geometry([cube, dxr.procedural.torus(0.8, 0.3, 6, 8)]), cfg))
    inst = dxr.animate(dxr.make_scene(dxr.build_instanced_geometry([cube], [0, 0, 0]), cfg, placement="grid"))
    return {"fv": plain, "without_fv": _without_fv(plain), "instanced": inst,
            "instanced_without_fv": _without_fv(inst)}


@pytest.mark.parametrize("case", ["fv", "without_fv", "instanced", "instanced_without_fv"])
def test_loads_jax_checkpoints(tmp_path, case):
    jstate = _jax_scenes()[case]
    p = str(tmp_path / f"{case}.npz")
    jax_save_scene(p, jstate)
    reference = _jax_scenes()["instanced" if case.startswith("instanced") else "fv"]
    want = tp.arrays_from_state(reference)
    like = tp.scene_from_arrays(want, device="cpu")
    got = tp.arrays_from_state(load_scene(p, like))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


def test_jax_checkpoint_structure_checked(tmp_path):
    jstate = _jax_scenes()["fv"]
    p = str(tmp_path / "scene.npz")
    jax_save_scene(p, jstate)
    like = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    other = dataclasses.replace(like, lights=tp.random_point_lights(4, cfg=CFG, device="cpu"))
    with pytest.raises(ValueError, match="tree structure"):
        load_scene(p, other)
    data = dict(np.load(p))
    del data["leaf_3"]
    np.savez_compressed(p, **data)
    with pytest.raises(ValueError, match="tree structure"):
        load_scene(p, like)


# ---- PNG ----

@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 4), (3, 9)], ids=["rgb", "rgba", "gray"])
def test_png_bytes_equal_both_ways(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    write_png(ours, img)
    jax_write_png(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(read_png(theirs), img)
    np.testing.assert_array_equal(jax_read_png(ours), img)


def test_read_png_filters():
    """A golden image of the JAX package (written by write_png) reads back
    equal in both packages."""
    path = os.path.join(os.path.dirname(__file__), "golden", "reference_160x90_f10.png")
    np.testing.assert_array_equal(read_png(path), jax_read_png(path))


# ---- OBJ loaders ----

def _assert_mesh_equal(a, b):
    for f in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def _needs_native():
    if not native.ensure_built():
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize("name", ["cube.obj", "pyramid.obj"])
def test_loaders_match_jax_on_assets(name):
    _needs_native()
    path = os.path.join(ASSETS, name)
    ref = jax_load_obj_python(path)
    _assert_mesh_equal(native.load_obj_native(path), ref)
    _assert_mesh_equal(load_obj_python(path), ref)
    _assert_mesh_equal(tp.load_obj(path), ref)  # native by default
    assert native.native_available()


EDGE_CASES = {
    "edge": ("# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0.5 0.25\nvn 0 0 1\nvn 0 1 0\n"
             "f 1/1/1 2/1/1 3/1/1 4/1/1\nf -4//-1 -3//-1 -2//-1\nf 1 2 3\n"),
    "junk_face": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf a b c\n",
    "trailing_slash": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nf 1/ 2/ 3/1\n",
    "oob_forward": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 9 2 3\n",
    "zero_index": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 2 3\n",
    "junk_floats": "v a b c\nf 1 2 3\n",
    "short_vline": "v 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "extra_fields": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\nf 1/1/1/junk 2/1/1 3/1/1\n",
    "empty_middle": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n",
    "huge_index": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 18446744073709551615 2 3\nf -18446744073709551615 2 3\n",
    "vertical_tab_sep": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1\x0b2 3\n",
    "formfeed_lead": "\x0cv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "formfeed_tag": "v\x0c0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "underscore_index": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1_0 2 3\n",
    "hex_float": "v 0x1p3 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "plus_signs": "v +1 +2.5 +3e0\nv 1 0 0\nv 0 1 0\nf +1 2 3\n",
    "inf_nan": "v inf -Infinity nan\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
}


def test_loaders_match_jax_on_edge_cases(tmp_path):
    """Each loader gives JAX's Python loader's mesh, or raises where it
    raises (test_native_loader.py's edge and degenerate cases)."""
    _needs_native()
    for name, text in EDGE_CASES.items():
        p = str(tmp_path / f"{name}.obj")
        with open(p, "w") as f:
            f.write(text)
        results = []
        for fn in (jax_load_obj_python, load_obj_python, native.load_obj_native):
            try:
                results.append(fn(p))
            except (ValueError, IndexError):
                results.append(None)
        ref = results[0]
        for got in results[1:]:
            assert (got is None) == (ref is None), name
            if ref is not None:
                _assert_mesh_equal(got, ref)


def test_native_parse_error_propagates(tmp_path):
    """load_obj falls back to Python only when the library is missing: a
    file the native loader rejects raises through load_obj."""
    _needs_native()
    p = str(tmp_path / "junk.obj")
    with open(p, "w") as f:
        f.write(EDGE_CASES["junk_floats"])
    with pytest.raises(ValueError):
        tp.load_obj(p)
    with pytest.raises(FileNotFoundError):
        tp.load_obj(str(tmp_path / "missing.obj"))


def test_load_obj_python_without_native(monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    path = os.path.join(ASSETS, "cube.obj")
    _assert_mesh_equal(tp.load_obj(path), jax_load_obj_python(path))
    _assert_mesh_equal(tp.load_obj(path, prefer_native=False), jax_load_obj_python(path))


# ---- validate_scene and debug_layer ----

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
