"""PyTorch port: checkpoints and PNG IO.

* scene_io (the JAX contracts of tests/test_scene_io.py): a checkpoint
  saved mid-orbit resumes bit-exactly; a structure or shape mismatch raises
  ValueError matching "tree structure", a dtype mismatch "dtype mismatch".
  Checkpoints written by the JAX package's save_scene (with the fv_*
  buffers, without them as an older build wrote, and of an instanced
  scene) load into the port equal to convert.arrays_from_state of the JAX
  state.
* PNG: the port's write_png writes JAX's bytes, and each package reads the
  other's files.

The OBJ loaders are in tests/test_torch_obj.py, validate_scene and the
debug layer in tests/test_torch_debug.py.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.scene_io import _without_fv
from d3d12_deferred_renderer_tpu.scene_io import save_scene as jax_save_scene
from d3d12_deferred_renderer_tpu.utils import read_png as jax_read_png
from d3d12_deferred_renderer_tpu.utils import write_png as jax_write_png

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.scene_io import load_scene, save_scene
from d3d12_deferred_renderer_tpu_torch.utils import read_png, write_png

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
