"""PyTorch port: the OBJ loaders.

The port's native and Python loaders equal to JAX's Python loader on the
assets and on tests/test_native_loader.py's edge and degenerate cases (both
raising where JAX raises); load_obj takes the native loader by default, and
a native parse error propagates.  (Split from tests/test_torch_io.py.)
"""
import os

import numpy as np
import pytest

from d3d12_deferred_renderer_tpu.models.obj import load_obj_python as jax_load_obj_python

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.models import native
from d3d12_deferred_renderer_tpu_torch.models.obj import load_obj_python

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")


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
