"""ctypes bindings for the native C++ OBJ loader (native/objloader.cpp).

The counterpart of d3d12_deferred_renderer_tpu/models/native.py, bound to the
port's own build (utils/native_build.py: build/native/libobjloader.so, made
from native/objloader.cpp by native/Makefile's rule).  The reference's asset
layer is C++ (tinyobjloader + a dedup hash map, source/main.cpp:916-1045);
this is a small C++ shared library with a C ABI, bound via ctypes.  Its
semantics are those of models/obj.py:load_obj_python: tests/test_torch_io.py
holds both, and JAX's loaders, bit-equal.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_build import ensure_built as _ensure_built_shared
from .meshlib import MeshData

_lib = None


def ensure_built() -> bool:
    """Build the shared library if missing or older than its source."""
    return _ensure_built_shared("libobjloader.so", "objloader.cpp") is not None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib_path = _ensure_built_shared("libobjloader.so", "objloader.cpp")
    if lib_path is None:
        return None
    lib = ctypes.CDLL(lib_path)
    lib.objloader_load.restype = ctypes.c_void_p
    lib.objloader_load.argtypes = [ctypes.c_char_p]
    lib.objloader_num_vertices.restype = ctypes.c_int64
    lib.objloader_num_vertices.argtypes = [ctypes.c_void_p]
    lib.objloader_num_indices.restype = ctypes.c_int64
    lib.objloader_num_indices.argtypes = [ctypes.c_void_p]
    lib.objloader_copy_out.restype = None
    lib.objloader_copy_out.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.objloader_free.restype = None
    lib.objloader_free.argtypes = [ctypes.c_void_p]
    lib.objloader_error.restype = ctypes.c_char_p
    lib.objloader_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def load_obj_native(path: str) -> MeshData:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native objloader not available")
    handle = lib.objloader_load(path.encode())
    if not handle:
        raise ValueError(f"failed to read obj file: {path}")
    try:
        err = lib.objloader_error(handle)
        if err:
            raise ValueError(err.decode())
        nv = lib.objloader_num_vertices(handle)
        ni = lib.objloader_num_indices(handle)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        idx = np.empty((ni,), np.uint32)
        lib.objloader_copy_out(
            handle,
            pos.ctypes.data_as(ctypes.c_void_p),
            nrm.ctypes.data_as(ctypes.c_void_p),
            uv.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p),
        )
    finally:
        lib.objloader_free(handle)
    name = os.path.splitext(os.path.basename(path))[0]
    return MeshData(positions=pos, normals=nrm, uvs=uv, indices=idx, name=name)
