"""Wavefront OBJ loader with per-face-vertex deduplication (numpy only).

A copy of the pure-Python loader of d3d12_deferred_renderer_tpu/models/obj.py
(``load_obj_python``): that package imports JAX at package import, so the port
carries its own, and tests/test_torch_staged.py pins the two equal on the
reference's assets.  It replicates LoadObjFile (source/main.cpp:916-1045):
dedup keyed on the (vertex, normal, uv) index triple, fan triangulation,
zeros for missing normal/uv indices.  ``load_obj`` takes the native C++
loader (models/native.py) first and this one only where the library cannot
be built, as the JAX package does.
"""
from __future__ import annotations

import os
import re

import numpy as np

from .meshlib import MeshData

# Strict ASCII numeric grammars shared with the native loader (parity
# contract): bare int()/float() additionally accept underscores ('1_0') and
# Unicode digits, which the C++ parser rightly rejects — both loaders must
# raise on the same tokens.  The float grammar is from_chars/strtof's decimal
# form (optional sign, digits with optional fraction or leading-dot fraction,
# optional exponent, or inf/infinity/nan, case-insensitive).
_INT_RE = re.compile(r"[+-]?[0-9]+")
_FLOAT_RE = re.compile(
    r"[+-]?(?:(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])"
)


def _parse_index(tok: str) -> int:
    if not _INT_RE.fullmatch(tok):
        raise ValueError(f"malformed face index: {tok!r}")
    return int(tok)


def _parse_float(tok: str) -> float:
    if not _FLOAT_RE.fullmatch(tok):
        raise ValueError(f"malformed number: {tok!r}")
    return float(tok)


def _resolve_index(raw: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices are relative to the current end."""
    if raw > 0:
        return raw - 1
    if raw < 0:
        return count + raw
    return -1


def load_obj_python(path: str) -> MeshData:
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []

    out_pos: list[tuple] = []
    out_nrm: list[tuple] = []
    out_uv: list[tuple] = []
    indices: list[int] = []
    dedup: dict[tuple, int] = {}

    def emit(token: str) -> int:
        parts = token.split("/")
        vi = _resolve_index(_parse_index(parts[0]), len(positions))
        ti = -1
        ni = -1
        if len(parts) > 1 and parts[1]:
            ti = _resolve_index(_parse_index(parts[1]), len(uvs))
        if len(parts) > 2 and parts[2]:
            ni = _resolve_index(_parse_index(parts[2]), len(normals))
        key = (vi, ni, ti)
        found = dedup.get(key)
        if found is not None:
            return found
        idx = len(out_pos)
        dedup[key] = idx
        # Invalid indices (`f 0/...`, or out-of-range forward references) emit
        # zeros, matching the native C++ loader's bounds checks — never Python
        # negative indexing or IndexError, so both loaders agree bit-for-bit
        # on degenerate input too.
        out_pos.append(positions[vi] if 0 <= vi < len(positions) else (0.0, 0.0, 0.0))
        out_nrm.append(normals[ni] if 0 <= ni < len(normals) else (0.0, 0.0, 0.0))
        out_uv.append(uvs[ti] if 0 <= ti < len(uvs) else (0.0, 0.0))
        return idx

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append(
                    (_parse_float(parts[1]), _parse_float(parts[2]),
                     _parse_float(parts[3]))
                )
            elif tag == "vn":
                normals.append(
                    (_parse_float(parts[1]), _parse_float(parts[2]),
                     _parse_float(parts[3]))
                )
            elif tag == "vt":
                uvs.append((_parse_float(parts[1]), _parse_float(parts[2])))
            elif tag == "f":
                face = [emit(tok) for tok in parts[1:]]
                # Fan triangulation, matching tinyobjloader's default.
                for k in range(1, len(face) - 1):
                    indices.extend((face[0], face[k], face[k + 1]))

    if not out_pos:
        raise ValueError(f"failed to read obj file: {path}")

    return MeshData(
        positions=np.asarray(out_pos, np.float32),
        normals=np.asarray(out_nrm, np.float32),
        uvs=np.asarray(out_uv, np.float32),
        indices=np.asarray(indices, np.uint32),
        name=os.path.splitext(os.path.basename(path))[0],
    )


def load_obj(path: str, prefer_native: bool = True, generate_normals: bool = True) -> MeshData:
    """Load an OBJ file with the native C++ loader when it can be built,
    else (or with prefer_native=False) the Python loader.  Only the
    library's absence falls back: a native parse error propagates.  With
    generate_normals (default), meshes without `vn` data get faceted
    geometric normals instead of the zeros the reference would shade black."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"failed to read obj file: {path}")
    mesh = None
    if prefer_native:
        from .native import load_obj_native, native_available

        try:
            native_ok = native_available()
        except OSError:  # a library that exists but cannot be loaded
            native_ok = False
        if native_ok:
            mesh = load_obj_native(path)
    if mesh is None:
        mesh = load_obj_python(path)
    if generate_normals and not mesh.has_normals:
        mesh = mesh.with_flat_normals()
    return mesh
