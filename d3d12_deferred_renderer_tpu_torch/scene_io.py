"""Scene-state checkpoint and resume.

The counterpart of d3d12_deferred_renderer_tpu/scene_io.py.  Absent from the
reference (no state is ever saved; SURVEY.md section 5).  ``save_scene``
writes an .npz keyed by the dotted field paths of ``convert.FIELDS`` plus a
format marker; ``load_scene`` reads it back onto the device of a `like`
state, bit for bit, so a run resumes exactly.

``load_scene`` also reads a checkpoint written by the JAX package's
``save_scene``: its leaves (``leaf_<i>``) in the flatten order of JAX's
dataclass fields, with the ``None`` leaves marked in the stored treedef
text (``vertex_source`` when the scene is not instanced; the ``fv_*``
buffers in a checkpoint of an older build, whose face-vertex columns are
then rebuilt here exactly as ``GeometryBuffers.from_host`` builds them).
The JAX package cannot read this package's files.

Both formats keep JAX's errors: ``ValueError`` matching "tree structure"
for a structure or shape mismatch, "dtype mismatch" for a dtype mismatch.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .convert import FIELDS, arrays_from_state, field, scene_from_arrays
from .scene import SceneState

FORMAT = "d3d12_deferred_renderer_tpu_torch.scene_io/1"
_FORMAT_KEY = "__format__"

# JAX's GeometryBuffers fields, in its dataclass (flatten) order, and the
# rest of JAX's SceneState leaves after the geometry: FIELDS' order.
_JAX_GEOMETRY = (
    "positions", "normals", "uvs", "indices", "tri_mesh_id", "vertex_mesh_id", "vertex_source",
    "fv_positions", "fv_normals", "fv_uvs", "fv_mesh_id", "fv_pos_cols", "fv_nrm_cols", "fv_uv_cols",
)
_JAX_REST = tuple(f for f in FIELDS if not f.startswith("geometry."))
_JAX_GEOMETRY_NODE = re.compile(r"CustomNode\(GeometryBuffers\[None\], \[([^\]]*)\]\)")


def save_scene(path: str, state: SceneState) -> None:
    arrays = arrays_from_state(state)
    arrays[_FORMAT_KEY] = np.frombuffer(FORMAT.encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _face_vertex_cols(geo: dict) -> dict:
    """The port's geometry fields from JAX's GeometryBuffers leaves:
    the stored columns, or where an older checkpoint has none, columns
    rebuilt from positions/normals/uvs/indices/vertex_source as
    GeometryBuffers.from_host builds them."""
    out = {"geometry.tri_mesh_id": geo["tri_mesh_id"]}
    if geo.get("fv_pos_cols") is not None:
        for name in ("fv_pos_cols", "fv_nrm_cols", "fv_uv_cols"):
            out[f"geometry.{name}"] = geo[name]
        return out
    idx = geo["indices"]
    if geo.get("vertex_source") is not None:
        idx = geo["vertex_source"][idx]
    T = idx.shape[0] // 3
    for name, src, c in (("fv_pos_cols", "positions", 3), ("fv_nrm_cols", "normals", 3),
                         ("fv_uv_cols", "uvs", 2)):
        out[f"geometry.{name}"] = np.ascontiguousarray(geo[src][idx].reshape(T, 3, c).transpose(1, 2, 0))
    return out


def _from_jax_checkpoint(data) -> dict:
    """{FIELDS path: array} from a checkpoint of the JAX package's save_scene."""
    stored = bytes(data["__treedef__"]).decode()
    node = _JAX_GEOMETRY_NODE.search(stored)
    marks = node.group(1).split(", ") if node else []
    if (not stored.startswith("PyTreeDef(CustomNode(SceneState") or len(marks) != len(_JAX_GEOMETRY)
            or any(m not in ("*", "None") for m in marks)):
        raise ValueError(f"checkpoint tree structure is not a SceneState's:\n  stored: {stored[:200]}")
    present = [name for name, m in zip(_JAX_GEOMETRY, marks) if m == "*"]
    names = [f"geometry.{n}" for n in present] + list(_JAX_REST)
    n = len([k for k in data.files if k.startswith("leaf_")])
    if n != len(names) or stored.count("*") != n:
        raise ValueError(f"checkpoint tree structure mismatch: {n} leaves stored, {len(names)} expected")
    leaves = {name: data[f"leaf_{i}"] for i, name in enumerate(names)}
    geo = {name.split(".", 1)[1]: a for name, a in leaves.items() if name.startswith("geometry.")}
    return {**_face_vertex_cols(geo), **{k: leaves[k] for k in _JAX_REST}}


def load_scene(path: str, like: SceneState) -> SceneState:
    """Load a checkpoint written by save_scene (this package's or the JAX
    package's) onto the device of `like`, which gives the expected field
    shapes and dtypes."""
    with np.load(path) as data:
        if "__treedef__" in data.files:
            arrays = _from_jax_checkpoint(data)
        elif _FORMAT_KEY in data.files:
            stored = bytes(data[_FORMAT_KEY]).decode()
            if stored != FORMAT:
                raise ValueError(f"checkpoint format {stored!r}, expected {FORMAT!r}")
            missing = [k for k in FIELDS if k not in data.files]
            if missing:
                raise ValueError(f"checkpoint tree structure mismatch: no {missing}")
            arrays = {k: data[k] for k in FIELDS}
        else:
            raise ValueError("checkpoint tree structure unknown: neither format's marker is stored")
    for key in FIELDS:
        arr, ref = arrays[key], field(like, key)
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint tree structure/shape mismatch at {key}: stored {arr.shape}, "
                f"expected {tuple(ref.shape)}"
            )
        ref_dtype = torch.empty((), dtype=ref.dtype).numpy().dtype
        if arr.dtype != ref_dtype:
            raise ValueError(f"checkpoint dtype mismatch at {key}: stored {arr.dtype}, expected {ref_dtype}")
    return scene_from_arrays(arrays, device=like.time.device)
