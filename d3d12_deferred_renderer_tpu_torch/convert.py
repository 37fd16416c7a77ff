"""Carry a scene state across packages as plain numpy arrays.

``arrays_from_state`` flattens any object with SceneState's field names (the
JAX package's, or this one's) into a dict of numpy arrays keyed by dotted
field path; it touches no framework type, only attribute access and
``np.asarray``.  ``scene_from_arrays`` builds this package's SceneState from
such a dict on a given device (through ``state_from_fields``, which
frame.step_frame_jit also uses to rebuild a state from its tensors).  Together they feed both packages the same
state, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene import Camera, GeometryBuffers, Lights, Materials, SceneState, _dev

FIELDS = (
    "geometry.fv_pos_cols",
    "geometry.fv_nrm_cols",
    "geometry.fv_uv_cols",
    "geometry.tri_mesh_id",
    "position",
    "orientation",
    "scale",
    "materials.albedo",
    "materials.metalness",
    "materials.roughness",
    "camera.eye",
    "camera.at",
    "camera.up",
    "lights.direction",
    "lights.color",
    "lights.point_position",
    "lights.point_color",
    "lights.point_radius",
    "lights.point_intensity",
    "time",
)


def field(state, path: str):
    """The field of `state` at a dotted path of FIELDS."""
    obj = state
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def arrays_from_state(state) -> dict:
    """{dotted field path: numpy array} for every entry of FIELDS."""
    out = {}
    for path in FIELDS:
        obj = field(state, path)
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu()
        out[path] = np.asarray(obj)
    return out


def scene_from_arrays(arrays: dict, device=None) -> SceneState:
    """This package's SceneState from a dict made by arrays_from_state, on
    `device` (the CUDA device when None)."""
    device = _dev(device)
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"scene arrays lack {missing}")

    def t(key):
        a = np.asarray(arrays[key])
        dtype = torch.int32 if key == "geometry.tri_mesh_id" else torch.float32
        return torch.tensor(a, dtype=dtype, device=device)

    return state_from_fields(t)


def state_from_fields(get) -> SceneState:
    """This package's SceneState holding get(path) at each dotted path of
    FIELDS."""
    def group(cls, prefix):
        names = [k.split(".", 1)[1] for k in FIELDS if k.startswith(prefix + ".")]
        return cls(**{n: get(f"{prefix}.{n}") for n in names})

    return SceneState(
        geometry=group(GeometryBuffers, "geometry"),
        position=get("position"),
        orientation=get("orientation"),
        scale=get("scale"),
        materials=group(Materials, "materials"),
        camera=group(Camera, "camera"),
        lights=group(Lights, "lights"),
        time=get("time"),
    )
