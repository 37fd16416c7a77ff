"""Scene state on torch tensors: geometry, transforms, camera, lights, materials.

The counterpart of d3d12_deferred_renderer_tpu/scene.py.  Every tensor of a
SceneState lies on one device, chosen when the scene is made; the frame reads
that device from the tensors.  Every constructor below takes ``device=``;
without it the tensors go to the CUDA device (``default_device``), and a
caller who wants the CPU asks for it with ``device="cpu"``.  The state is immutable: ``animate`` returns a
new SceneState that shares the unchanged tensors.

The animation rule matches main.cpp:200-207: the clock advances 0.01 rad per
frame, wraps at 2*pi and drives the yaw of every mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import RendererConfig
from .models.meshlib import SceneGeometry
from .xmath import XM_2PI

F32 = torch.float32


def default_device() -> torch.device:
    """The device a scene lives on when the caller names none: the CUDA
    device.  Raises where there is none; it never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the renderer runs on the GPU by default; "
            "pass device=\"cpu\" to build the scene on the CPU"
        )
    return torch.device("cuda")


def _dev(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _t(a, device, dtype=F32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: torch.Tensor  # [3]
    at: torch.Tensor   # [3]
    up: torch.Tensor   # [3]

    @staticmethod
    def from_config(cfg: RendererConfig, device=None) -> "Camera":
        device = _dev(device)
        return Camera(
            eye=_t(cfg.eye, device), at=_t(cfg.at, device), up=_t(cfg.up, device)
        )


@dataclasses.dataclass(frozen=True)
class Lights:
    """One directional light (main.cpp:245-247) plus L point lights."""

    direction: torch.Tensor        # [3]
    color: torch.Tensor            # [3]
    point_position: torch.Tensor   # [L, 3]
    point_color: torch.Tensor      # [L, 3]
    point_radius: torch.Tensor     # [L]
    point_intensity: torch.Tensor  # [L]

    @staticmethod
    def directional_only(cfg: RendererConfig, device=None) -> "Lights":
        device = _dev(device)
        return Lights(
            direction=_t(cfg.light_direction, device),
            color=_t(cfg.light_color, device),
            point_position=torch.zeros((0, 3), dtype=F32, device=device),
            point_color=torch.zeros((0, 3), dtype=F32, device=device),
            point_radius=torch.zeros((0,), dtype=F32, device=device),
            point_intensity=torch.zeros((0,), dtype=F32, device=device),
        )

    @property
    def num_point(self) -> int:
        return int(self.point_position.shape[0])


@dataclasses.dataclass(frozen=True)
class Materials:
    albedo: torch.Tensor     # [M, 3]
    metalness: torch.Tensor  # [M]
    roughness: torch.Tensor  # [M]

    @staticmethod
    def from_config(cfg: RendererConfig, num_meshes: int, device=None) -> "Materials":
        device = _dev(device)
        return Materials(
            albedo=_t(np.tile(np.asarray([cfg.albedo], np.float32), (num_meshes, 1)), device),
            metalness=torch.full((num_meshes,), cfg.metalness, dtype=F32, device=device),
            roughness=torch.full((num_meshes,), cfg.roughness, dtype=F32, device=device),
        )

    @staticmethod
    def varied(num_meshes: int, seed: int = 7, device=None) -> "Materials":
        """Distinct per-mesh materials, drawn from the same numpy stream as
        the JAX package's Materials.varied."""
        device = _dev(device)
        rng = np.random.default_rng(seed)
        return Materials(
            albedo=_t(rng.uniform(0.1, 0.9, (num_meshes, 3)).astype(np.float32), device),
            metalness=_t(rng.uniform(0.0, 1.0, num_meshes).astype(np.float32), device),
            roughness=_t(rng.uniform(0.15, 0.9, num_meshes).astype(np.float32), device),
        )


@dataclasses.dataclass(frozen=True)
class GeometryBuffers:
    """Device copy of the face-vertex expansion, in column layout: triangle t's
    corner v has position fv_pos_cols[v, :, t].  The input-assembler index
    fetch happens once on the host; triangle setup reads the columns with
    neighbouring triangles at neighbouring addresses."""

    fv_pos_cols: torch.Tensor  # [3, 3, T] f32
    fv_nrm_cols: torch.Tensor  # [3, 3, T] f32
    fv_uv_cols: torch.Tensor   # [3, 2, T] f32
    tri_mesh_id: torch.Tensor  # [T] int32

    @staticmethod
    def from_host(geo: SceneGeometry, device=None) -> "GeometryBuffers":
        device = _dev(device)
        idx = geo.indices
        if geo.vertex_source is not None:  # instanced: logical vertex -> storage row
            idx = geo.vertex_source[idx]
        T = idx.shape[0] // 3

        def cols(a, c):
            return _t(np.ascontiguousarray(a[idx].reshape(T, 3, c).transpose(1, 2, 0)), device)

        return GeometryBuffers(
            fv_pos_cols=cols(geo.positions, 3),
            fv_nrm_cols=cols(geo.normals, 3),
            fv_uv_cols=cols(geo.uvs, 2),
            tri_mesh_id=_t(geo.tri_mesh_id, device, torch.int32),
        )


@dataclasses.dataclass(frozen=True)
class SceneState:
    geometry: GeometryBuffers
    position: torch.Tensor     # [M, 3] per-mesh translation
    orientation: torch.Tensor  # [M, 3] (pitch, yaw, roll)
    scale: torch.Tensor        # [M, 3]
    materials: Materials
    camera: Camera
    lights: Lights
    time: torch.Tensor         # [] f32 animation clock


def default_transforms(num_meshes: int) -> tuple:
    """Reference placement: mesh i at x = -2 + 2 i, unit scale
    (main.cpp:888-890).  Numpy arrays (position, orientation, scale)."""
    pos = np.zeros((num_meshes, 3), np.float32)
    pos[:, 0] = -2.0 + 2.0 * np.arange(num_meshes)
    return (
        pos,
        np.zeros((num_meshes, 3), np.float32),
        np.ones((num_meshes, 3), np.float32),
    )


def grid_transforms(num_meshes: int, cols: int = 6, spacing: float = 1.6) -> tuple:
    """Benchmark placement: meshes on a grid centered at the origin (the first
    mesh, the ground plane, stays at the origin).  Numpy arrays."""
    pos = np.zeros((num_meshes, 3), np.float32)
    for k in range(1, num_meshes):
        r, c = divmod(k - 1, cols)
        pos[k] = ((c - (cols - 1) / 2.0) * spacing, -0.4, (r * spacing) - 2.0)
    return (
        pos,
        np.zeros((num_meshes, 3), np.float32),
        np.ones((num_meshes, 3), np.float32),
    )


def make_scene(
    geo: SceneGeometry,
    cfg: RendererConfig,
    lights: Optional[Lights] = None,
    placement: str = "reference",
    materials: Optional[Materials] = None,
    device=None,
) -> SceneState:
    """Upload a host scene to `device` (the CUDA device when None).  `lights`
    and `materials`, when given, must already lie there."""
    device = _dev(device)
    m = geo.num_meshes
    if placement == "reference":
        pos, orient, scale = default_transforms(m)
    elif placement == "grid":
        pos, orient, scale = grid_transforms(m)
    elif placement == "origin":
        # Every mesh at the origin: the layout is in the vertex data
        # (procedural.colonnade_meshes).
        pos = np.zeros((m, 3), np.float32)
        orient, scale = np.zeros((m, 3), np.float32), np.ones((m, 3), np.float32)
    else:
        raise ValueError(f"unknown placement {placement!r}: expected 'reference', 'grid' or 'origin'")
    return SceneState(
        geometry=GeometryBuffers.from_host(geo, device),
        position=_t(pos, device),
        orientation=_t(orient, device),
        scale=_t(scale, device),
        materials=materials if materials is not None else Materials.from_config(cfg, m, device),
        camera=Camera.from_config(cfg, device),
        lights=lights if lights is not None else Lights.directional_only(cfg, device),
        time=torch.zeros((), dtype=F32, device=device),
    )


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floored float modulo from the exact fmod, like jnp.mod."""
    r = torch.fmod(x, y)
    return torch.where((r != 0.0) & ((r < 0.0) != (y < 0.0)), r + y, r)


def animate(state: SceneState, yaw_per_frame: float = 0.01, cfg=None) -> SceneState:
    """Advance the frame-count clock and yaw every mesh (main.cpp:200-207);
    with cfg.animate_camera the camera orbits the scene."""
    t = _mod(state.time + yaw_per_frame, XM_2PI)
    orientation = state.orientation.clone()
    orientation[:, 1] = t
    state = dataclasses.replace(state, time=t, orientation=orientation)
    if cfg is not None and cfg.animate_camera:
        a = (t * max(1.0, round(cfg.orbit_speed))).to(torch.float64)
        eye = torch.stack([
            cfg.orbit_radius * torch.sin(a).to(F32),
            torch.full((), cfg.orbit_height, dtype=F32, device=t.device),
            -cfg.orbit_radius * torch.cos(a).to(F32),
        ])
        state = dataclasses.replace(
            state, camera=dataclasses.replace(state.camera, eye=eye)
        )
    return state


def random_point_lights(
    n: int,
    seed: int = 0,
    extent: float = 8.0,
    radius: float = 3.0,
    intensity: float = 1.2,
    cfg: Optional[RendererConfig] = None,
    device=None,
) -> Lights:
    """N colored point lights, drawn from the same numpy stream as the JAX
    package's random_point_lights."""
    cfg = cfg or RendererConfig()
    device = _dev(device)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-0.5, 3.0, n).astype(np.float32)
    color = rng.uniform(0.25, 1.0, (n, 3)).astype(np.float32)
    return Lights(
        direction=_t(cfg.light_direction, device),
        color=_t(cfg.light_color, device),
        point_position=_t(pos, device),
        point_color=_t(color, device),
        point_radius=torch.full((n,), radius, dtype=F32, device=device),
        point_intensity=torch.full((n,), intensity, dtype=F32, device=device),
    )
