"""Mesh containers and the unified-buffer scene layout (host side, numpy).

The reference concatenates every loaded mesh into one unified vertex buffer and
one unified index buffer with per-mesh offsets (source/main.cpp:836-913).  The
same layout feeds the port: the scene is built on the host in numpy and copied
to the device once, in scene.GeometryBuffers.from_host.

A copy of d3d12_deferred_renderer_tpu/models/meshlib.py (MeshData,
SceneGeometry, build_scene_geometry, build_instanced_geometry): that package
imports JAX at package import, so the port carries its own.
tests/test_torch_frame.py pins the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """One mesh: SoA vertex arrays + local 0-based triangle indices
    (struct Mesh / struct Vertex, main.cpp:27-45)."""

    positions: np.ndarray  # [V, 3] float32
    normals: np.ndarray    # [V, 3] float32
    uvs: np.ndarray        # [V, 2] float32
    indices: np.ndarray    # [I] uint32, I % 3 == 0
    name: str = ""

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)

    @property
    def has_normals(self) -> bool:
        """True only when EVERY referenced vertex carries a nonzero normal — a
        mesh with `vn` on just some faces (mixed exporters) must still get
        generated normals for the zero rest, or those triangles shade black
        (the exact reference bug generate_normals exists to avoid)."""
        if self.indices.size == 0:
            return bool(np.any(self.normals))
        used = self.normals[self.indices.astype(np.int64)]
        return bool(np.all(np.any(used != 0.0, axis=-1)))

    def with_flat_normals(self) -> "MeshData":
        """Faceted re-mesh with per-face geometric normals.

        For OBJ files without `vn` data (the reference would shade those black:
        its loader leaves normals zero-initialized, main.cpp:1010-1025 — another
        latent case its assets never hit).  Each triangle gets its own 3 vertices
        carrying the face normal, oriented by the winding (counter-clockwise from
        outside -> outward normal)."""
        idx = self.indices.reshape(-1, 3).astype(np.int64)
        p0 = self.positions[idx[:, 0]]
        p1 = self.positions[idx[:, 1]]
        p2 = self.positions[idx[:, 2]]
        # Sign convention: triangles wound front-facing under the reference
        # rasterizer state (visually CCW from outside; see ops/transform.py) get
        # OUTWARD normals — cross(e2, e1) under this framework's LH conventions.
        n = np.cross(p2 - p0, p1 - p0)
        length = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(length == 0.0, 1.0, length)
        positions = np.stack([p0, p1, p2], axis=1).reshape(-1, 3)
        normals = np.repeat(n, 3, axis=0)
        uvs = self.uvs[idx.reshape(-1)]
        indices = np.arange(idx.size, dtype=np.uint32)
        return MeshData(
            positions=positions.astype(np.float32),
            normals=normals.astype(np.float32),
            uvs=uvs.astype(np.float32),
            indices=indices,
            name=self.name,
        )


@dataclasses.dataclass
class SceneGeometry:
    """All meshes packed into unified buffers (main.cpp:836-913).

    ``indices`` are globalized (local index + vertex_offsets[mesh]) into
    the logical vertex space; ``tri_mesh_id`` gives every triangle its mesh
    (its instance when instanced)."""

    positions: np.ndarray       # [Vb, 3] float32 (unified base storage)
    normals: np.ndarray         # [Vb, 3] float32
    uvs: np.ndarray             # [Vb, 2] float32
    indices: np.ndarray         # [I] int32, into the logical vertex space
    tri_mesh_id: np.ndarray     # [I // 3] int32
    vertex_mesh_id: np.ndarray  # [V] int32, per logical vertex
    vertex_offsets: np.ndarray  # [M] int32 (logical space)
    vertex_counts: np.ndarray   # [M] int32
    index_offsets: np.ndarray   # [M] int32
    index_counts: np.ndarray    # [M] int32
    names: tuple
    # Instancing (DrawIndexedInstanced with instanceCount > 1, main.cpp:240):
    # logical vertices map onto shared base storage, so N instances of a
    # mesh reuse its attribute arrays.  None = identity (not instanced).
    vertex_source: np.ndarray | None = None  # [V] int32 -> row in positions et al.

    @property
    def num_meshes(self) -> int:
        return int(self.vertex_offsets.shape[0])

    @property
    def num_vertices(self) -> int:
        """Logical vertex count (what indices address)."""
        if self.vertex_source is not None:
            return int(self.vertex_source.shape[0])
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)


def build_scene_geometry(meshes: list[MeshData]) -> SceneGeometry:
    if not meshes:
        raise ValueError("scene needs at least one mesh")
    v_off, i_off = [], []
    vo = io = 0
    for m in meshes:
        v_off.append(vo)
        i_off.append(io)
        vo += m.num_vertices
        io += int(m.indices.shape[0])
    positions = np.concatenate([m.positions for m in meshes], axis=0)
    normals = np.concatenate([m.normals for m in meshes], axis=0)
    uvs = np.concatenate([m.uvs for m in meshes], axis=0)
    indices = np.concatenate(
        [m.indices.astype(np.int64) + off for m, off in zip(meshes, v_off)], axis=0
    ).astype(np.int32)
    tri_mesh_id = np.concatenate(
        [np.full(m.num_triangles, k, np.int32) for k, m in enumerate(meshes)]
    )
    vertex_mesh_id = np.concatenate(
        [np.full(m.num_vertices, k, np.int32) for k, m in enumerate(meshes)]
    )
    return SceneGeometry(
        positions=positions.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs.astype(np.float32),
        indices=indices,
        tri_mesh_id=tri_mesh_id,
        vertex_mesh_id=vertex_mesh_id,
        vertex_offsets=np.asarray(v_off, np.int32),
        vertex_counts=np.asarray([m.num_vertices for m in meshes], np.int32),
        index_offsets=np.asarray(i_off, np.int32),
        index_counts=np.asarray([int(m.indices.shape[0]) for m in meshes], np.int32),
        names=tuple(m.name for m in meshes),
    )


def build_instanced_geometry(meshes: list[MeshData], instance_of: list[int]) -> SceneGeometry:
    """Unified buffers for N instances drawn from a unique-mesh pool.

    `instance_of[j]` names the mesh each instance j renders.  Vertex attribute
    storage is shared across instances (the base pool is concatenated once);
    instances expand only the int32 maps, as DrawIndexedInstanced(count, N,
    ...) does, with per-instance transforms and materials from the
    SceneState arrays."""
    if not meshes or not instance_of:
        raise ValueError("need at least one mesh and one instance")
    if max(instance_of) >= len(meshes) or min(instance_of) < 0:
        raise ValueError("instance_of references a mesh outside the pool")

    base_v_off = np.zeros(len(meshes), np.int64)
    vo = 0
    for k, m in enumerate(meshes):
        base_v_off[k] = vo
        vo += m.num_vertices

    positions = np.concatenate([m.positions for m in meshes], axis=0)
    normals = np.concatenate([m.normals for m in meshes], axis=0)
    uvs = np.concatenate([m.uvs for m in meshes], axis=0)

    v_off, i_off, v_cnt, i_cnt = [], [], [], []
    vertex_source, vertex_inst, indices, tri_inst, names = [], [], [], [], []
    lv = li = 0
    for j, mk in enumerate(instance_of):
        m = meshes[mk]
        v_off.append(lv)
        i_off.append(li)
        v_cnt.append(m.num_vertices)
        i_cnt.append(int(m.indices.shape[0]))
        vertex_source.append(np.arange(m.num_vertices, dtype=np.int64) + base_v_off[mk])
        vertex_inst.append(np.full(m.num_vertices, j, np.int32))
        indices.append(m.indices.astype(np.int64) + lv)
        tri_inst.append(np.full(m.num_triangles, j, np.int32))
        names.append(f"{m.name}#{j}")
        lv += m.num_vertices
        li += int(m.indices.shape[0])

    return SceneGeometry(
        positions=positions.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs.astype(np.float32),
        indices=np.concatenate(indices).astype(np.int32),
        tri_mesh_id=np.concatenate(tri_inst),
        vertex_mesh_id=np.concatenate(vertex_inst),
        vertex_offsets=np.asarray(v_off, np.int32),
        vertex_counts=np.asarray(v_cnt, np.int32),
        index_offsets=np.asarray(i_off, np.int32),
        index_counts=np.asarray(i_cnt, np.int32),
        names=tuple(names),
        vertex_source=np.concatenate(vertex_source).astype(np.int32),
    )
