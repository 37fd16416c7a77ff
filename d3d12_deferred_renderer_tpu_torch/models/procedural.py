"""Procedurally generated meshes for the benchmark scene (host side, numpy).

A copy of the generators in d3d12_deferred_renderer_tpu/models/procedural.py
that benchmark_meshes and colonnade_meshes use; tests/test_torch_frame.py
pins the arrays equal.
Every generator winds triangles to show EXTERIORS under the reference
rasterizer state (back-face culling, FrontCounterClockwise=TRUE,
main.cpp:727-728).
"""
from __future__ import annotations

import numpy as np

from .meshlib import MeshData


def cube(size: float = 1.0) -> MeshData:
    """Axis-aligned cube with faceted normals (24 vertices, 36 indices)."""
    h = size * 0.5
    faces = [
        ((0, 0, 1), [(-h, -h, h), (h, -h, h), (h, h, h), (-h, h, h)]),
        ((0, 0, -1), [(h, -h, -h), (-h, -h, -h), (-h, h, -h), (h, h, -h)]),
        ((0, 1, 0), [(-h, h, h), (h, h, h), (h, h, -h), (-h, h, -h)]),
        ((0, -1, 0), [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)]),
        ((1, 0, 0), [(h, -h, h), (h, -h, -h), (h, h, -h), (h, h, h)]),
        ((-1, 0, 0), [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, corners in faces:
        base = len(pos)
        for k, c in enumerate(corners):
            pos.append(c)
            nrm.append(n)
            uv.append(((k in (1, 2)) * 1.0, (k >= 2) * 1.0))
        idx.extend([base, base + 2, base + 1, base, base + 3, base + 2])
    return MeshData(
        positions=np.asarray(pos, np.float32),
        normals=np.asarray(nrm, np.float32),
        uvs=np.asarray(uv, np.float32),
        indices=np.asarray(idx, np.uint32),
        name="cube",
    )


def uv_sphere(radius: float = 0.5, rings: int = 16, segments: int = 32) -> MeshData:
    """Smooth-shaded UV sphere; 2*(rings-1)*segments triangles."""
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    seg_t = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    tt, pp = np.meshgrid(ring_t, seg_t, indexing="ij")
    x = np.sin(tt) * np.cos(pp)
    y = np.cos(tt)
    z = np.sin(tt) * np.sin(pp)
    n = np.stack([x, y, z], -1).reshape(-1, 3)
    pos = (radius * n).astype(np.float32)
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)

    def vid(r, s):
        return r * (segments + 1) + s

    idx = []
    for r in range(rings):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            if r != 0:
                idx.extend([a, c, b])
            if r != rings - 1:
                idx.extend([b, c, d])
    return MeshData(
        positions=pos,
        normals=n.astype(np.float32),
        uvs=uv.astype(np.float32),
        indices=np.asarray(idx, np.uint32),
        name="sphere",
    )


def torus(major: float = 0.6, minor: float = 0.25, rings: int = 24, sides: int = 16) -> MeshData:
    """Smooth torus; 2*rings*sides triangles, seam rings duplicated."""
    u = np.linspace(0, 2 * np.pi, rings + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx, cz = np.cos(uu), np.sin(uu)
    pos = np.stack(
        [(major + minor * np.cos(vv)) * cx, minor * np.sin(vv), (major + minor * np.cos(vv)) * cz],
        -1,
    ).reshape(-1, 3)
    nrm = np.stack([np.cos(vv) * cx, np.sin(vv), np.cos(vv) * cz], -1).reshape(-1, 3)
    uv = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], -1).reshape(-1, 2)

    def vid(r, s):
        return r * (sides + 1) + s

    idx = []
    for r in range(rings):
        for s in range(sides):
            a, b = vid(r, s), vid(r + 1, s)
            c, d = vid(r, s + 1), vid(r + 1, s + 1)
            idx.extend([a, b, c, c, b, d])
    return MeshData(
        positions=pos.astype(np.float32),
        normals=nrm.astype(np.float32),
        uvs=uv.astype(np.float32),
        indices=np.asarray(idx, np.uint32),
        name="torus",
    )


def ground_plane(size: float = 20.0, y: float = -1.0) -> MeshData:
    h = size * 0.5
    pos = np.asarray([(-h, y, -h), (h, y, -h), (h, y, h), (-h, y, h)], np.float32)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    uv = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)  # upward-facing
    return MeshData(pos, nrm, uv, idx, name="ground")


def colonnade_meshes(
    n_columns: int = 12, n_orbs: int = 10, rings: int = 20, segments: int = 40
) -> list[MeshData]:
    """The second benchmark layout, with another footprint profile than
    benchmark_meshes: a larger ground slab, a ring of tall columns (wide
    screen quads at grazing angles: the medium and large binning tiers) and
    a line of spheres and toruses marching toward the far plane (small far
    footprints: the small tier and the live-light lists).  Its layout is in
    the vertices: place it with make_scene(placement="origin")."""
    meshes: list[MeshData] = [ground_plane(size=28.0)]
    for k in range(n_columns):
        c = cube(1.0)
        # The unit cube stretched into a 0.6 x 3.2 x 0.6 column standing on
        # the ground plane (y = -1).
        c.positions[:, 0] *= 0.6
        c.positions[:, 1] *= 3.2
        c.positions[:, 2] *= 0.6
        c.positions[:, 1] += 0.6
        ang = 2.0 * np.pi * k / n_columns
        r = 6.5
        c.positions[:, 0] += r * np.cos(ang)
        c.positions[:, 2] += r * np.sin(ang)
        meshes.append(c)
    for k in range(n_orbs):
        m = uv_sphere(0.5, rings, segments) if k % 2 == 0 else torus(
            0.45, 0.18, rings, max(8, segments // 3)
        )
        m.positions[:, 2] += -4.0 + 2.2 * k  # toward the far plane
        m.positions[:, 0] += (-1.0) ** k * 1.5
        meshes.append(m)
    return meshes


def benchmark_meshes(n: int = 24, rings: int = 24, segments: int = 48) -> list[MeshData]:
    """The benchmark scene: a ground plane plus a grid of spheres, toruses and
    cubes (23,906 triangles at the defaults)."""
    meshes: list[MeshData] = [ground_plane()]
    kinds = [
        lambda: uv_sphere(0.45, rings, segments),
        lambda: torus(0.42, 0.16, rings, max(8, segments // 3)),
        lambda: cube(0.7),
    ]
    for k in range(n):
        meshes.append(kinds[k % len(kinds)]())
    return meshes
