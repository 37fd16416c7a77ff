"""The benchmark scene, generated in numpy from a configuration's `scene`
recipe and a seed.

A frozen copy of the renderer's procedural generators (benchmark meshes,
unified buffers, grid placement, point lights, varied materials), so that
the yardstick does not move when the program's own generators change.
``scene_arrays`` returns one dict of numpy arrays keyed by the dotted field
paths of the program's SceneState (``d3d12_deferred_renderer_tpu_torch.
convert.FIELDS``): the program gets it through ``scene_from_arrays`` and
the reference reads the same arrays.

The meshes, their placement and the set of point lights (drawn once from
the recipe's ``light_seed``) are the same for every seed, so that every
seed asks the same work of a frame: where the lights fall decides how
many each tile shades, and a drawn set moved the flagship's frame rate by
up to 12% from seed to seed.  The seed draws the order of the lights in
the light table, the materials of the meshes and the animation clock's
starting phase.
"""
from __future__ import annotations

import numpy as np

TWO_PI_F32 = np.float32(2.0 * 3.141592653589793)


def _mesh(positions, normals, uvs, indices):
    return (np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.asarray(uvs, np.float32), np.asarray(indices, np.uint32))


def cube(size: float):
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
    return _mesh(pos, nrm, uv, idx)


def uv_sphere(radius: float, rings: int, segments: int):
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    seg_t = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    tt, pp = np.meshgrid(ring_t, seg_t, indexing="ij")
    n = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    idx = []
    for r in range(rings):
        for s in range(segments):
            a, b = r * (segments + 1) + s, r * (segments + 1) + s + 1
            c, d = (r + 1) * (segments + 1) + s, (r + 1) * (segments + 1) + s + 1
            if r != 0:
                idx.extend([a, c, b])
            if r != rings - 1:
                idx.extend([b, c, d])
    return _mesh((radius * n).astype(np.float32), n, uv, idx)


def torus(major: float, minor: float, rings: int, sides: int):
    u = np.linspace(0, 2 * np.pi, rings + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx, cz = np.cos(uu), np.sin(uu)
    pos = np.stack([(major + minor * np.cos(vv)) * cx, minor * np.sin(vv),
                    (major + minor * np.cos(vv)) * cz], -1).reshape(-1, 3)
    nrm = np.stack([np.cos(vv) * cx, np.sin(vv), np.cos(vv) * cz], -1).reshape(-1, 3)
    uv = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], -1).reshape(-1, 2)
    idx = []
    for r in range(rings):
        for s in range(sides):
            a, b = r * (sides + 1) + s, (r + 1) * (sides + 1) + s
            c, d = r * (sides + 1) + s + 1, (r + 1) * (sides + 1) + s + 1
            idx.extend([a, b, c, c, b, d])
    return _mesh(pos, nrm, uv, idx)


def ground_plane(size: float = 20.0, y: float = -1.0):
    h = size * 0.5
    return _mesh([(-h, y, -h), (h, y, -h), (h, y, h), (-h, y, h)], [(0, 1, 0)] * 4,
                 [(0, 0), (1, 0), (1, 1), (0, 1)], [0, 1, 2, 0, 2, 3])


def benchmark_meshes(n: int, rings: int, segments: int) -> list:
    """A ground plane and a grid of spheres, toruses and cubes (23,906
    triangles at n = 24, rings = 24, segments = 48)."""
    kinds = [lambda: uv_sphere(0.45, rings, segments),
             lambda: torus(0.42, 0.16, rings, max(8, segments // 3)),
             lambda: cube(0.7)]
    return [ground_plane()] + [kinds[k % 3]() for k in range(n)]


def grid_positions(num_meshes: int, cols: int = 6, spacing: float = 1.6) -> np.ndarray:
    """Meshes on a grid centred at the origin; the first (the ground) at the origin."""
    pos = np.zeros((num_meshes, 3), np.float32)
    for k in range(1, num_meshes):
        r, c = divmod(k - 1, cols)
        pos[k] = ((c - (cols - 1) / 2.0) * spacing, -0.4, (r * spacing) - 2.0)
    return pos


def geometry_columns(meshes: list) -> dict:
    """Unified buffers laid out as the program's face-vertex columns:
    triangle t's corner v has position fv_pos_cols[v, :, t]."""
    offs = np.cumsum([0] + [m[0].shape[0] for m in meshes[:-1]])
    positions = np.concatenate([m[0] for m in meshes])
    normals = np.concatenate([m[1] for m in meshes])
    uvs = np.concatenate([m[2] for m in meshes])
    idx = np.concatenate([m[3].astype(np.int64) + o for m, o in zip(meshes, offs)])
    mesh_id = np.concatenate([np.full(m[3].shape[0] // 3, k, np.int32) for k, m in enumerate(meshes)])
    T = idx.shape[0] // 3

    def cols(a, c):
        return np.ascontiguousarray(a[idx].reshape(T, 3, c).transpose(1, 2, 0)).astype(np.float32)

    return {"geometry.fv_pos_cols": cols(positions, 3), "geometry.fv_nrm_cols": cols(normals, 3),
            "geometry.fv_uv_cols": cols(uvs, 2), "geometry.tri_mesh_id": mesh_id}


def seed_rng(seed: int) -> np.random.Generator:
    """The seed's generator: any whole number, negative ones too."""
    return np.random.default_rng(abs(int(seed)))


def scene_arrays(recipe: dict, renderer: dict, seed: int) -> dict:
    """The scene of `recipe` (a configuration's "scene") for `seed`, with
    the camera and directional light of `renderer` (its "renderer")."""
    if recipe["meshes"] != "benchmark" or recipe["placement"] != "grid":
        raise ValueError(f"unknown scene recipe {recipe}")
    meshes = benchmark_meshes(recipe["n_meshes"], recipe["rings"], recipe["segments"])
    M = len(meshes)
    L = recipe["lights"]
    ext = recipe["light_extent"]
    fixed = np.random.default_rng(recipe["light_seed"])
    lpos = fixed.uniform(-ext, ext, (L, 3)).astype(np.float32)
    lpos[:, 1] = fixed.uniform(*recipe["light_height"], L).astype(np.float32)
    lcol = fixed.uniform(0.25, 1.0, (L, 3)).astype(np.float32)
    rng = seed_rng(seed)
    order = rng.permutation(L)
    lpos, lcol = lpos[order], lcol[order]
    albedo = rng.uniform(0.1, 0.9, (M, 3)).astype(np.float32)
    metal = rng.uniform(0.0, 1.0, M).astype(np.float32)
    rough = rng.uniform(0.15, 0.9, M).astype(np.float32)
    phase = np.float32(rng.uniform(0.0, float(TWO_PI_F32)))
    orientation = np.zeros((M, 3), np.float32)
    orientation[:, 1] = phase
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return {
        **geometry_columns(meshes),
        "position": grid_positions(M),
        "orientation": orientation,
        "scale": np.ones((M, 3), np.float32),
        "materials.albedo": albedo,
        "materials.metalness": metal,
        "materials.roughness": rough,
        "camera.eye": f32(renderer["eye"]),
        "camera.at": f32(renderer["at"]),
        "camera.up": f32(renderer["up"]),
        "lights.direction": f32(renderer["light_direction"]),
        "lights.color": f32(renderer["light_color"]),
        "lights.point_position": lpos,
        "lights.point_color": lcol,
        "lights.point_radius": np.full((L,), recipe["light_radius"], np.float32),
        "lights.point_intensity": np.full((L,), recipe["light_intensity"], np.float32),
        "time": phase,
    }


def advance_clock(t, yaw_per_frame: float, steps: int):
    """The animation clock after `steps` frames from t, as the renderer
    advances it: one float32 add and a float32 floored modulo by 2 pi a
    frame.  Returns the clock after each step, [steps] float32."""
    out = np.empty((steps,), np.float32)
    t = np.float32(t)
    yaw = np.float32(yaw_per_frame)
    for k in range(steps):
        t = np.fmod(np.float32(t + yaw), TWO_PI_F32)
        if t < 0:
            t = np.float32(t + TWO_PI_F32)
        out[k] = t
    return out
