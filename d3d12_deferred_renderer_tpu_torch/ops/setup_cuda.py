"""Triangle setup kernel wrappers (csrc/setup.cu).

``setup_triangles`` (the camera pass) and ``setup_depth_triangles`` (the
depth-only light-view pass of the shadow map) run the CUDA kernel on CUDA
tensors and its plain PyTorch version (transform.setup_triangles_reference,
transform.setup_depth_reference) on CPU tensors; the two take the same
inputs and return the same records.  Each wrapper's ``launches`` counts its
kernel launches.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from .transform import (
    CULL_MODES, TRI_STRIDE, TRI_VALID, TriSetup, setup_depth_reference, setup_triangles_reference,
)

F32 = torch.float32
# Per-mesh matrices staged in shared memory: 25 floats a mesh, 48 KB static.
MAX_MESHES = (48 * 1024) // (25 * 4)


def _outputs(pos_cols, tri_mesh_id, mvp, cull, **extra):
    """Check a setup launch's inputs: pos_cols, tri_mesh_id, mvp and the
    extra f32 tensors, each given as name=(tensor, shape).  Returns the
    records [2T, 32] and boxes [2T, 4] to fill."""
    if cull not in CULL_MODES:
        raise ValueError(f"unknown cull mode {cull!r}")
    T = tri_mesh_id.shape[0]
    M = mvp.shape[0]
    cuda_build.check_tensors(
        pos_cols.device,
        pos_cols=(pos_cols, F32, (3, 3, T)),
        tri_mesh_id=(tri_mesh_id, torch.int32, (T,)),
        mvp=(mvp, F32, (M, 4, 4)),
        **{name: (t, F32, shape) for name, (t, shape) in extra.items()},
    )
    if not 0 < M <= MAX_MESHES:
        raise ValueError(f"{M} meshes: the setup kernel stages at most {MAX_MESHES}")
    packed = torch.empty((2 * T, TRI_STRIDE), dtype=F32, device=pos_cols.device)
    aabb = torch.empty((2 * T, 4), dtype=F32, device=pos_cols.device)
    return packed, aabb


def setup_triangles(
    pos_cols, nrm_cols, uv_cols, tri_mesh_id, mvp, model, width, height,
    cull="back",
) -> TriSetup:
    """Setup records [2T, 32], AABBs [2T, 4] and valid [2T] of T triangles.

    pos_cols/nrm_cols [3, 3, T], uv_cols [3, 2, T] f32 face-vertex columns,
    tri_mesh_id [T] int32 in [0, M), mvp/model [M, 4, 4] f32."""
    if pos_cols.device.type == "cpu":
        return setup_triangles_reference(
            pos_cols, nrm_cols, uv_cols, tri_mesh_id, mvp, model, width, height,
            cull=cull,
        )
    T, M = tri_mesh_id.shape[0], mvp.shape[0]
    packed, aabb = _outputs(pos_cols, tri_mesh_id, mvp, cull, nrm_cols=(nrm_cols, (3, 3, T)),
                            uv_cols=(uv_cols, (3, 2, T)), model=(model, (M, 4, 4)))
    err = cuda_build.library().setup_triangles_launch(
        pos_cols.data_ptr(), nrm_cols.data_ptr(), uv_cols.data_ptr(),
        tri_mesh_id.data_ptr(), mvp.data_ptr(), model.data_ptr(), T, M,
        float(width), float(height), CULL_MODES.index(cull),
        packed.data_ptr(), aabb.data_ptr(),
        torch.cuda.current_stream(pos_cols.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "setup_triangles")
    setup_triangles.launches += 1
    return TriSetup(packed=packed, aabb=aabb, valid=packed[:, TRI_VALID] > 0.0)


setup_triangles.launches = 0


def setup_depth_triangles(pos_cols, tri_mesh_id, mvp, width, height, cull="none") -> TriSetup:
    """Depth-only setup of T triangles (the shadow map's light view): the
    same records as setup_triangles without the normal and uv transform,
    fields 12-26 zero.  pos_cols [3, 3, T] f32, tri_mesh_id [T] int32,
    mvp [M, 4, 4] f32."""
    if pos_cols.device.type == "cpu":
        return setup_depth_reference(pos_cols, tri_mesh_id, mvp, width, height, cull=cull)
    T, M = tri_mesh_id.shape[0], mvp.shape[0]
    packed, aabb = _outputs(pos_cols, tri_mesh_id, mvp, cull)
    err = cuda_build.library().setup_depth_launch(
        pos_cols.data_ptr(), tri_mesh_id.data_ptr(), mvp.data_ptr(), T, M,
        float(width), float(height), CULL_MODES.index(cull),
        packed.data_ptr(), aabb.data_ptr(),
        torch.cuda.current_stream(pos_cols.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "setup_depth_triangles")
    setup_depth_triangles.launches += 1
    return TriSetup(packed=packed, aabb=aabb, valid=packed[:, TRI_VALID] > 0.0)


setup_depth_triangles.launches = 0
