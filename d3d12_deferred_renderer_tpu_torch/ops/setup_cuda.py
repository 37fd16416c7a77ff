"""Triangle setup kernel wrapper (csrc/setup.cu).

``setup_triangles`` runs the CUDA kernel on CUDA tensors and its plain
PyTorch version (transform.setup_triangles_reference) on CPU tensors; the two
take the same inputs and return the same records.  ``setup_triangles.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from .transform import CULL_MODES, TRI_STRIDE, TRI_VALID, TriSetup, setup_triangles_reference

F32 = torch.float32
# Per-mesh matrices staged in shared memory: 25 floats a mesh, 48 KB static.
MAX_MESHES = (48 * 1024) // (25 * 4)


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
    if cull not in CULL_MODES:
        raise ValueError(f"unknown cull mode {cull!r}")
    T = tri_mesh_id.shape[0]
    M = mvp.shape[0]
    cuda_build.check_tensors(
        pos_cols.device,
        pos_cols=(pos_cols, F32, (3, 3, T)),
        nrm_cols=(nrm_cols, F32, (3, 3, T)),
        uv_cols=(uv_cols, F32, (3, 2, T)),
        tri_mesh_id=(tri_mesh_id, torch.int32, (T,)),
        mvp=(mvp, F32, (M, 4, 4)),
        model=(model, F32, (M, 4, 4)),
    )
    if not 0 < M <= MAX_MESHES:
        raise ValueError(f"{M} meshes: the setup kernel stages at most {MAX_MESHES}")
    packed = torch.empty((2 * T, TRI_STRIDE), dtype=F32, device=pos_cols.device)
    aabb = torch.empty((2 * T, 4), dtype=F32, device=pos_cols.device)
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
