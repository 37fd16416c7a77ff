"""Triangle setup kernel wrappers (csrc/setup.cu).

``setup_triangles`` (the camera pass) and ``setup_depth_triangles`` (the
depth-only light-view pass of the shadow map) run the CUDA kernel on CUDA
tensors and its plain PyTorch version (transform.setup_triangles_reference,
transform.setup_depth_reference) on CPU tensors; the two take the same
inputs and return the same records, boxes and valid flags (the kernel writes
all three, for any number of meshes).  Each wrapper's ``launches`` counts
its kernel launches.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from .transform import CULL_MODES, TRI_STRIDE, TriSetup, setup_depth_reference, setup_triangles_reference

F32 = torch.float32


def _outputs(pos_cols, tri_mesh_id, mvp, cull, **extra):
    """Check a setup launch's inputs: pos_cols, tri_mesh_id, mvp and the
    extra f32 tensors, each given as name=(tensor, shape).  Returns the
    TriSetup to fill: records [2T, 32], boxes [2T, 4] and valid [2T]."""
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
    dev = pos_cols.device
    return TriSetup(packed=torch.empty((2 * T, TRI_STRIDE), dtype=F32, device=dev),
                    aabb=torch.empty((2 * T, 4), dtype=F32, device=dev),
                    valid=torch.empty((2 * T,), dtype=torch.bool, device=dev))


def setup_triangles(
    pos_cols, nrm_cols, uv_cols, tri_mesh_id, mvp, model, width, height,
    cull="back", near_clip=True,
) -> TriSetup:
    """Setup records [2T, 32], AABBs [2T, 4] and valid [2T] of T triangles.

    pos_cols/nrm_cols [3, 3, T], uv_cols [3, 2, T] f32 face-vertex columns,
    tri_mesh_id [T] int32 in [0, M), mvp/model [M, 4, 4] f32.  near_clip=False
    (T unclipped records) exists only in the plain version: on CUDA tensors
    it raises ValueError."""
    if pos_cols.device.type == "cpu":
        return setup_triangles_reference(
            pos_cols, nrm_cols, uv_cols, tri_mesh_id, mvp, model, width, height,
            cull=cull, near_clip=near_clip,
        )
    if not near_clip:
        raise ValueError("the setup kernel always clips at the near plane: near_clip=False runs only on "
                         "CPU tensors (the plain version)")
    T, M = tri_mesh_id.shape[0], mvp.shape[0]
    out = _outputs(pos_cols, tri_mesh_id, mvp, cull, nrm_cols=(nrm_cols, (3, 3, T)),
                   uv_cols=(uv_cols, (3, 2, T)), model=(model, (M, 4, 4)))
    err = cuda_build.library().setup_triangles_launch(
        pos_cols.data_ptr(), nrm_cols.data_ptr(), uv_cols.data_ptr(),
        tri_mesh_id.data_ptr(), mvp.data_ptr(), model.data_ptr(), T, M,
        float(width), float(height), CULL_MODES.index(cull),
        out.packed.data_ptr(), out.aabb.data_ptr(), out.valid.data_ptr(),
        torch.cuda.current_stream(pos_cols.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "setup_triangles")
    setup_triangles.launches += 1
    return out


setup_triangles.launches = 0


def setup_depth_triangles(pos_cols, tri_mesh_id, mvp, width, height, cull="none") -> TriSetup:
    """Depth-only setup of T triangles (the shadow map's light view): the
    same records as setup_triangles without the normal and uv transform,
    fields 12-26 zero.  pos_cols [3, 3, T] f32, tri_mesh_id [T] int32,
    mvp [M, 4, 4] f32."""
    if pos_cols.device.type == "cpu":
        return setup_depth_reference(pos_cols, tri_mesh_id, mvp, width, height, cull=cull)
    T, M = tri_mesh_id.shape[0], mvp.shape[0]
    out = _outputs(pos_cols, tri_mesh_id, mvp, cull)
    err = cuda_build.library().setup_depth_launch(
        pos_cols.data_ptr(), tri_mesh_id.data_ptr(), mvp.data_ptr(), T, M,
        float(width), float(height), CULL_MODES.index(cull),
        out.packed.data_ptr(), out.aabb.data_ptr(), out.valid.data_ptr(),
        torch.cuda.current_stream(pos_cols.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "setup_depth_triangles")
    setup_depth_triangles.launches += 1
    return out


setup_depth_triangles.launches = 0
