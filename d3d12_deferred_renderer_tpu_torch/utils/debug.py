"""Debug validation: the D3D12 debug layer's counterpart (SURVEY.md section 5).

The counterpart of d3d12_deferred_renderer_tpu/utils/debug.py.  The
reference enables the debug layer in debug builds (main.cpp:379-390) to
catch API misuse at run time; here the hazards are numerical (a NaN or Inf
escaping a pass) and malformed scene state.

``debug_layer`` is a scope in which the frame checks its float stages (the
G-buffer, the shadow visibility, the HDR or colour before ``to_uint8``, the
fused kernel's output) with ``torch.isfinite`` and raises
``FloatingPointError`` naming the first stage that holds a NaN or an Inf.
JAX's version flips ``jax_debug_nans``, which traps the operation that made
the value; PyTorch has no such trap for the forward pass
(``set_detect_anomaly`` checks backward only), so the port checks at the
stage boundaries.  Outside the scope ``check_finite`` returns at once:
no check, no device sync.

``validate_scene`` fails fast on malformed scene state before the first
frame, with JAX's message for each defect both packages can have.  The
JAX module's ``enable_compilation_cache`` (XLA's persistent cache) has no
counterpart: the kernels' build cache in build/torch_kernels/, keyed by a
hash of the sources, plays that role.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

# (nans, infs) inside a debug_layer scope, None outside.
_LAYER: contextvars.ContextVar = contextvars.ContextVar("debug_layer", default=None)


@contextlib.contextmanager
def debug_layer(nans: bool = True, infs: bool = True):
    """Check the frame's float stages for NaN (nans) and Inf (infs) in the
    enclosed scope; the previous state comes back on exit, exceptions
    included."""
    token = _LAYER.set((nans, infs))
    try:
        yield
    finally:
        _LAYER.reset(token)


def layer_active() -> bool:
    """Whether the caller is inside a debug_layer scope: the frame then
    reads its stages on the host, so frame.step_frame_jit runs it op by
    op instead of replaying a CUDA graph."""
    return _LAYER.get() is not None


def check_finite(stage: str, *tensors: torch.Tensor) -> None:
    """Inside a debug_layer scope, raise FloatingPointError if a float
    tensor among `tensors` holds a NaN (or an Inf) the scope checks for;
    outside it, nothing."""
    flags = _LAYER.get()
    if flags is None:
        return
    nans, infs = flags
    for t in tensors:
        if not t.is_floating_point():
            continue
        if nans and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"debug_layer: NaN in the {stage}")
        if infs and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"debug_layer: Inf in the {stage}")


def validate_scene(state, cfg) -> None:
    """Fail fast with a clear message on malformed scene state: the
    face-vertex columns' shapes, tri_mesh_id's length and range [0, M), the
    per-mesh arrays' shapes, finite mesh positions, an even framebuffer."""
    geo = state.geometry
    T = geo.fv_pos_cols.shape[-1]
    problems = []
    for name, arr, shape in [
        ("fv_pos_cols", geo.fv_pos_cols, (3, 3, T)),
        ("fv_nrm_cols", geo.fv_nrm_cols, (3, 3, T)),
        ("fv_uv_cols", geo.fv_uv_cols, (3, 2, T)),
    ]:
        if tuple(arr.shape) != shape:
            problems.append(f"{name} shape {tuple(arr.shape)} != {shape}")
    if tuple(geo.tri_mesh_id.shape) != (T,):
        problems.append("tri_mesh_id length != triangle count")
    M = state.position.shape[0]
    # A tri_mesh_id outside [0, M) selects a zero matrix in the setup
    # kernel and its plain version: garbage frames, no error.
    tmid = geo.tri_mesh_id
    if tmid.numel():
        lo, hi = int(tmid.min()), int(tmid.max())
        if lo < 0 or hi >= M:
            problems.append(f"tri_mesh_id out of range [0, {M}): min={lo} max={hi}")
    for name, arr, shape in [
        ("position", state.position, (M, 3)),
        ("orientation", state.orientation, (M, 3)),
        ("scale", state.scale, (M, 3)),
        ("materials.albedo", state.materials.albedo, (M, 3)),
        ("materials.metalness", state.materials.metalness, (M,)),
        ("materials.roughness", state.materials.roughness, (M,)),
    ]:
        if tuple(arr.shape) != shape:
            problems.append(f"{name} shape {tuple(arr.shape)} != {shape}")
    if not bool(torch.isfinite(state.position).all()):
        problems.append("non-finite mesh positions")
    if cfg.width % 2 or cfg.height % 2:
        problems.append(f"odd framebuffer size {cfg.width}x{cfg.height}")
    if problems:
        raise ValueError("invalid scene state:\n  - " + "\n  - ".join(problems))
