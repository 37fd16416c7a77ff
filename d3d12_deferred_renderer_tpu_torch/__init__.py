"""The deferred renderer on PyTorch and CUDA (NVIDIA H100).

The port of d3d12_deferred_renderer_tpu (JAX/XLA + Pallas, the reference) to
PyTorch, with the TPU kernels rewritten by hand in CUDA C++ for Hopper
(csrc/).  This package imports torch and numpy only.  It covers the fused
frame (scene + animation -> triangle setup -> binning -> fused tile renderer
-> uint8) and the staged frame (triangle setup -> binning -> tile raster ->
G-buffer -> Lambert, or light cull + G-buffer lighting -> tonemap -> uint8),
each with the config-4 stack (shadow map, procedural bump, bloom, FXAA),
through hand-written kernels; the fused frame culls lights in its kernel or
takes per-tile lists from a depth prepass, and takes shadows as a
visibility plane or through the deferred-directional split.  calibrate
derives a scene's capacity budgets.  parallel.render_sharded renders a
frame as row bands over a torch.distributed group (make_rows_group joins
one; parallel.run_bands runs N ranks on one host); parallel.make_mesh lays
the group out on named axes for render_tri_sharded (triangle shards
composited sort-last) and the batch entry points, and parallel.dryrun
holds each composition to the single-device frame.  step_frame_jit runs a
frame as one CUDA graph, captured once a configuration and replayed;
render_batch replays it N times into one batch, and cfg.supersample
box-averages an s-times frame.  The
application path: runtime.App (the frame loop with the triple-buffered
PresentQueue or the DeltaPresentQueue), runtime.NativeFrameSink and
PassProfiler, scene_io checkpoints, utils (PNG IO, validate_scene,
debug_layer) and the native C++ OBJ loader (models/native).  Scenes live
on the CUDA device unless the caller passes device="cpu"; a CUDA kernel
runs for tensors on a CUDA device, its plain PyTorch version for tensors
on the CPU.
"""
from .calibrate import autotune, autotune_shadow
from .config import FLAGSHIP_CONFIG, REFERENCE_CONFIG, RendererConfig
from .convert import arrays_from_state, scene_from_arrays
from .frame import render, render_batch, render_gbuffer, render_stats, step_frame, step_frame_jit
from .models import build_instanced_geometry, build_scene_geometry, load_obj, procedural
from .scene import (
    Camera,
    GeometryBuffers,
    Lights,
    Materials,
    SceneState,
    animate,
    default_device,
    make_scene,
    random_point_lights,
)
from . import parallel, xmath
from .parallel import make_rows_group, render_sharded

__all__ = [
    "RendererConfig",
    "REFERENCE_CONFIG",
    "FLAGSHIP_CONFIG",
    "autotune",
    "autotune_shadow",
    "render",
    "render_stats",
    "render_gbuffer",
    "render_batch",
    "step_frame",
    "step_frame_jit",
    "render_sharded",
    "make_rows_group",
    "parallel",
    "build_scene_geometry",
    "build_instanced_geometry",
    "load_obj",
    "procedural",
    "Camera",
    "GeometryBuffers",
    "Lights",
    "Materials",
    "SceneState",
    "animate",
    "make_scene",
    "default_device",
    "random_point_lights",
    "arrays_from_state",
    "scene_from_arrays",
    "xmath",
]
