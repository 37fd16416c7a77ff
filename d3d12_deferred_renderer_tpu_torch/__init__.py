"""The deferred renderer on PyTorch and CUDA (NVIDIA H100).

The port of d3d12_deferred_renderer_tpu (JAX/XLA + Pallas, the reference) to
PyTorch, with the TPU kernels rewritten by hand in CUDA C++ for Hopper
(csrc/).  This package imports torch and numpy only.  It covers the fused
frame (scene + animation -> triangle setup -> binning -> fused tile renderer
-> uint8) and the staged frame (triangle setup -> binning -> tile raster ->
G-buffer -> Lambert, or light cull + G-buffer lighting -> tonemap -> uint8),
each with the config-4 stack (shadow map, procedural bump, bloom, FXAA;
the fused frame's shadows through the deferred-directional split), through
hand-written kernels; frame.check_ported says which configs raise
NotImplementedError.  Scenes live on the CUDA device unless the caller
passes device="cpu"; a CUDA kernel runs for tensors on a CUDA device, its
plain PyTorch version for tensors on the CPU.
"""
from .config import FLAGSHIP_CONFIG, REFERENCE_CONFIG, RendererConfig
from .convert import arrays_from_state, scene_from_arrays
from .frame import render, render_gbuffer, render_stats, step_frame
from .models import build_scene_geometry, load_obj, procedural
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
from . import xmath

__all__ = [
    "RendererConfig",
    "REFERENCE_CONFIG",
    "FLAGSHIP_CONFIG",
    "render",
    "render_stats",
    "render_gbuffer",
    "step_frame",
    "build_scene_geometry",
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
