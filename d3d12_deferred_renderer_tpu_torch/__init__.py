"""The deferred renderer on PyTorch and CUDA (NVIDIA H100).

The port of d3d12_deferred_renderer_tpu (JAX/XLA + Pallas, the reference) to
PyTorch, with the TPU kernels rewritten by hand in CUDA C++ for Hopper
(csrc/).  This package imports torch and numpy only.  It covers the fused
frame: scene + animation -> triangle setup (kernel) -> binning -> fused tile
renderer (raster, exact light cull, G-buffer quantization, PBR shading,
tonemap; kernel) -> uint8.  frame.render_stats says which configs raise
NotImplementedError.  A CUDA kernel runs for tensors on a CUDA device, its
plain PyTorch version for tensors on the CPU.
"""
from .config import FLAGSHIP_CONFIG, REFERENCE_CONFIG, RendererConfig
from .convert import arrays_from_state, scene_from_arrays
from .frame import render, render_stats, step_frame
from .models import build_scene_geometry, procedural
from .scene import (
    Camera,
    GeometryBuffers,
    Lights,
    Materials,
    SceneState,
    animate,
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
    "step_frame",
    "build_scene_geometry",
    "procedural",
    "Camera",
    "GeometryBuffers",
    "Lights",
    "Materials",
    "SceneState",
    "animate",
    "make_scene",
    "random_point_lights",
    "arrays_from_state",
    "scene_from_arrays",
    "xmath",
]
