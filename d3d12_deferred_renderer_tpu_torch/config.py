"""RendererConfig — the flag surface of the renderer.

A copy of d3d12_deferred_renderer_tpu/config.py: the same fields, defaults
and the two named configs, so that one configuration means the same frame in
both packages (tests/test_torch_frame.py pins ``dataclasses.asdict`` equal).
The knobs that only shape the TPU program (``use_pallas``, ``setup_pallas``,
``stream_dma_db``, ``tile_*``, ...) stay as fields for that comparison; the
port reads the tile size and every capacity budget, and ignores the rest.
The PyTorch frame covers the fused PBR path with in-kernel light culling
(frame.py says which configs raise NotImplementedError).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .xmath import XM_PIDIV4


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    # --- Window / framebuffer (main.cpp:78-79) ---
    width: int = 1280
    height: int = 720

    # --- Presentation (main.cpp:84, 167-171) ---
    frames_in_flight: int = 3  # triple buffering

    # --- Camera (main.cpp:214-224) ---
    eye: Tuple[float, float, float] = (0.0, 1.0, -8.0)
    at: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y: float = XM_PIDIV4
    z_near: float = 0.1
    z_far: float = 100.0

    # --- Animation (main.cpp:201-207): yaw advances 0.01 rad per frame, mod 2pi ---
    yaw_per_frame: float = 0.01

    # --- Directional light (main.cpp:245-247) ---
    light_direction: Tuple[float, float, float] = (-0.3, -0.2, -1.0)
    light_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # --- Material constants (geometry.hlsl:46-49) ---
    albedo: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    metalness: float = 0.0
    roughness: float = 0.5

    # --- Lighting constants (lighting.hlsl:45, 37, 48) ---
    ambient: float = 0.3
    gamma: float = 2.2

    # --- G-buffer quantization parity: RGBA8 / R10G10B10A2 UNORM between the
    # passes (main.cpp:476, 485, 509) ---
    quantize_gbuffer: bool = True

    # --- Documented only: the lighting pass overwrites every pixel, so the
    # background shades to black (main.cpp:294-307) ---
    clear_color: Tuple[float, float, float] = (0.39, 0.58, 0.93)

    # --- Shading model: "lambert" (reference parity) or "pbr" (GGX) ---
    shading: str = "lambert"

    # --- Tonemap applied in pbr mode before gamma ("none" | "reinhard") ---
    tonemap: str = "reinhard"

    # --- Post chain (BASELINE config 4) ---
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_strength: float = 0.15
    fxaa: bool = False

    # --- Shadow mapping (BASELINE config 4) and its sparse-PCF budgets ---
    shadows: bool = False
    shadow_map_size: int = 1024
    shadow_vis_downsample: int = 1
    shadow_tiles_cap: int = 0
    shadow_tiles_cap_lit: int = 0
    shadow_window_gather: bool = False
    shadow_bad_quads_cap: int = -1
    shadow_bin_tiers: Tuple[int, int, int, int, int, int, int] | None = None

    # --- Procedural normal mapping (BASELINE config 4) ---
    normal_mapping: bool = False
    bump_strength: float = 0.35
    bump_frequency: float = 24.0

    # --- Supersampled antialiasing (render at N x, box-filter down) ---
    supersample: int = 1

    # --- Camera flythrough (BASELINE config 5) ---
    animate_camera: bool = False
    orbit_radius: float = 8.0
    orbit_height: float = 2.5
    orbit_speed: float = 1.0  # whole revolutions per animation-clock cycle

    # --- Screen tiling and capacity budgets ---
    tile_h: int = 8     # screen tile height
    tile_w: int = 128   # screen tile width
    max_tris_per_tile: int = 256  # binning cap per tile (K)
    # Sort-based binning tiers (ops/binning.py): triangles covering at most
    # bin_expand tiles emit from the small tier (budget bin_max_small, -1 =
    # every record), then the medium and large compacted rect tiers, then up
    # to bin_max_big grid-wide triangles.  Every budget overflows LOUDLY.
    bin_expand: int = 4
    bin_expand_medium: int = 32
    bin_max_medium: int = 512
    bin_expand_large: int = 256
    bin_max_large: int = 64
    bin_max_big: int = 16
    bin_max_small: int = -1
    # Compacted record-stream capacity (binned (tile, tri) pairs); exceeding
    # it clamps tail tiles and raises the overflow count.
    bin_stream_cap: int = 65536
    stream_dma_db: bool = False  # TPU stream-segment double buffering
    # Live-light slots per tile for the fused kernel's in-kernel cull; more
    # live lights raise the overflow count.
    max_live_lights_per_tile: int = 48
    max_lights_per_tile: int = 64  # light-culling cap per tile (staged path)
    overflow_warn: bool = True
    use_pallas: bool = True
    # Fused tiled-deferred frame: raster + G-buffer + lighting + tonemap in
    # one kernel per screen tile, the G-buffer never leaves the chip.
    fused: bool = False
    setup_pallas: bool = False  # fused triangle-setup kernel (TPU knob)
    # In-kernel light culling: the fused kernel culls every point light
    # against each tile's exact world-space pixel bounds (two eye-distance
    # slabs) and compacts the live ids in ascending order.
    inkernel_light_cull: bool = False
    deferred_directional: bool = False
    split_resolve_pallas: bool = True

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)


# Reference-parity default (config 1 of BASELINE.json).
REFERENCE_CONFIG = RendererConfig()

# BASELINE.json config 3: 1080p, 256 point lights, PBR, the fused frame.  The
# capacity budgets are tuned to the benchmark scene's footprint distribution
# over the full yaw orbit; every one of them overflows LOUDLY.
FLAGSHIP_CONFIG = dataclasses.replace(
    REFERENCE_CONFIG,
    width=1920,
    height=1080,
    shading="pbr",
    max_tris_per_tile=512,
    max_lights_per_tile=256,
    max_live_lights_per_tile=128,
    bin_expand=2,
    bin_expand_medium=8,
    bin_max_medium=3072,
    bin_expand_large=64,
    bin_max_large=128,
    bin_max_big=8,
    bin_max_small=12288,
    bin_stream_cap=32768,
    shadow_tiles_cap=1160,
    shadow_tiles_cap_lit=1104,
    setup_pallas=True,
    inkernel_light_cull=True,
    stream_dma_db=True,
)
