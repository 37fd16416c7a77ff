"""The frame: advance the scene, render it.

The counterpart of d3d12_deferred_renderer_tpu/frame.py for the fused frame:
triangle setup (kernel) -> binning -> fused tile renderer (kernel) -> uint8.
PyTorch runs it eagerly, one kernel launch after another on the current
stream, with no host synchronisation inside a frame.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .config import RendererConfig
from .ops.fused import render_fused
from .scene import SceneState, animate

# Configs outside the ported slice, with the ROADMAP.md Queue 1 item that
# ports them.
_NOT_PORTED = (
    (lambda c: c.shading != "pbr", "Lambert shading and the staged path (item 4)"),
    (lambda c: not c.fused, "the staged (non-fused) path (items 4 and 8)"),
    (lambda c: not c.quantize_gbuffer, "the unquantized staged G-buffer (item 4)"),
    (lambda c: c.shadows, "shadows (item 7)"),
    (lambda c: c.normal_mapping, "normal mapping (item 7)"),
    (lambda c: c.bloom, "bloom (item 7)"),
    (lambda c: c.fxaa, "FXAA (item 7)"),
    (lambda c: c.deferred_directional, "the deferred-directional split (item 7)"),
    (lambda c: not c.inkernel_light_cull, "the depth prepass + tile light cull (item 7)"),
    (lambda c: c.supersample > 1, "supersampling (item 9)"),
)


def check_ported(cfg: RendererConfig) -> None:
    """Raise NotImplementedError for a config the port cannot render yet."""
    for test, what in _NOT_PORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch package yet (ROADMAP.md Queue 1)"
            )


def render_stats(state: SceneState, cfg: RendererConfig):
    """One frame -> (uint8 [H, W, 3], {"overflow": int32 tensor}): the count
    of tiles that dropped triangles or lights at a capacity cap, plus
    binning-tier budget excess.  Zero on every supported config; a loud
    signal, never a silent drop, otherwise."""
    check_ported(cfg)
    frame, overflow = render_fused(state, cfg, return_overflow=True)
    return frame, {"overflow": overflow}


def render(state: SceneState, cfg: RendererConfig) -> torch.Tensor:
    """One frame -> display-ready uint8 [H, W, 3].  The overflow count stays
    on the device (render_stats returns it): a host-side warning would
    synchronise every frame (ROADMAP.md Queue 1 item 9)."""
    return render_stats(state, cfg)[0]


def step_frame(state: SceneState, cfg: RendererConfig) -> Tuple[SceneState, torch.Tensor]:
    """One iteration of the reference's loop (main.cpp:161-342): advance the
    animation clock, render."""
    state = animate(state, cfg.yaw_per_frame, cfg)
    return state, render(state, cfg)
