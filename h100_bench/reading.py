"""What a run hands to the metric readers (metrics/<name>.py).

``Reading`` holds the cell, its configuration and mix, the scene arrays,
the setup time and what the traffic entry returned (drive.py).
``FrameInputs`` rebuilds one frame of the run at its animation step for
the roofline counts (roofline/<kernel>.py): the program's own binned
records (its triangle setup and binning, the kernels' real inputs) and the
reference's fragments of the same frame.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import drive, scenegen


@dataclasses.dataclass
class Reading:
    cell: dict
    config: dict
    traffic: dict
    arrays: dict
    run: dict
    setup_s: float
    device: str

    @property
    def yaw(self) -> float:
        return self.config["renderer"]["yaw_per_frame"]

    def clocks(self, steps) -> list:
        """The animation clock after each of `steps` (animation steps from
        the scene's starting phase)."""
        steps = list(steps)
        if not steps:
            return []
        table = scenegen.advance_clock(self.arrays["time"], self.yaw, max(steps))
        return [float(table[s - 1]) for s in steps]

    def profiled_frames(self, k: int = 4) -> list:
        """FrameInputs of k frames spread over the profiled window."""
        prof = self.run["profile"]
        first, n = prof["first_step"], prof["frames"]
        steps = sorted({first + 1 + (n - 1) * i // max(1, k - 1) for i in range(k)})
        return [FrameInputs(self, c) for c in self.clocks(steps)]


class FrameInputs:
    """One frame of a run at animation clock `clock`."""

    def __init__(self, reading: Reading, clock: float):
        self.reading = reading
        self.clock = clock
        self.cfg = drive.port_config(reading.config["renderer"])
        self.dev = torch.device(reading.device)
        from .reference import render

        self.scene = render.device_scene(reading.arrays, self.dev)

    def port_state(self):
        from d3d12_deferred_renderer_tpu_torch import convert

        arrays = dict(self.reading.arrays, time=np.float32(self.clock))
        orientation = arrays["orientation"].copy()
        orientation[:, 1] = np.float32(self.clock)
        arrays["orientation"] = orientation
        return convert.scene_from_arrays(arrays, self.dev)

    @functools.cached_property
    def _state(self):
        return self.port_state()

    def binned(self):
        """The program's binned records of the frame (K2's inputs)."""
        from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
        from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

        tris, _ = setup_frame_triangles(self._state, self.cfg)
        return bin_triangles(tris.packed, tris.aabb, tris.valid, self.cfg)

    def shadow_binned(self):
        """(the program's binned shadow-map records, their binning config)."""
        from d3d12_deferred_renderer_tpu_torch.ops import shadows
        from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles

        st = self._state
        scfg = shadows.shadow_bin_config(self.cfg, st.geometry.tri_mesh_id.shape[0])
        lvp = shadows.light_view_proj(st.lights.direction)
        tris = shadows.setup_light_view_triangles(st, scfg, lvp)
        return bin_triangles(tris.packed, tris.aabb, tris.valid, scfg), scfg

    def reference(self):
        """(the reference's fragments of the frame, their world positions)."""
        from .reference import raster, render, setup, shade

        cfg = render.renderer_config(self.reading.config["renderer"])
        s = self.scene
        orientation = s["orientation"].clone()
        orientation[:, 1] = self.clock
        model, view_proj, mvp = setup.frame_matrices(s["position"], orientation, s["scale"], s["camera.eye"],
                                                     s["camera.at"], s["camera.up"], cfg)
        tris = setup.setup_triangles_reference(s["geometry.fv_pos_cols"], s["geometry.fv_nrm_cols"],
                                               s["geometry.fv_uv_cols"], s["geometry.tri_mesh_id"], mvp, model,
                                               cfg.width, cfg.height)
        frags = raster.rasterize(tris.packed, cfg.height, cfg.width)
        return frags, shade.world_positions(frags.depth, torch.linalg.inv_ex(view_proj)[0])
