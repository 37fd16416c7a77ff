"""Faults planted under a run for the tests: each breaks the timed path in
one way that `correct` must catch.  A spawned band rank applies the fault
named by the environment variable FAULT_ENV before it runs (the rank
processes inherit the test's environment)."""
from __future__ import annotations

import os
import sys
import types

import torch

FAULT_ENV = "H100_BENCH_TEST_FAULT"


def _altered(frame: torch.Tensor) -> torch.Tensor:
    """The frame with one pixel moved by 128 in every channel."""
    out = frame.clone()
    out[0, 0] ^= 0x80
    return out


def apply(fault: str, patch) -> None:
    """Plant `fault` with patch(obj, name, value) (pytest's monkeypatch.setattr
    or setattr)."""
    from d3d12_deferred_renderer_tpu_torch import frame as tf, scene
    from d3d12_deferred_renderer_tpu_torch.parallel import sharded

    if fault == "state_unchanged":
        def still(state, yaw_per_frame=0.01, cfg=None):
            return state
        patch(tf, "animate", still)
        patch(scene, "animate", still)
    elif fault == "answer_altered":
        render_stats, render_band = tf.render_stats, sharded._render_band

        def altered_stats(state, cfg):
            frame, stats = render_stats(state, cfg)
            return _altered(frame), stats

        def altered_band(state, cfg, y0, band_h, g):
            color, overflow = render_band(state, cfg, y0, band_h, g)
            return (_altered(color) if y0 == 0 else color), overflow
        patch(tf, "render_stats", altered_stats)
        patch(sharded, "_render_band", altered_band)
    elif fault == "half_batch":
        render_batch = tf.render_batch

        def half(state, cfg, n):
            state, frames = render_batch(state, cfg, n // 2)
            for _ in range(n - n // 2):  # the clock still advances n frames
                state = scene.animate(state, cfg.yaw_per_frame, cfg)
            return state, torch.cat([frames, frames[-1:].expand(n - n // 2, *frames.shape[1:])])
        patch(tf, "render_batch", half)
    elif fault == "exchange_left_out":
        # gather_stacked is the gather under both the eager body (gloo on the
        # CPU) and the card's rank program (program.Collective.run).
        def own_band_only(self, x):
            out = x.new_zeros((self.total, *x.shape))
            out[self.index] = x
            return out
        patch(sharded.BandGroup, "gather_stacked", own_band_only)
    else:
        raise ValueError(fault)


def band_rank(device, job):
    """drive.band_rank with the fault of FAULT_ENV planted in this rank;
    ``jax_loaded`` puts a module named jax into rank 1's sys.modules."""
    import torch.distributed as dist

    from h100_bench import drive

    fault = os.environ[FAULT_ENV]
    if fault == "jax_loaded":
        if dist.get_rank() == 1:
            sys.modules["jax"] = types.ModuleType("jax")
    else:
        apply(fault, setattr)
    return drive.band_rank(device, job)
