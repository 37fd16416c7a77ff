"""The frame: advance the scene, render it.

The counterpart of d3d12_deferred_renderer_tpu/frame.py, with "on the TPU"
read as "on the card".  Two paths:

- the fused frame (cfg.fused with cfg.use_pallas, PBR, quantized G-buffer):
  triangle setup (kernel) -> binning -> [depth prepass (kernel) -> per-tile
  light cull, and without the deferred-directional split the shadow map +
  PCF] -> fused tile renderer (kernel) -> uint8; with the split the shadow
  map, PCF and the directional resolve (kernel) follow the tile renderer,
  then bloom, tonemap, gamma and FXAA (ops/fused.render_fused);
- the staged frame, every other ported config: triangle setup (kernel) ->
  raster -> [bump] -> G-buffer encode -> Lambert, or [shadow map + PCF] +
  the per-tile light cull + PBR lighting -> bloom, tonemap, gamma, FXAA ->
  uint8.  With cfg.use_pallas the raster is the tile raster kernel over the
  binned records (ops/raster_tiles), the bump the bump kernel on its
  planes, in place (ops/bump), the shadow map the depth-only setup and
  raster kernels (ops/shadows) and the PBR lighting the G-buffer lighting
  kernel on 8 x 128 tiles (ops/lighting_cuda); without it, the whole-frame
  reference rasterizer (ops/raster_ref), the block-form bump, and the
  32-pixel-tile plain lighting (lighting.shade_pbr_tiled), as the JAX
  package's CPU path and its golden images use.

A kernel's wrapper runs the kernel on CUDA tensors and its plain version on
CPU tensors.  step_frame, render and render_stats run the frame eagerly, one
launch after another on the current stream.  step_frame_jit (JAX's jitted
step_frame) captures animate + render_stats once a configuration as a CUDA
graph and replays it: one launch a frame from the host, no value read back
inside it; App.run and render_batch run through it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Tuple

import torch

from .config import RendererConfig
from .convert import FIELDS, field, state_from_fields
from .ops import post
from .ops.bump import apply_normal_mapping
from .ops.fused import render_fused
from .ops.gbuffer import GBuffer, encode_gbuffer
from .ops.lighting import (
    inverse_view_proj, reconstruct_world_positions, shade_lambert, shade_pbr_tiled,
)
from .ops.lighting_cuda import shade_pbr_tiled_kernel
from .ops.raster_ref import rasterize_packed
from .ops.raster_tiles import rasterize_binned
from .ops.shadows import render_shadow_map, shadow_visibility
from .ops.transform import setup_frame_triangles
from .scene import SceneState, animate
from .utils.debug import check_finite, layer_active
from .xmath import divf


def _fused_eligible(cfg: RendererConfig) -> bool:
    """The fused tile renderer covers the PBR frame with a quantized
    G-buffer; cfg.use_pallas off takes the staged path, as in JAX."""
    return cfg.fused and cfg.use_pallas and cfg.shading == "pbr" and cfg.quantize_gbuffer


def _rasterize(tris, cfg: RendererConfig, inv_vp=None):
    """(FragmentPlanes, overflow): the tile raster kernel over the binned
    records with cfg.use_pallas, and given the frame's inverse
    view-projection inv_vp with cfg.normal_mapping the bump kernel on its
    planes; else the whole-frame reference raster (render_stats bumps its
    fragments in the block form)."""
    if cfg.use_pallas:
        return rasterize_binned(tris.packed, tris.aabb, tris.valid, cfg, return_overflow=True, inv_vp=inv_vp)
    frags = rasterize_packed(tris.packed, cfg.height, cfg.width)
    return frags, torch.zeros((), dtype=torch.int32, device=tris.packed.device)


def render_stats(state: SceneState, cfg: RendererConfig):
    """One frame -> (uint8 [H, W, 3], {"overflow": int32 tensor}): the count
    of tiles that dropped triangles or lights at a capacity cap, plus
    binning-tier budget excess.  Zero on every supported config; a loud
    signal, never a silent drop, otherwise.  With cfg.supersample = s > 1
    the frame renders at s times the width and height through the same path
    and is box-averaged as JAX's float32 mean: each s x s block's sum (exact
    in float32) divided once by s^2, rounded half to even.  Under
    utils.debug.debug_layer the float stages are checked for NaN and Inf."""
    if cfg.supersample > 1:
        s = cfg.supersample
        hi_cfg = dataclasses.replace(cfg, width=cfg.width * s, height=cfg.height * s, supersample=1)
        hi, stats = render_stats(state, hi_cfg)
        sums = hi.to(torch.float32).reshape(cfg.height, s, cfg.width, s, 3).sum(dim=(1, 3))
        return torch.round(divf(sums, s * s)).to(torch.uint8), stats
    if _fused_eligible(cfg):
        frame, overflow = render_fused(state, cfg, return_overflow=True)
        return frame, {"overflow": overflow}

    tris, view_proj = setup_frame_triangles(state, cfg)
    inv_vp = inverse_view_proj(view_proj)
    frags, overflow = _rasterize(tris, cfg, inv_vp)
    if cfg.normal_mapping and not cfg.use_pallas:
        world = reconstruct_world_positions(frags.depth, view_proj, cfg, inv_vp)
        frags = apply_normal_mapping(frags, world, cfg, cfg.bump_strength, cfg.bump_frequency)
    gb = encode_gbuffer(frags, state.materials, cfg)
    check_finite("G-buffer", *gb)
    if cfg.shading == "lambert":
        color = shade_lambert(gb, state.lights, cfg)
        if cfg.fxaa:
            color = post.fxaa(color)
    else:
        vis = None
        if cfg.shadows:
            shadow_depth, light_vp, s_overflow = render_shadow_map(state, cfg, return_overflow=True)
            vis, v_overflow = shadow_visibility(gb.depth, view_proj, shadow_depth, light_vp, cfg,
                                                return_overflow=True, inv_vp=inv_vp)
            check_finite("shadow visibility", vis)
            overflow = overflow + s_overflow + v_overflow
        shade = shade_pbr_tiled_kernel if cfg.use_pallas else shade_pbr_tiled
        hdr, l_overflow = shade(gb, state.lights, cfg, view_proj, state.camera.eye,
                                shadow_visibility=vis, return_overflow=True, inv_vp=inv_vp)
        check_finite("HDR", hdr)
        overflow = overflow + l_overflow
        color = post.apply_post(hdr, cfg)
    check_finite("colour before to_uint8", color)
    return post.to_uint8(color), {"overflow": overflow}


OVERFLOW_WARNING = (
    "[renderer] WARNING: per-tile capacity overflow on {n} tiles — "
    "triangles or lights were dropped this frame; raise "
    "max_tris_per_tile / max_lights_per_tile / bin_max_big."
)

# Overflow counts of earlier frames on their way to the host: (event, pinned
# int32) pairs, read once the event has completed.  Module state, because
# render(state, cfg) has no object of its own that outlives a frame (the
# JAX package prints from inside the compiled program instead).
_pending_overflow = []


def _warn_overflow(overflow: torch.Tensor) -> None:
    """Print OVERFLOW_WARNING (the JAX package's text, once per offending
    frame) when a frame's overflow count is above 0, without ever waiting
    for the device.  A count on the CPU is read at once.  A count on the card
    is copied without blocking into pinned host memory behind an event, and
    read by a later call once its event has completed; a count whose event
    has not completed stays pending, so the last frame's warning is printed
    only by a later render call."""
    if overflow.device.type != "cuda":
        if int(overflow) > 0:
            print(OVERFLOW_WARNING.format(n=int(overflow)), flush=True)
        return
    while _pending_overflow and _pending_overflow[0][0].query():
        count = int(_pending_overflow.pop(0)[1])
        if count > 0:
            print(OVERFLOW_WARNING.format(n=count), flush=True)
    host = torch.empty(overflow.shape, dtype=overflow.dtype, pin_memory=True)
    host.copy_(overflow, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    _pending_overflow.append((done, host))


def render(state: SceneState, cfg: RendererConfig) -> torch.Tensor:
    """One frame -> display-ready uint8 [H, W, 3].  With cfg.overflow_warn
    it prints a warning for a frame whose capacity caps overflowed (see
    render_stats for the count itself): at once on the CPU, and for a frame
    on the card at a later render call, once the frame has finished
    (_warn_overflow)."""
    frame, stats = render_stats(state, cfg)
    if cfg.overflow_warn:
        _warn_overflow(stats["overflow"])
    return frame


def render_gbuffer(state: SceneState, cfg: RendererConfig) -> GBuffer:
    """The geometry pass only (for tests and tools): the G-buffer with its
    format quantization."""
    tris, _ = setup_frame_triangles(state, cfg)
    return encode_gbuffer(_rasterize(tris, cfg)[0], state.materials, cfg)


def step_frame(state: SceneState, cfg: RendererConfig) -> Tuple[SceneState, torch.Tensor]:
    """One iteration of the reference's loop (main.cpp:161-342): advance the
    animation clock, render."""
    state = animate(state, cfg.yaw_per_frame, cfg)
    return state, render(state, cfg)


# ---- step_frame_jit: the frame captured once as a CUDA graph ----

GRAPH_CACHE_SIZE = 8  # captured frames kept, least recently used dropped first


def _leaves(state: SceneState) -> list:
    """The state's tensors, in the order of convert.FIELDS."""
    return [field(state, path) for path in FIELDS]


def _rebuild(leaves) -> SceneState:
    """The SceneState holding `leaves`, in the order of convert.FIELDS."""
    return state_from_fields(dict(zip(FIELDS, leaves)).__getitem__)


def _frame_program(state: SceneState, cfg: RendererConfig):
    """What one captured frame computes: animate + render_stats (the
    overflow warning is queued on the host after each replay)."""
    state = animate(state, cfg.yaw_per_frame, cfg)
    frame, stats = render_stats(state, cfg)
    return state, frame, stats["overflow"]


class _CapturedFrame:
    """One configuration's frame (animate + render_stats) captured in a CUDA
    graph on static input and output buffers.

    load(state) copies the caller's leaves into the static inputs, skipping
    a leaf that is the very tensor, unchanged since (its _version), that was
    copied there last; replay() runs the graph; feed_back() makes the
    animated state the next replay's input (render_batch).  A leaf that the
    frame passes through unchanged comes back as the caller's own tensor, as
    step_frame returns it; every other output is cloned, so nothing
    returned aliases memory that a later replay writes."""

    def __init__(self, state: SceneState, cfg: RendererConfig):
        leaves = _leaves(state)
        self.cfg = cfg
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
        # (tensor, _version) each input was copied from; holding the tensor
        # keeps its memory from being reused by another one.
        self._src = [None] * len(leaves)
        self.load(state)
        static_state = _rebuild(self.inputs)
        dev = self.inputs[0].device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # Warm-up: builds the kernels and fills every lru_cache the
                # frame reads, so that the capture holds device work only.
                _frame_program(static_state, cfg)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            try:
                # thread_local: a host sync in this thread breaks the capture;
                # another thread's (a present queue's wait) does not.
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    out_state, self.frame, self.overflow = _frame_program(static_state, cfg)
            except RuntimeError as e:  # torch.AcceleratorError among them
                raise RuntimeError(
                    f"step_frame_jit: capturing the frame failed ({type(e).__name__}: {e}); a host read "
                    "or a host-to-device copy inside the frame cannot be captured") from e
        self.outputs = _leaves(out_state)
        self._passed = [o is i for o, i in zip(self.outputs, self.inputs)]

    def load(self, state: SceneState) -> None:
        for k, (leaf, buf) in enumerate(zip(_leaves(state), self.inputs)):
            src = self._src[k]
            if src is not None and src[0] is leaf and src[1] == leaf._version:
                continue
            buf.copy_(leaf)
            self._src[k] = (leaf, leaf._version)

    def replay(self) -> None:
        self.graph.replay()
        if self.cfg.overflow_warn:
            _warn_overflow(self.overflow)

    def feed_back(self) -> None:
        for k, passed in enumerate(self._passed):
            if not passed:
                self.inputs[k].copy_(self.outputs[k])
                self._src[k] = None

    def state_out(self, state: SceneState) -> SceneState:
        """The animated state of the last replay, for a load of `state`."""
        return _rebuild([c if passed else o.clone()
                         for c, o, passed in zip(_leaves(state), self.outputs, self._passed)])


_graphs: "collections.OrderedDict[tuple, _CapturedFrame]" = collections.OrderedDict()


def _captured(state: SceneState, cfg: RendererConfig) -> _CapturedFrame:
    """The captured frame for cfg and the state's device, shapes and dtypes,
    captured at the first call (refused before capture for a configuration
    that cannot be captured yet)."""
    leaves = _leaves(state)
    key = (cfg, leaves[0].device, tuple((tuple(t.shape), t.dtype) for t in leaves))
    if key in _graphs:
        _graphs.move_to_end(key)
        return _graphs[key]
    if not cfg.use_pallas:
        raise NotImplementedError(
            "step_frame_jit cannot capture this frame on the card yet: use_pallas=False runs the plain "
            "versions, whose per-slot loops read tile counts on the host (ROADMAP.md Queue 1 item 7)")
    graph = _CapturedFrame(state, cfg)
    _graphs[key] = graph
    while len(_graphs) > GRAPH_CACHE_SIZE:
        _graphs.popitem(last=False)
    return graph


def _eager(state: SceneState) -> bool:
    """Frames on the CPU, and under utils.debug.debug_layer, run op by op."""
    return state.time.device.type != "cuda" or layer_active()


def step_frame_jit(state: SceneState, cfg: RendererConfig) -> Tuple[SceneState, torch.Tensor]:
    """step_frame as one program, the counterpart of JAX's jitted step_frame
    (cfg static): on the card the first call for a configuration and a
    state's device, shapes and dtypes warms up once on a side stream and
    captures animate + render_stats in a CUDA graph; every call replays it
    after copying in the leaves of the state that are not already there.
    No value comes back to the host inside the frame; with
    cfg.overflow_warn the overflow count is copied out after the replay and
    printed as render prints it.  Value semantics: the state and frame
    returned alias nothing that a later call writes, the caller's state is
    never written, and any state gives exactly step_frame's result.

    On a CPU state it runs step_frame (the caller chose the CPU; JAX's jit
    runs there too), and under utils.debug.debug_layer it runs step_frame
    op by op, as jax_debug_nans re-runs a jitted function op by op.  There
    is no other fallback: a configuration that cannot be captured yet
    raises NotImplementedError before capture, and a capture that fails
    raises RuntimeError.  step_frame_jit.cache_clear() drops the captured
    frames (at most GRAPH_CACHE_SIZE are kept) and their memory pools."""
    if _eager(state):
        return step_frame(state, cfg)
    graph = _captured(state, cfg)
    graph.load(state)
    graph.replay()
    return graph.state_out(state), graph.frame.clone()


step_frame_jit.cache_clear = _graphs.clear


def render_batch(state: SceneState, cfg: RendererConfig, num_frames: int):
    """`num_frames` consecutive animated frames -> (final state, uint8
    [num_frames, H, W, 3]).  On the card: num_frames replays of
    step_frame_jit's graph, each frame copied into one preallocated batch
    and each animated state fed to the next replay on the device (JAX scans
    step_frame inside one jitted program).  On the CPU and under
    debug_layer: step_frame in a loop, the frames stacked.  With num_frames
    0 the state comes back as it was, with an empty [0, H, W, 3] batch, as
    JAX's scan of length 0 returns."""
    if num_frames == 0:
        return state, torch.empty((0, cfg.height, cfg.width, 3), dtype=torch.uint8, device=state.time.device)
    if _eager(state):
        frames = []
        for _ in range(num_frames):
            state, frame = step_frame(state, cfg)
            frames.append(frame)
        return state, torch.stack(frames)
    graph = _captured(state, cfg)
    out = torch.empty((num_frames, *graph.frame.shape), dtype=graph.frame.dtype, device=graph.frame.device)
    graph.load(state)
    for i in range(num_frames):
        if i:
            graph.feed_back()
        graph.replay()
        out[i].copy_(graph.frame)
    return graph.state_out(state), out
