"""PyTorch port: the application path's frame loop on the CPU.

* render_batch and cfg.supersample against the JAX package: one jitted
  JAX render_batch of supersampled config-1 frames (96x48, Lambert) on a
  scene carried across as numpy arrays, held to the golden-image contract
  of tests/test_torch_staged.py for jitted JAX frames (at most 1 LSB on
  fewer than 0.1% of pixels), and the final clock equal.
* The JAX package's contracts of tests/test_runtime.py (the present queue's
  depth and FIFO order, App, save_frames_to_dir, PassProfiler),
  tests/test_frame.py:85 (render_batch bit-equal to sequential step_frame
  calls), tests/test_scene_io.py:48 (supersampling smooths edges) and
  tests/test_native_sink.py (the native frame sink), on the port.
* The port's own: the supersampled frame is the box average of the frame
  rendered at s times the size, rounded half to even; the Chrome trace.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.runtime import (
    App, FrameStats, NativeFrameSink, PassProfiler, PresentQueue, chrome_trace, native_sink_available,
)
from d3d12_deferred_renderer_tpu_torch.runtime.app import save_frames_to_dir
from d3d12_deferred_renderer_tpu_torch.utils import read_png

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
CFG = tp.RendererConfig(width=96, height=48, use_pallas=False)


def _scene(cfg=CFG):
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, cfg, device="cpu")


def _pbr_scene(cfg):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, cfg, lights=tp.random_point_lights(24, cfg=cfg, radius=1.2, device="cpu"),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"), device="cpu",
    )


def test_render_batch_and_supersample_match_jax():
    jcfg = dxr.RendererConfig(width=96, height=48, use_pallas=False, supersample=2)
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"), prefer_native=False)
                                     for m in ("cube", "pyramid")])
    jstate = dxr.make_scene(jgeo, jcfg)
    jfinal, jframes = jax.jit(lambda s: dxr.render_batch(s, jcfg, 3))(jstate)
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    pfinal, pframes = tp.render_batch(pstate, tp.RendererConfig(**dataclasses.asdict(jcfg)), 3)
    jframes = np.asarray(jframes)
    assert pframes.shape == jframes.shape == (3, 48, 96, 3) and pframes.dtype == torch.uint8
    diff = np.abs(jframes.astype(int) - pframes.numpy().astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    assert float(pfinal.time) == float(jfinal.time)
    assert (jframes.max(-1) > 0).mean() > 0.01  # not blank


def test_render_batch_of_no_frames_matches_jax():
    """render_batch(state, cfg, 0): the state as it was and an empty uint8
    [0, H, W, 3] batch on the state's device, as JAX's scan of length 0
    returns."""
    jcfg = dxr.RendererConfig(width=96, height=48, use_pallas=False)
    jgeo = dxr.build_scene_geometry([dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)])
    jstate = dxr.make_scene(jgeo, jcfg)
    jfinal, jframes = dxr.render_batch(jstate, jcfg, 0)
    pstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    pfinal, pframes = tp.render_batch(pstate, tp.RendererConfig(**dataclasses.asdict(jcfg)), 0)
    assert tuple(pframes.shape) == np.asarray(jframes).shape == (0, 48, 96, 3)
    assert pframes.dtype == torch.uint8 and pframes.device == pstate.time.device
    assert pfinal is pstate and float(pfinal.time) == float(jfinal.time)


RENDER_CASES = {
    "reference_raster": CFG,
    "tile_raster": dataclasses.replace(CFG, use_pallas=True),
    "fused_pbr": dataclasses.replace(tp.FLAGSHIP_CONFIG, width=128, height=48, fused=True),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_batch_matches_sequential(case):
    """render_batch is bit-equal to N sequential step_frame calls and ends
    on their clock (test_frame.py:85)."""
    cfg = RENDER_CASES[case]
    state = _pbr_scene(cfg) if cfg.shading == "pbr" else _scene(cfg)
    final, frames = tp.render_batch(state, cfg, 3)
    assert frames.shape == (3, cfg.height, cfg.width, 3) and frames.dtype == torch.uint8
    s = state
    for i in range(3):
        s, f = tp.step_frame(s, cfg)
        assert torch.equal(frames[i], f), i
    assert float(final.time) == float(s.time)


@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_supersample_is_the_box_average(case, s):
    """cfg.supersample = s renders at s times the size through the same path
    and box-averages: each s x s block's integer sum over s^2, rounded half
    to even, with the high-resolution frame's overflow."""
    cfg = RENDER_CASES[case]
    state = tp.animate(_pbr_scene(cfg) if cfg.shading == "pbr" else _scene(cfg), 0.3, cfg)
    got, stats = tp.render_stats(state, dataclasses.replace(cfg, supersample=s))
    hi, hi_stats = tp.render_stats(state, dataclasses.replace(cfg, width=cfg.width * s, height=cfg.height * s))
    sums = hi.to(torch.int64).reshape(cfg.height, s, cfg.width, s, 3).sum(dim=(1, 3))
    q, r = sums // (s * s), sums % (s * s)
    up = (2 * r > s * s) | ((2 * r == s * s) & (q % 2 == 1))
    assert torch.equal(got, (q + up.to(torch.int64)).to(torch.uint8))
    assert int(stats["overflow"]) == int(hi_stats["overflow"]) == 0


def test_supersampling_smooths_edges():
    """test_scene_io.py:48: more distinct levels along silhouettes, and the
    interiors agree closely."""
    state = tp.animate(_scene())
    f1 = tp.render(state, CFG).numpy()
    f2 = tp.render(state, dataclasses.replace(CFG, supersample=2)).numpy()
    assert f1.shape == f2.shape == (48, 96, 3)
    assert len(np.unique(f2)) > len(np.unique(f1))
    interior = (f1.sum(-1) > 0) & (f2.sum(-1) > 0)
    assert np.abs(f1[interior].astype(int) - f2[interior].astype(int)).mean() < 12


def test_present_queue_depth_and_order():
    q = PresentQueue(depth=3)
    outs = []
    for i in range(5):
        out = q.push(torch.full((2, 2), i, dtype=torch.int32))
        if out is not None:
            outs.append(int(out[0, 0]))
    assert q.in_flight == 3
    assert outs == [0, 1]
    rest = [int(f[0, 0]) for f in q.drain()]
    assert rest == [2, 3, 4]
    assert q.frames_presented == 5
    assert q.in_flight == 0
    with pytest.raises(ValueError):
        PresentQueue(depth=0)


def test_present_queue_copies_cpu_frames():
    """A presented frame is the pushed frame's bytes at push time: a later
    write to the tensor does not reach it."""
    q = PresentQueue(depth=1)
    frame = torch.zeros((4, 4, 3), dtype=torch.uint8)
    q.push(frame)
    frame.fill_(9)
    out = q.present_next()
    assert isinstance(out, np.ndarray) and (out == 0).all()


def test_app_runs_and_presents_all_frames():
    presented = []
    app = App(_scene(), CFG, present_callback=lambda i, f: presented.append((i, f)))
    stats = app.run(5)
    assert stats.frames == 5 and stats.fps > 0
    assert len(presented) == 5
    assert presented[0][1].shape == (48, 96, 3)
    assert [i for i, _ in presented] == list(range(5))
    assert float(app.state.time) > 0.04
    # The presented frames are step_frame's, in order.
    s = _scene()
    for _, f in presented:
        s, ref = tp.step_frame(s, CFG)
        np.testing.assert_array_equal(f, ref.numpy())
    app.run(2)
    assert app.stats.frames == 7 and len(presented) == 7
    app.close()
    assert app.queue.in_flight == 0


def test_frame_stats_fps():
    assert FrameStats(frames=10, elapsed_s=2.0).fps == 5.0
    assert FrameStats().fps == 0.0


def test_save_frames_callback(tmp_path):
    cb = save_frames_to_dir(str(tmp_path))
    frame = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(4, 4, 3)
    cb(0, frame)
    np.testing.assert_array_equal(read_png(str(tmp_path / "frame_00000.png")), frame)


def test_profiler_accumulates():
    prof = PassProfiler()
    x = torch.ones((64, 64))
    with prof.time_pass("matmul", x):
        y = x @ x
    with prof.time_pass("matmul", y, inputs=(y,)):
        y = y @ y
    s = prof.summary()
    assert "matmul" in s and s["matmul"] >= 0.0 and prof.counts["matmul"] == 2
    prof.reset()
    assert prof.summary() == {}


def test_chrome_trace_writes_the_block(tmp_path):
    path = str(tmp_path / "trace.json")
    with chrome_trace(path):
        torch.ones((32, 32)) @ torch.ones((32, 32))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _needs_sink():
    if not native_sink_available():
        pytest.skip("native toolchain unavailable")


def test_sink_writes_exact_frames(tmp_path):
    _needs_sink()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (24, 32, 3), np.uint8) for _ in range(6)]
    with NativeFrameSink(str(tmp_path), 32, 24, 3, queue_depth=2, num_threads=3) as sink:
        for i, f in enumerate(frames):
            sink.push(f, i)
        sink.flush()
        assert sink.frames_written == 6
        assert sink.errors == 0
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(read_png(str(tmp_path / f"frame_{i:05d}.png")), f)


def test_sink_backpressure_bounded(tmp_path):
    """More frames than the queue depth: none dropped or reordered."""
    _needs_sink()
    with NativeFrameSink(str(tmp_path), 128, 64, 3, queue_depth=1, num_threads=1) as sink:
        for i in range(20):
            sink.push(np.full((64, 128, 3), i, np.uint8), i)
        sink.flush()
        assert sink.frames_written == 20
    for i in range(20):
        assert (read_png(str(tmp_path / f"frame_{i:05d}.png")) == i).all()


def test_sink_rejects_bad_config_and_guards_closed_handle(tmp_path):
    _needs_sink()
    with pytest.raises(ValueError):
        NativeFrameSink(str(tmp_path), 8, 8, channels=2)
    with pytest.raises(ValueError):
        NativeFrameSink(str(tmp_path), 0, 8, channels=3)
    sink = NativeFrameSink(str(tmp_path), 8, 8, channels=3)
    with pytest.raises(ValueError):
        sink.push(np.zeros((8, 4, 3), np.uint8), 0)
    sink.push(np.zeros((8, 8, 3), np.uint8), 0)
    sink.close()
    for use in (lambda: sink.push(np.zeros((8, 8, 3), np.uint8), 1), sink.flush,
                lambda: sink.frames_written):
        with pytest.raises(RuntimeError):
            use()
    sink.close()  # idempotent


def test_sink_with_app(tmp_path):
    _needs_sink()
    with NativeFrameSink(str(tmp_path), 96, 48, 3) as sink:
        app = App(_scene(), CFG, present_callback=sink.as_present_callback())
        app.run(4)
        sink.flush()
        assert sink.frames_written == 4
    s = _scene()
    for i in range(4):
        s, ref = tp.step_frame(s, CFG)
        np.testing.assert_array_equal(read_png(str(tmp_path / f"frame_{i:05d}.png")), ref.numpy())


def test_sink_is_built_outside_native():
    """The port builds its libraries into build/native/, never native/."""
    _needs_sink()
    from d3d12_deferred_renderer_tpu_torch.utils import native_build

    path = native_build.ensure_built("libframesink.so", "framesink.cpp")
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.commonpath([path, native_build.NATIVE_DIR]) != native_build.NATIVE_DIR
