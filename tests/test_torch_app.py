"""PyTorch port: the application shell on the CPU.

The JAX package's contracts of tests/test_runtime.py (the present queue's
depth and FIFO order, App, save_frames_to_dir, PassProfiler) and
tests/test_native_sink.py (the native frame sink) on the port, and the
Chrome trace.  (Split from tests/test_torch_runtime.py.)
"""
import json
import os

import numpy as np
import pytest
import torch

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
