"""PyTorch port: dirty-tile delta presentation (runtime/delta.py) on the CPU.

* The JAX package's contracts of tests/test_delta_present.py on the port:
  reconstruction bit-identical to a full readback (raw and pixel mode, over
  an animated scene), static frames moving only the count, the steady-state
  bytes of both wire modes, both speculation misses, the dense-change
  fallback to raw, the queue's depth and FIFO order, the tile-size
  fallback, and App(delta_present=True).
* Against JAX's DeltaPresentQueue (the one JAX reference of this file): one
  numpy frame sequence through both queues, at depth 1 and 3, gives equal
  frames, and after every present equal bytes_transferred and
  transfer_misses, except on the pixel-miss presents whose dirty prefix is
  one tile: JAX re-transfers 2 tile rows there (`1 << max(take - 1,
  1).bit_length()`, delta.py:386), the port one (one bucket formula for
  both miss paths), so the port moves exactly one tile's bytes less.
* close() shuts the worker down and raises a failed present's error.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12_deferred_renderer_tpu.runtime import DeltaPresentQueue as JaxDeltaPresentQueue

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.runtime import App, DeltaPresentQueue
from d3d12_deferred_renderer_tpu_torch.runtime.delta import _pow2_at_least

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
CFG = tp.RendererConfig(width=96, height=48, use_pallas=False)
TILE_BYTES = 8 * 64 * 3


def _scene():
    geo = tp.build_scene_geometry([tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in ("cube", "pyramid")])
    return tp.make_scene(geo, CFG, device="cpu")


def _present(q, frame):
    out = q.push(frame)
    return out if out is not None else q.present_next()


@pytest.mark.parametrize("pixel_level", [False, True], ids=["raw", "pixel"])
def test_delta_reconstruction_bit_identical_over_animation(pixel_level):
    state = _scene()
    q = DeltaPresentQueue(CFG.height, CFG.width, depth=2, pixel_level=pixel_level)
    direct, via = [], []
    for _ in range(8):
        state, frame = tp.step_frame(state, CFG)
        direct.append(frame.numpy())
        out = q.push(frame)
        if out is not None:
            via.append(out)
    via.extend(q.drain())
    assert len(via) == 8
    for d, v in zip(direct, via):
        np.testing.assert_array_equal(d, v)
    assert q.bytes_transferred < q.bytes_full
    q.close()


def test_delta_static_frames_transfer_nothing():
    frame = torch.arange(64 * 3, dtype=torch.uint8).reshape(1, 64, 3).repeat(16, 1, 1)
    q = DeltaPresentQueue(16, 64, depth=1)
    for _ in range(2):
        np.testing.assert_array_equal(_present(q, frame), frame.numpy())
    moved = q.bytes_transferred
    np.testing.assert_array_equal(_present(q, frame), frame.numpy())
    assert q.bytes_transferred - moved == 4
    assert q.transfer_misses == 0
    assert q.bytes_full == 3 * 16 * 64 * 3


def test_delta_partial_change_moves_fraction():
    base = torch.zeros((32, 128, 3), dtype=torch.uint8)
    q = DeltaPresentQueue(32, 128, depth=1, pixel_level=False)
    _present(q, base)
    for i in range(10):
        touched = base.clone()
        touched[0, 0, 0] = 100 + i
        before = q.bytes_transferred
        np.testing.assert_array_equal(_present(q, touched), touched.numpy())
    assert q.bytes_transferred - before == 4 + 2 * 4 + 2 * TILE_BYTES
    assert q.bytes_transferred < q.bytes_full / 3


def test_delta_pixel_mode_steady_state_bytes():
    base = torch.zeros((32, 128, 3), dtype=torch.uint8)
    q = DeltaPresentQueue(32, 128, depth=1)
    assert q.pixel_level
    _present(q, base)
    for i in range(q._SHRINK_RUN + 8):
        touched = base.clone()
        touched[0, 0, 0] = 100 + i
        before = q.bytes_transferred
        np.testing.assert_array_equal(_present(q, touched), touched.numpy())
    steady = q.bytes_transferred - before
    assert steady == 8 + 2 * 4 + 2 * (8 * 64 // 8) + (2 * 512 // 4) * 3
    assert steady < TILE_BYTES


def test_delta_speculation_misses_still_bit_identical():
    """A full-frame change after a settle (tile miss), then one tile's every
    pixel after calibrating on one pixel a frame (pixel miss): an extra
    transfer each, never a wrong pixel."""
    base = torch.zeros((32, 128, 3), dtype=torch.uint8)
    q = DeltaPresentQueue(32, 128, depth=1)
    for _ in range(2):
        _present(q, base)
    big = torch.full((32, 128, 3), 77, dtype=torch.uint8)
    np.testing.assert_array_equal(_present(q, big), big.numpy())
    assert q.transfer_misses == 1
    cur = big
    for i in range(q._SHRINK_RUN + 4):
        cur = big.clone()
        cur[0, 0, 0] = 10 + i
        np.testing.assert_array_equal(_present(q, cur), cur.numpy())
    misses = q.transfer_misses
    dense = cur.clone()
    dense[:8, :64, :] = 200
    np.testing.assert_array_equal(_present(q, dense), dense.numpy())
    assert q.transfer_misses == misses + 1


def test_delta_dense_change_scene_falls_back_to_raw():
    cur = torch.zeros((32, 128, 3), dtype=torch.uint8)
    q = DeltaPresentQueue(32, 128, depth=1)
    _present(q, cur)
    for i in range(6):
        cur = cur.clone()
        cur[:8, :64, :] = 50 + i
        np.testing.assert_array_equal(_present(q, cur), cur.numpy())
    assert q.transfer_misses <= 2
    assert q._spec_px > max(1, q._spec * q.tile_px // 4)


def test_delta_queue_depth_and_fifo():
    q = DeltaPresentQueue(8, 8, depth=3, tile_h=8, tile_w=8)
    outs = []
    for i in range(5):
        out = q.push(torch.full((8, 8, 3), i, dtype=torch.uint8))
        if out is not None:
            outs.append(int(out[0, 0, 0]))
    assert q.in_flight == 3
    assert outs == [0, 1]
    assert [int(f[0, 0, 0]) for f in q.drain()] == [2, 3, 4]
    assert q.frames_presented == 5 and q.in_flight == 0
    with pytest.raises(ValueError):
        DeltaPresentQueue(8, 8, depth=0)


def test_delta_tile_fallback_divisors():
    q = DeltaPresentQueue(30, 50, depth=1, tile_h=8, tile_w=64)
    assert 30 % q.th == 0 and 50 % q.tw == 0
    np.testing.assert_array_equal(_present(q, torch.ones((30, 50, 3), dtype=torch.uint8)), 1)


def test_app_delta_present_matches_plain():
    plain, delta = [], []
    App(_scene(), CFG, present_callback=lambda i, f: plain.append(f)).run(4)
    with App(_scene(), CFG, present_callback=lambda i, f: delta.append(f), delta_present=True) as app:
        app.run(4)
        q = app.queue
        assert isinstance(q, DeltaPresentQueue)
        assert q.transfer_misses <= 1
        assert q.bytes_transferred <= q.bytes_full + 4 * (8 + q.NT * 4) + q.transfer_misses * q.NT * q.tile_bytes
    assert len(plain) == len(delta) == 4
    for p, d in zip(plain, delta):
        np.testing.assert_array_equal(p, d)


def test_close_shuts_the_worker_down():
    q = DeltaPresentQueue(8, 8, depth=3, tile_h=8, tile_w=8)
    for i in range(3):
        q.push(torch.full((8, 8, 3), i, dtype=torch.uint8))
    q.close()
    assert q.in_flight == 0
    with pytest.raises(RuntimeError):
        q.push(torch.zeros((8, 8, 3), dtype=torch.uint8))
    q.close()  # idempotent


def test_close_raises_a_failed_present():
    q = DeltaPresentQueue(8, 8, depth=3, tile_h=8, tile_w=8)

    def fail(job):
        raise RuntimeError("decode failed")

    q._present_job = fail
    q.push(torch.zeros((8, 8, 3), dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="decode failed"):
        q.close()
    assert q.in_flight == 0


@pytest.mark.parametrize("n", range(1, 10))
def test_miss_bucket(n):
    k = _pow2_at_least(n)
    assert k >= n and k & (k - 1) == 0 and k < 2 * n


def _frame_sequence():
    """Frames of 32x128 that walk both wire modes and every miss: full
    first frame, one pixel a frame (pixel mode settles), one whole tile
    (a pixel miss on a one-tile prefix), two changing pixels in two tiles,
    two whole tiles (a pixel miss on a two-tile prefix), a random frame
    (a tile miss), one dense tile a frame (raw), then static frames."""
    rng = np.random.default_rng(0)
    cur = np.zeros((32, 128, 3), np.uint8)
    frames = [cur.copy()]

    def step(edit):
        nonlocal cur
        cur = cur.copy()
        edit(cur)
        frames.append(cur)

    for i in range(20):
        step(lambda f, i=i: f.__setitem__((0, 0, 0), 10 + i))
    step(lambda f: f.__setitem__((slice(0, 8), slice(0, 64)), 200))
    for i in range(20):
        step(lambda f, i=i: (f.__setitem__((0, 0, 0), 50 + i), f.__setitem__((8, 64, 1), i)))
    step(lambda f: (f.__setitem__((slice(0, 8), slice(0, 64)), 99), f.__setitem__((slice(8, 16), slice(64, None)), 7)))
    step(lambda f: f.__setitem__(Ellipsis, rng.integers(0, 256, f.shape, dtype=np.uint8)))
    for i in range(6):
        step(lambda f, i=i: f.__setitem__((slice(0, 8), slice(0, 64)), 50 + i))
    step(lambda f: None)
    step(lambda f: None)
    return frames


@pytest.mark.parametrize("depth", [1, 3])
def test_unthreaded_queue_equals_threaded(depth):
    """threaded=False decodes on the caller's thread at present (JAX's
    unthreaded queue): the same frames, bytes and misses as the worker's,
    over a sequence that walks both wire modes and every miss."""
    frames = _frame_sequence()
    tq, uq = DeltaPresentQueue(32, 128, depth=depth), DeltaPresentQueue(32, 128, depth=depth, threaded=False)
    assert uq._pool is None
    outs = []
    for f in frames:
        a, b = tq.push(torch.from_numpy(f)), uq.push(torch.from_numpy(f))
        assert (a is None) == (b is None)
        if a is not None:
            outs.append((a, b))
    outs.extend(zip(tq.drain(), uq.drain()))
    assert len(outs) == len(frames)
    for f, (a, b) in zip(frames, outs):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, f)
    assert (uq.bytes_transferred, uq.transfer_misses, uq.bytes_full) == (
        tq.bytes_transferred, tq.transfer_misses, tq.bytes_full)
    tq.close()
    uq.close()
    with pytest.raises(RuntimeError):
        uq.push(torch.from_numpy(frames[0]))


@pytest.mark.parametrize("depth", [1, 3])
def test_delta_matches_jax(depth):
    frames = _frame_sequence()
    jq, q = JaxDeltaPresentQueue(32, 128, depth=depth), DeltaPresentQueue(32, 128, depth=depth)
    outs, counters = [], []

    def record(a, b):
        np.testing.assert_array_equal(b, a)
        outs.append(b)
        counters.append((jq.bytes_transferred, q.bytes_transferred, jq.transfer_misses, q.transfer_misses))

    for f in frames:
        a, b = jq.push(jnp.asarray(f)), q.push(torch.from_numpy(f))
        assert (a is None) == (b is None)
        if a is not None:
            record(a, b)
    for a, b in zip(jq.drain(), q.drain()):
        record(a, b)
    q.close()
    assert len(outs) == len(frames)
    for f, out in zip(frames, outs):
        np.testing.assert_array_equal(out, f)
    prev, repaired = (0, 0), 0
    for jb, pb, jm, pm in counters:
        assert pm == jm
        dj, dp = jb - prev[0], pb - prev[1]
        prev = (jb, pb)
        if dj != dp:
            assert dj - dp == TILE_BYTES  # JAX's 2-row re-transfer of a 1-tile prefix
            repaired += 1
    assert 1 <= repaired < counters[-1][2]  # some, not all, misses are one-tile pixel misses
    assert counters[-1][3] >= 3
