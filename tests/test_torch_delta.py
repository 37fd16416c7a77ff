"""PyTorch port: dirty-tile delta presentation (runtime/delta.py) on the CPU.

* The JAX package's contracts of tests/test_delta_present.py on the port:
  reconstruction bit-identical to a full readback (raw and pixel mode, over
  an animated scene), static frames moving only the count, the steady-state
  bytes of both wire modes, both speculation misses, the dense-change
  fallback to raw, the queue's depth and FIFO order, the tile-size
  fallback, and App(delta_present=True).
* close() shuts the worker down and raises a failed present's error.

Against JAX's queue and unthreaded: tests/test_torch_delta_jax.py; the miss
bucket: tests/test_torch_delta_bucket.py.
"""
import os

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.runtime import App, DeltaPresentQueue

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
