"""PyTorch port: the delta queue against JAX's DeltaPresentQueue, and unthreaded.

* Against JAX's DeltaPresentQueue (the one JAX reference of the delta
  tests): one numpy frame sequence through both queues, at depth 1 and 3,
  gives equal frames, and after every present equal bytes_transferred and
  transfer_misses, except on the pixel-miss presents whose dirty prefix is
  one tile: JAX re-transfers 2 tile rows there (`1 << max(take - 1,
  1).bit_length()`, delta.py:386), the port one (one bucket formula for
  both miss paths), so the port moves exactly one tile's bytes less.
* threaded=False decodes on the caller's thread: the same frames, bytes
  and misses as the worker's.

(Split from tests/test_torch_delta.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12_deferred_renderer_tpu.runtime import DeltaPresentQueue as JaxDeltaPresentQueue

from d3d12_deferred_renderer_tpu_torch.runtime import DeltaPresentQueue

TILE_BYTES = 8 * 64 * 3


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
