"""The roofline counts and the device-trace reduction."""
import torch

from h100_bench import devtrace
from h100_bench.roofline import common, peaks


def _stream(records):
    """counts, offs, stream of one tile holding `records` (x0 y0 x1 y1 x2 y2, valid)."""
    stream = torch.zeros((len(records), 32))
    for i, (xy, valid) in enumerate(records):
        stream[i, 0:6] = torch.tensor(xy)
        stream[i, 28] = valid
    return torch.tensor([len(records)], dtype=torch.int32), torch.tensor([0, len(records)], dtype=torch.int32), stream


def test_box_pixels_counts_centres_in_box_and_tile():
    # Box x in [2.0, 10.0] -> centres 2.5 .. 9.5 (8), y in [1.0, 4.0] -> 1.5 .. 3.5 (3): 24 pixels.
    counts, offs, stream = _stream([([2.0, 1.0, 10.0, 1.0, 2.0, 4.0], 1.0)])
    assert common.raster_box_pixels(counts, offs, stream, ntx=1, tile_h=8, tile_w=128) == 24
    # Clipped by the tile: y in [1, 20] on an 8-row tile -> rows 1 .. 7 (7 rows).
    counts, offs, stream = _stream([([2.0, 1.0, 10.0, 1.0, 2.0, 20.0], 1.0)])
    assert common.raster_box_pixels(counts, offs, stream, ntx=1, tile_h=8, tile_w=128) == 8 * 7
    # An invalid record costs nothing.
    counts, offs, stream = _stream([([2.0, 1.0, 10.0, 1.0, 2.0, 4.0], 0.0)])
    assert common.raster_box_pixels(counts, offs, stream, ntx=1, tile_h=8, tile_w=128) == 0


def test_bound_takes_the_larger():
    assert common.bound_s(3.35e12, 0) == 1.0
    assert common.bound_s(0, 67e12) == 1.0
    assert common.bound_s(3.35e9, 67e12) == 1.0
    assert peaks.HBM_BYTES_PER_S == 3.35e12 and peaks.FP32_OPS_PER_S == 67e12


def test_union_of_overlapping_kernels_never_exceeds_the_window():
    ivs = [(0.0, 4.0), (1.0, 3.0), (2.0, 6.0), (8.0, 9.0), (8.5, 9.5)]
    assert devtrace.union_length(ivs) == 7.5
    assert sum(e - s for s, e in ivs) > 10  # the old sum of durations
    assert devtrace.idle_gaps(ivs, 0.0, 10.0) == [(6.0, 8.0), (9.5, 10.0)]


def test_reduce_events_busy_share():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 50.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 20.0, "dur": 50.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 95.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 70.0, "dur": 25.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.window", "ts": 0.0, "dur": 100.0}]
    out = devtrace.reduce_events(ev)
    assert abs(out["busy_s"] - 65e-6) < 1e-12 and abs(out["window_s"] - 100e-6) < 1e-12
    assert out["busy_s"] <= out["window_s"]
    assert abs(out["ops"]["k"] - 100e-6) < 1e-12
    gaps = dict(out["idle_gaps"])
    assert abs(gaps["cudaEventSynchronize"] - 25e-6) < 1e-12
    assert abs(gaps[devtrace.SHORT_GAPS] - 10e-6) < 1e-12
