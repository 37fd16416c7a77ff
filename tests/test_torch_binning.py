"""PyTorch port: screen-tile binning against the JAX binning, exactly.

Both packages bin the same JAX setup records.  Counts, segment offsets, the
overflow count and every one of the 32 columns of the record stream must be
equal, on the sort path (FLAT_CELLS forced to 0 on both sides, as in
test_binning_sorted.py) and on the flat path, including cases where a tier
budget, the per-tile cap K or the stream capacity overflows.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import raster_pallas as jrp
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import binning

BASE = dxr.RendererConfig(width=256, height=128, tile_h=8, tile_w=128, max_tris_per_tile=512)

CASES = {
    "flagship_tiers": (dict(
        bin_expand=2, bin_expand_medium=8, bin_max_medium=3072, bin_expand_large=64,
        bin_max_large=128, bin_max_big=8, bin_max_small=12288, bin_stream_cap=32768), False),
    # The big and small tier budgets overflow.
    "tier_overflow": (dict(bin_expand=1, bin_expand_medium=2, bin_expand_large=3,
                           bin_max_big=1, bin_max_small=64), True),
    # The per-tile cap K and the stream capacity overflow.
    "cap_overflow": (dict(max_tris_per_tile=8, bin_stream_cap=96), True),
}


def _jax_sorted(packed, aabb, valid, cfg, stream_src):
    return jrp.bin_triangles(packed, aabb, valid, cfg, stream_src=stream_src)


def _jax_flat(packed, aabb, valid, cfg, stream_src):
    return jrp.bin_triangles(packed, aabb, valid, cfg, stream_src=stream_src)


# One compiled JAX binning per config and path (op-by-op dispatch of the sort
# path costs seconds of compilation per new shape).  FLAT_CELLS is read at
# trace time, so each path has its own jitted function and cache.
_JAX_BIN = {
    True: jax.jit(_jax_sorted, static_argnames=("cfg",)),
    False: jax.jit(_jax_flat, static_argnames=("cfg",)),
}


@pytest.fixture(scope="module")
def records():
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=10, segments=20))
    state = dxr.animate(dxr.make_scene(geo, BASE, placement="grid"))
    tris, _ = jax_setup(state, BASE)
    return tris


def _both(tris, cfg):
    jb = _JAX_BIN[binning.FLAT_CELLS == 0](
        tris.packed, tris.aabb, tris.valid, cfg=cfg, stream_src=tris.packed
    )
    tb = binning.bin_triangles(
        torch.from_numpy(np.array(tris.packed)), torch.from_numpy(np.array(tris.aabb)),
        torch.from_numpy(np.array(tris.valid)), tp.RendererConfig(**dataclasses.asdict(cfg)),
    )
    return jb, tb


def _assert_equal(jb, tb):
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts)[:, 0])
    np.testing.assert_array_equal(tb.offs.numpy(), np.asarray(jb.offs))
    assert int(tb.overflow) == int(jb.overflow)
    cap = tb.stream.shape[0]
    np.testing.assert_array_equal(tb.stream.numpy(), np.asarray(jb.stream)[:cap, :32])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_binning_matches_jax(records, monkeypatch, case):
    extra, overflows = CASES[case]
    monkeypatch.setattr(jrp, "FLAT_CELLS", 0)
    monkeypatch.setattr(binning, "FLAT_CELLS", 0)
    jb, tb = _both(records, dataclasses.replace(BASE, **extra))
    _assert_equal(jb, tb)
    assert (int(tb.overflow) > 0) == overflows


@pytest.mark.parametrize("case", ["flagship_tiers", "cap_overflow"])
def test_flat_binning_matches_jax(records, case):
    jb, tb = _both(records, dataclasses.replace(BASE, **CASES[case][0]))
    _assert_equal(jb, tb)


def test_flat_idx_matches_jax_oracle(records):
    """The dense per-tile id lists of the flat oracle, live prefix only."""
    jb = jrp.bin_triangles_flat(records.packed, records.aabb, records.valid, BASE)
    tb = binning.bin_triangles_flat(
        torch.from_numpy(np.array(records.aabb)), torch.from_numpy(np.array(records.valid)),
        tp.RendererConfig(**dataclasses.asdict(BASE)),
    )
    counts = tb.counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jb.counts)[:, 0])
    assert int(tb.overflow) == int(jb.overflow)
    ji, ti = np.asarray(jb.idx), tb.idx.numpy()
    for t, c in enumerate(counts):
        np.testing.assert_array_equal(ti[t, :c], ji[t, :c])
