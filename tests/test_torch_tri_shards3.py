"""PyTorch port: the 3-rank triangle split, and the mesh paths' refusals and
helpers, on the CPU.

One spawn of 3 ranks in a gloo group on the CPU (parallel.run_bands with
device="cpu"): three triangle shards of a stream that is no multiple of 3,
the last slice padded, through the plain chain and through the tile
raster's plain version.  The contracts of tests/test_tri_sharded.py and
tests/test_dryrun.py:

* the padded split equal to the port's single-device frame;
* the overflow summed over the shards, > 0 with one triangle a tile and
  equal to the sum of each slice's binning overflow, 0 with 256;
* the refusals (an indivisible band, a mesh that does not fill the world,
  dryrun_multichip without a card);
* animation_times and _with_time bit-equal to JAX's; band_branch as JAX's.

The 4-rank spawn is in tests/test_torch_tri_sharded.py.
"""
import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.parallel import sharded as jax_sharded

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles
from d3d12_deferred_renderer_tpu_torch.parallel import animation_times, dryrun, mesh, run_bands, sharded
from d3d12_deferred_renderer_tpu_torch.parallel.launch import mesh_frames

TIMEOUT_S = 240.0
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")


# The 3-rank spawn: three shards of a stream that is no multiple of 3
# (the last slice padded), and the overflow signal through the tile
# raster's plain version.
OVERFLOW = dict(width=128, height=48, tile_h=8, tile_w=128, use_pallas=True)
CASES3 = {
    "lambert_tri3": (dxr.RendererConfig(width=128, height=48, use_pallas=False), "bench", (3,), ("tri",), "tri", {}),
    "overflow_cap1": (dxr.RendererConfig(**OVERFLOW, max_tris_per_tile=1), "bench", (3,), ("tri",), "tri", {}),
    "overflow_cap256": (dxr.RendererConfig(**OVERFLOW, max_tris_per_tile=256), "bench", (3,), ("tri",), "tri", {}),
}


def _scene(kind, cfg):
    """JAX scene states: "bench" the small benchmark scene of
    test_torch_parallel.py (5 meshes on the grid, 590 triangles: 1180
    records, no multiple of 3), "bench_lit" with 8 point lights, "tie" two
    coincident cubes (scaled to cover the frame) with varied materials."""
    if kind == "tie":
        cube = dxr.load_obj(os.path.join(ASSETS, "cube.obj"), prefer_native=False)
        geo = dxr.build_scene_geometry([cube, cube])
        state = dxr.animate(dxr.make_scene(geo, cfg, materials=dxr.Materials.varied(2)))
        return dataclasses.replace(
            state, position=jnp.zeros_like(state.position), scale=jnp.full_like(state.scale, 3.0),
            orientation=jnp.broadcast_to(state.orientation[:1], state.orientation.shape))
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    lights = dxr.random_point_lights(8, cfg=cfg) if kind == "bench_lit" else None
    state = dxr.make_scene(geo, cfg, placement="grid", materials=dxr.Materials.varied(geo.num_meshes), lights=lights)
    return dxr.animate(state, 0.5, cfg)


def _tcfg(cfg):
    return tp.RendererConfig(**dataclasses.asdict(cfg))


def _port_state(state):
    return tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu")


def _items(cases, states):
    return [(tp.arrays_from_state(states[k]), _tcfg(cfg), sizes, names, entry, kw)
            for k, (cfg, _, sizes, names, entry, kw) in cases.items()]


@pytest.fixture(scope="module")
def runs():
    """The 3-rank spawn -> {case: [each rank's (frames, overflow)]} and the
    JAX states."""
    states = {k: _scene(c[1], c[0]) for k, c in CASES3.items()}
    r3 = run_bands(3, mesh_frames, (_items(CASES3, states),), device="cpu", timeout_s=TIMEOUT_S)
    return dict(frames={k: [r[i] for r in r3] for i, k in enumerate(CASES3)}, states=states)


def _single(state, cfg, t=None):
    st = _port_state(state)
    if t is not None:
        st = sharded._with_time(st, t)
    frame, stats = tp.render_stats(st, dataclasses.replace(_tcfg(cfg), fused=False))
    return frame.numpy(), int(stats["overflow"])


def _frame(runs, case):
    """Rank 0's frames and overflow, after checking every rank holds them."""
    ranks = runs["frames"][case]
    f, o = ranks[0]
    assert all(np.array_equal(g, f) and p == o for g, p in ranks)
    return f, o


def test_three_shards_pad_the_last_slice(runs):
    cfg = CASES3["lambert_tri3"][0]
    state = runs["states"]["lambert_tri3"]
    tris, _ = setup_frame_triangles(_port_state(state), _tcfg(cfg))
    assert tris.packed.shape[0] % 3, "the stream divides into 3: no padding record"
    frame, ovf = _frame(runs, "lambert_tri3")
    np.testing.assert_array_equal(frame, _single(state, cfg)[0])
    assert ovf == 0


def test_overflow_is_summed_over_the_shards(runs):
    """One triangle a tile overflows on the slices; the summed count is
    each slice's binning overflow added up (the shading of Lambert adds
    none); the default 256 a tile overflows nowhere."""
    cfg = CASES3["overflow_cap1"][0]
    _, ovf = _frame(runs, "overflow_cap1")
    tris, _ = setup_frame_triangles(_port_state(runs["states"]["overflow_cap1"]), _tcfg(cfg))
    T = tris.packed.shape[0]
    per = -(-T // 3)
    expect = 0
    for i in range(3):
        sl = slice(i * per, min((i + 1) * per, T))
        pad = per - (sl.stop - sl.start)
        packed = torch.cat([tris.packed[sl], tris.packed.new_zeros((pad, 32))])
        aabb = torch.cat([tris.aabb[sl], tris.aabb.new_zeros((pad, 4))])
        valid = torch.cat([tris.valid[sl], tris.valid.new_zeros((pad,))])
        expect += int(bin_triangles(packed, aabb, valid, _tcfg(cfg)).overflow)
    assert ovf == expect > 0
    assert _frame(runs, "overflow_cap256")[1] == 0


def test_make_mesh_refuses_a_shape_that_misses_the_world(monkeypatch):
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 4)
    with pytest.raises(ValueError, match="world size"):
        tp.parallel.make_mesh((2, 3), ("frame", "rows"))
    with pytest.raises(ValueError, match="axis names"):
        tp.parallel.make_mesh((2, 2), ("frame", "tri", "rows"))


def _fake_mesh(sizes, names, rank=0):
    return mesh.Mesh(tuple(names), tuple(sizes), mesh.mesh_coords(rank, sizes), (None,) * len(sizes), True)


@pytest.mark.parametrize("height,sizes,match", [
    (30, (4,), "not divisible by 4 triangle shards"),
    (30, (4, 2), "height 30 not divisible by 4 bands"),
], ids=["tri", "rows"])
def test_indivisible_band_is_refused(height, sizes, match):
    cfg = tp.RendererConfig(width=128, height=height, use_pallas=False)
    names = ("tri",) if len(sizes) == 1 else ("rows", "tri")
    with pytest.raises(ValueError, match=match):
        sharded.render_tri_sharded(None, cfg, _fake_mesh(sizes, names), rows_axis="rows" if len(sizes) > 1 else None)
    # The sub-band's cross-pixel filters are held as a band's are.
    with pytest.raises(ValueError, match="tile_h"):
        sharded.render_tri_sharded(None, tp.RendererConfig(width=128, height=32, normal_mapping=True, shading="pbr"),
                                   _fake_mesh((8,), ("tri",)))
    with pytest.raises(ValueError, match="batch"):
        sharded.render_frames_batch_sharded(None, torch.zeros(3), tp.RendererConfig(width=128, height=32),
                                            _fake_mesh((2, 2), ("frame", "rows")))


def test_animation_times_match_jax_past_two_pi():
    """The floored modulo of the exact fmod (scene._mod) equals jnp.mod, and
    torch.remainder, bit for bit, also for clocks that wrap past 2 pi."""
    for start, n, yaw in ((0.0, 4, 0.01), (6.25, 300, 0.01), (12.0, 64, 0.37)):
        got = animation_times(start, n, yaw, device="cpu").numpy()
        ref = np.asarray(jax_sharded.animation_times(start, n, yaw))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
        t = start + yaw * (1 + torch.arange(n, dtype=torch.float32))
        rem = torch.remainder(t, tp.xmath.XM_2PI).numpy()
        np.testing.assert_array_equal(rem.view(np.int32), np.asarray(jnp.mod(jnp.asarray(t.numpy()), tp.xmath.XM_2PI))
                                      .view(np.int32))
    assert (animation_times(6.25, 300, device="cpu") < 0.5).any()  # the clock wrapped


def test_with_time_sets_clock_and_yaw():
    cfg = dxr.RendererConfig(width=64, height=32)
    jstate = _scene("bench", cfg)
    got = sharded._with_time(_port_state(jstate), torch.tensor(1.25))
    ref = jax_sharded._with_time(jstate, jnp.float32(1.25))
    assert float(got.time) == float(ref.time) == 1.25
    np.testing.assert_array_equal(got.orientation.numpy(), np.asarray(ref.orientation))


def test_dryrun_multichip_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda *a: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)
    assert spawned == []


def test_band_branch_follows_jax():
    fused = tp.RendererConfig(width=128, height=40, use_pallas=True, fused=True, shading="pbr")
    assert [sharded.band_branch(c, b) for c, b in itertools.product(
        (fused, dataclasses.replace(fused, fused=False)), (16, 20))] == ["fused", "staged", "staged", "staged"]
