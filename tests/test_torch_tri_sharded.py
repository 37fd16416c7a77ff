"""PyTorch port: the rank mesh (make_mesh, BandAxes), the triangle-sharded
path (render_tri_sharded, sort-last compositing), the batch-sharded entry
points and the multi-device dry run, on the CPU.

The port's ranks run as spawned processes in gloo groups on the CPU, two
spawns in all (parallel.run_bands with device="cpu"; parallel.launch.
run_calls runs every job of a spawn in one group): 4 ranks for the meshes
of two axes and more, and the dry run; 3 ranks for a triangle split that
pads its last slice.  One JAX reference: JAX's render_tri_sharded, jitted on
4 virtual CPU devices of tests/conftest.py, given the records of its setup
run op by op.  The contracts of tests/test_tri_sharded.py,
tests/test_band_axes.py and tests/test_dryrun.py:

* Lambert (+ FXAA) on a (rows 2, tri 2) mesh: bit for bit equal to JAX's
  frame (from row 1: JAX's band 0 takes the frame's last row as the row
  above it, ROADMAP.md Queue 3) and to the port's single-device frame;
* PBR: within 1 u8 on fewer than 0.2% of pixels of the single-device frame
  (sub-band light culls);
* the first-wins tie across slices (two coincident cubes over 4 shards),
  with the composited fragment planes bit-equal (int32 views: the depth's
  sign of zero too) to the single-device raster's;
* the same frame for the declarations ("rows", "tri"), ("tri", "rows")
  and ("frame", "tri", "rows"); bloom + FXAA + bump through the plain
  chain and through the kernels' plain versions (the bump on the
  composited sub-band); shadows + bloom + FXAA on ("tri", "rows");
* the overflow summed over the shards, > 0 with one triangle a tile and
  equal to the sum of each slice's binning overflow, 0 with 256;
* the refusals (an indivisible band, a mesh that does not fill the world);
* frames x rows and frames x tri x rows batches against the single-device
  frame at each clock; animation_times bit-equal to JAX's;
* the dry run's three steps (dryrun_multichip's job) in 4 ranks;
* BandAxes's band index and gather order, pure functions of the mesh
  coordinates, for both declaration orders (ranks simulated by threads).
"""
import dataclasses
import itertools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from d3d12_deferred_renderer_tpu.parallel import make_mesh as jax_make_mesh
from d3d12_deferred_renderer_tpu.parallel import render_tri_sharded as jax_render_tri_sharded
from d3d12_deferred_renderer_tpu.parallel import sharded as jax_sharded

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops.binning import bin_triangles
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import FragmentPlanes, rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles
from d3d12_deferred_renderer_tpu_torch.parallel import animation_times, dryrun, mesh, run_bands, sharded
from d3d12_deferred_renderer_tpu_torch.parallel.dryrun import dryrun_job
from d3d12_deferred_renderer_tpu_torch.parallel.launch import mesh_frames, mesh_lines, run_calls, tri_planes

TIMEOUT_S = 240.0
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
ROWS_TRI = ((2, 2), ("rows", "tri"))
ORDERS = {"rows_tri": ((2, 2), ("rows", "tri")), "tri_rows": ((2, 2), ("tri", "rows")),
          "frame_tri_rows": ((1, 2, 2), ("frame", "tri", "rows"))}
PBR_BLOOM_FXAA = dxr.RendererConfig(width=256, height=64, use_pallas=False, shading="pbr", bloom=True, fxaa=True)
BUMP = dict(width=256, height=64, shading="pbr", bloom=True, fxaa=True, normal_mapping=True)
BATCH_TIMES = [0.01, 0.02]
# name -> (config, scene, axis sizes, axis names, entry, keywords) of the
# 4-rank spawn; a JAX config, converted for the port.
CASES4 = {
    "lambert_fxaa": (dxr.RendererConfig(width=128, height=64, use_pallas=False, fxaa=True), "bench",
                     *ROWS_TRI, "tri", dict(rows_axis="rows")),
    "tie": (dxr.RendererConfig(width=128, height=32, use_pallas=False, shading="pbr"), "tie",
            (1, 4), ("frame", "tri"), "tri", {}),
    **{f"order_{k}": (PBR_BLOOM_FXAA, "bench_lit", sizes, names, "tri", dict(rows_axis="rows"))
       for k, (sizes, names) in ORDERS.items()},
    "full_stack_tri_rows": (dxr.RendererConfig(width=128, height=32, use_pallas=False, shading="pbr", shadows=True,
                                               shadow_map_size=64, bloom=True, fxaa=True),
                            "bench_lit", *ORDERS["tri_rows"], "tri", dict(rows_axis="rows")),
    "bloom_fxaa_bump": (dxr.RendererConfig(use_pallas=False, **BUMP), "bench_lit", *ROWS_TRI, "tri",
                        dict(rows_axis="rows")),
    "bloom_fxaa_bump_kernels": (dxr.RendererConfig(use_pallas=True, fused=False, **BUMP), "bench_lit", *ROWS_TRI,
                                "tri", dict(rows_axis="rows")),
    "frames_rows": (dxr.RendererConfig(width=128, height=32, use_pallas=False), "bench", (2, 2), ("frame", "rows"),
                    "frames", dict(times=BATCH_TIMES)),
    "frames_tri_rows": (dxr.RendererConfig(width=128, height=32, use_pallas=False), "bench", (1, 2, 2),
                        ("frame", "tri", "rows"), "tri_frames", dict(times=BATCH_TIMES, rows_axis="rows")),
}
# The 3-rank spawn: three shards of a stream that is no multiple of 3
# (the last slice padded), and the overflow signal through the tile
# raster's plain version.
OVERFLOW = dict(width=128, height=48, tile_h=8, tile_w=128, use_pallas=True)
CASES3 = {
    "lambert_tri3": (dxr.RendererConfig(width=128, height=48, use_pallas=False), "bench", (3,), ("tri",), "tri", {}),
    "overflow_cap1": (dxr.RendererConfig(**OVERFLOW, max_tris_per_tile=1), "bench", (3,), ("tri",), "tri", {}),
    "overflow_cap256": (dxr.RendererConfig(**OVERFLOW, max_tris_per_tile=256), "bench", (3,), ("tri",), "tri", {}),
}
PLANES = {"tie": ((1, 4), ("frame", "tri"), "tri", None), "lambert_fxaa": (*ROWS_TRI, "tri", "rows")}


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
    """The two spawns -> {case: [each rank's (frames, overflow)]}, {case:
    [each rank's composited planes]}, the dry run's and mesh_lines's
    per-rank results, and the JAX states."""
    states = {k: _scene(c[1], c[0]) for k, c in {**CASES4, **CASES3}.items()}
    planes = [(tp.arrays_from_state(states[k]), _tcfg(CASES4[k][0]), *PLANES[k]) for k in PLANES]
    calls4 = [(mesh_frames, (_items(CASES4, states),)), (tri_planes, (planes,)), (dryrun_job, ()),
              (mesh_lines, ((2, 2), ("tri", "rows")))]
    r4 = run_bands(4, run_calls, (calls4,), device="cpu", timeout_s=TIMEOUT_S)
    r3 = run_bands(3, mesh_frames, (_items(CASES3, states),), device="cpu", timeout_s=TIMEOUT_S)
    frames = {k: [r[0][i] for r in r4] for i, k in enumerate(CASES4)}
    frames.update({k: [r[i] for r in r3] for i, k in enumerate(CASES3)})
    return dict(frames=frames, planes={k: [r[1][i] for r in r4] for i, k in enumerate(PLANES)},
                dryrun=[r[2] for r in r4], lines=[r[3] for r in r4], states=states)


def _single(state, cfg, t=None):
    st = _port_state(state)
    if t is not None:
        st = sharded._with_time(st, t)
    frame, stats = tp.render_stats(st, dataclasses.replace(_tcfg(cfg), fused=False))
    return frame.numpy(), int(stats["overflow"])


def _within(a, b, exact):
    d = np.abs(a.astype(int) - b.astype(int))
    if exact:
        assert d.max() == 0, f"max u8 diff {d.max()} on {(d > 0).mean():.4%} of pixels"
    else:
        assert d.max() <= 1 and (d > 0).mean() < 2e-3, (d.max(), (d > 0).mean())


def _frame(runs, case):
    """Rank 0's frames and overflow, after checking every rank holds them."""
    ranks = runs["frames"][case]
    f, o = ranks[0]
    assert all(np.array_equal(g, f) and p == o for g, p in ranks)
    return f, o


def test_lambert_fxaa_matches_jax_and_single_device(runs):
    cfg = CASES4["lambert_fxaa"][0]
    state = runs["states"]["lambert_fxaa"]
    frame, ovf = _frame(runs, "lambert_fxaa")
    mesh = jax_make_mesh(*ROWS_TRI, devices=jax.devices()[:4])
    setup = jax_setup(state, cfg)  # op by op: the port is pinned to these records
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded, "setup_frame_triangles", lambda st, c: setup)
        jf, stats = jax.jit(lambda st: jax_render_tri_sharded(st, cfg, mesh, tri_axis="tri", rows_axis="rows",
                                                              return_stats=True))(state)
    jf = np.asarray(jf)
    assert frame.shape == jf.shape == (cfg.height, cfg.width, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame[1:], jf[1:])
    single, single_ovf = _single(state, cfg)
    np.testing.assert_array_equal(frame, single)
    assert ovf == int(stats["overflow"]) == single_ovf == 0
    assert (frame.max(-1) > 0).mean() > 0.2


def test_tie_first_slice_wins(runs):
    """Coincident cubes: every covered pixel ties between slices on
    different ranks (12 triangles, 24 records: mesh 0 on ranks 0-1, mesh 1
    on ranks 2-3).  The composited planes equal the single-device raster's
    bit for bit, the frame the single-device frame within the PBR bound."""
    cfg = CASES4["tie"][0]
    state = runs["states"]["tie"]
    frame, ovf = _frame(runs, "tie")
    _within(frame, _single(state, cfg)[0], exact=False)
    assert ovf == 0
    st = _port_state(state)
    tris, _ = setup_frame_triangles(st, _tcfg(cfg))
    ref = sharded._stack_planes(rasterize_packed(tris.packed, cfg.height, cfg.width)).numpy()
    for got in runs["planes"]["tie"]:
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    mid = ref[..., 6]
    assert (mid == 0).mean() > 0.05 and not (mid == 1).any()  # mesh 0 wins every tie


def test_composited_planes_match_single_device_raster(runs):
    cfg = CASES4["lambert_fxaa"][0]
    tris, _ = setup_frame_triangles(_port_state(runs["states"]["lambert_fxaa"]), _tcfg(cfg))
    ref = sharded._stack_planes(rasterize_packed(tris.packed, cfg.height, cfg.width)).numpy()
    for got in runs["planes"]["lambert_fxaa"]:
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_declaration_order_does_not_change_the_frame(runs):
    state = runs["states"]["order_rows_tri"]
    single = _single(state, PBR_BLOOM_FXAA)[0]
    frames = {k: _frame(runs, f"order_{k}") for k in ORDERS}
    for k, (f, ovf) in frames.items():
        _within(f, single, exact=False)
        assert ovf == 0, k
    for k in ("tri_rows", "frame_tri_rows"):
        np.testing.assert_array_equal(frames[k][0], frames["rows_tri"][0])


@pytest.mark.parametrize("case", ["full_stack_tri_rows", "bloom_fxaa_bump", "bloom_fxaa_bump_kernels"])
def test_cross_band_filters_match_single_device(runs, case):
    """Shadows + bloom + FXAA on the ("tri", "rows") declaration, and bloom
    + FXAA + bump on (rows, tri) sub-bands of 16 rows: through the plain
    chain (the block-form bump) and through the kernels' plain versions
    (the bump kernel's on each composited sub-band)."""
    cfg = CASES4[case][0]
    frame, ovf = _frame(runs, case)
    single, single_ovf = _single(runs["states"][case], cfg)
    _within(frame, single, exact=False)
    assert ovf == single_ovf == 0
    assert (frame.max(-1) > 0).mean() > 0.2


@pytest.mark.parametrize("case", ["frames_rows", "frames_tri_rows"])
def test_batches_match_single_device_at_each_clock(runs, case):
    cfg = CASES4[case][0]
    frames, ovf = _frame(runs, case)
    assert frames.shape == (len(BATCH_TIMES), cfg.height, cfg.width, 3)
    for i, t in enumerate(BATCH_TIMES):
        np.testing.assert_array_equal(frames[i], _single(runs["states"][case], cfg, t)[0])
    assert ovf == 0
    assert not np.array_equal(frames[0], frames[1])


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


def test_dryrun_steps_pass_in_every_rank(runs):
    assert runs["dryrun"] == [["staged", "kernels", "three_axis"]] * 4


def test_make_mesh_lays_ranks_out_row_major(runs):
    """make_mesh((2, 2), ("tri", "rows")): rank r at (r // 2, r % 2); the
    "tri" group of a rank holds the ranks of its column, "rows" of its row."""
    for rank, (coords, lines) in enumerate(runs["lines"]):
        assert coords == (rank // 2, rank % 2)
        assert lines == {"tri": [rank % 2, 2 + rank % 2], "rows": [2 * (rank // 2), 2 * (rank // 2) + 1]}
    assert mesh.axis_lines((2, 3, 2), 1).tolist() == [[0, 2, 4], [1, 3, 5], [6, 8, 10], [7, 9, 11]]


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


class _ThreadGroup(sharded.BandGroup):
    """One axis of ranks simulated by threads: `group` is the shared
    (barrier, slots) pair of the axis's line of ranks."""

    def _exchange(self, x):
        barrier, slots = self.group
        slots[self.index] = x
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_gather_tiled(self, x, dim=0):
        return torch.cat(self._exchange(x), dim) if self.total > 1 else x

    def sum(self, x):
        if self.total == 1:
            return x
        vals = self._exchange(x)
        return sum(vals[1:], vals[0])

    zero = 0.0

    def min(self, x):  # ties of +-0.0 resolve to the sign `zero` (a backend's choice)
        m = torch.stack(self._exchange(x)).amin(0)
        return torch.where(m == 0, torch.full_like(m, self.zero), m) if m.is_floating_point() else m

    def sum_scatter(self, x):  # added in turn, as the backends add (torch.sum would start from +0.0)
        vals = self._exchange(x)
        return sum(vals[1:], vals[0]).chunk(self.total)[self.index]


def _run_ranks(sizes, names, fn):
    """fn(mesh coords) in a thread per rank of a mesh of `sizes` -> results
    in rank order; every axis line shares a barrier."""
    lines = {}
    for ax, size in enumerate(sizes):
        for line in mesh.axis_lines(sizes, ax):
            shared = (threading.Barrier(size), [None] * size)
            for r in line:
                lines[(ax, int(r))] = shared
    n = int(np.prod(sizes))
    out = [None] * n

    def run(r):
        coords = mesh.mesh_coords(r, sizes)
        out[r] = fn(coords, {names[ax]: lines[(ax, r)] for ax in range(len(sizes))})

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "a simulated rank is still waiting"
    return out


def _axes(coords, shared, sizes, names, order):
    return sharded.BandAxes(tuple(
        _ThreadGroup(shared[nm], coords[names.index(nm)], sizes[names.index(nm)], False) for nm in order))


@pytest.mark.parametrize("names", [("rows", "tri"), ("tri", "rows")])
def test_band_index_and_gather_are_rows_major(names):
    """tests/test_band_axes.py's contract: on either declaration order the
    band index is rows_idx * 2 + tri_idx and every rank gathers the bands
    in that order."""
    sizes = (2, 2)

    def fn(coords, shared):
        axes = _axes(coords, shared, sizes, names, ("rows", "tri"))
        rows, tri = coords[names.index("rows")], coords[names.index("tri")]
        mine = torch.tensor([10 * rows + tri])
        return (axes.index, rows * 2 + tri, axes.total, axes.all_gather_tiled(mine).tolist(),
                int(axes.sum(torch.tensor(1))))

    for index, expect, total, gathered, count in _run_ranks(sizes, names, fn):
        assert index == expect and total == count == 4
        assert gathered == [0, 1, 10, 11]


def test_band_axes_single_axis():
    def fn(coords, shared):
        axes = _axes(coords, shared, (4,), ("rows",), ("rows",))
        return axes.index, axes.all_gather_tiled(torch.tensor([axes.index])).tolist()

    assert _run_ranks((4,), ("rows",), fn) == [(i, [0, 1, 2, 3]) for i in range(4)]


@pytest.mark.parametrize("zero", [0.0, -0.0], ids=["min_gives_plus", "min_gives_minus"])
def test_composite_keeps_the_first_slice_sign_of_zero(zero):
    """Depths of +0.0 and -0.0 tie; whichever sign the minimum returns, the
    first slice's depth and planes come through with their bits, as the
    single-device raster keeps the first triangle's.  -0.0 attributes stay
    -0.0, and the background keeps mesh id -1."""
    pz, nz = 0.0, -0.0
    depth = [torch.tensor([[pz, nz, 0.5, 1.0]]), torch.tensor([[nz, pz, 0.25, 1.0]])]
    normal = [torch.tensor([[[nz, 1.0, 2.0]] * 4]), torch.tensor([[[3.0, 4.0, 5.0]] * 4])]
    mid = [torch.tensor([[0, 0, 0, -1]], dtype=torch.int32), torch.tensor([[1, 1, 1, -1]], dtype=torch.int32)]

    group = type("Group", (_ThreadGroup,), {"zero": zero})

    def fn(coords, shared):
        g = group(shared["tri"], coords[0], 2, False)
        r = coords[0]
        frags = FragmentPlanes(depth=depth[r].repeat(2, 1), normal=normal[r].repeat(2, 1, 1),
                                                 uv=torch.full((2, 4, 2), nz), mesh_id=mid[r].repeat(2, 1))
        return sharded._stack_planes(sharded._composite_tri(frags, g))

    out = torch.cat(_run_ranks((2,), ("tri",), fn))  # sub-bands of one row each
    for row in out:
        d = row[:, 0]
        assert d.view(torch.int32).tolist() == torch.tensor([pz, nz, 0.25, 1.0]).view(torch.int32).tolist()
        assert row[:, 6].tolist() == [0.0, 0.0, 1.0, -1.0]
        assert row[0, 1].view(torch.int32) == torch.tensor(nz).view(torch.int32)  # slice 0's -0.0 normal
        assert (row[:, 4:6].view(torch.int32) == torch.tensor(nz).view(torch.int32)).all()


def test_dryrun_helpers_follow_jax():
    from d3d12_deferred_renderer_tpu.parallel import dryrun as jax_dryrun

    for n in (1, 2, 4, 8, 12):
        assert dryrun.factor_axes(n) == jax_dryrun.factor_axes(n)
    for ours, theirs in ((dryrun.staged_config(), jax_dryrun.staged_config()),
                         (dryrun.kernel_config(), jax_dryrun.kernel_config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


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
