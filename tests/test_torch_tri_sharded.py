"""PyTorch port: the rank mesh (make_mesh), the triangle-sharded path
(render_tri_sharded, sort-last compositing), the batch-sharded entry
points and the multi-device dry run, on the CPU.

The port's ranks run as spawned processes in a gloo group on the CPU, one
spawn of 4 ranks (parallel.run_bands with device="cpu"; parallel.launch.
run_calls runs every job of the spawn in one group) for the meshes of two
axes and more, and the dry run.  One JAX reference: JAX's
render_tri_sharded, jitted on 4 virtual CPU devices of tests/conftest.py,
given the records of its setup run op by op.  The contracts of
tests/test_tri_sharded.py and tests/test_dryrun.py:

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
* frames x rows and frames x tri x rows batches against the single-device
  frame at each clock;
* the dry run's three steps (dryrun_multichip's job) in 4 ranks, and its
  helpers equal to JAX's.

The 3-rank spawn, the refusals and the clock helpers are in
tests/test_torch_tri_shards3.py, BandAxes and the composite's sign of zero
(ranks simulated by threads) in tests/test_torch_band_axes.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from d3d12_deferred_renderer_tpu.parallel import make_mesh as jax_make_mesh
from d3d12_deferred_renderer_tpu.parallel import render_tri_sharded as jax_render_tri_sharded
from d3d12_deferred_renderer_tpu.parallel import sharded as jax_sharded

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles
from d3d12_deferred_renderer_tpu_torch.parallel import dryrun, mesh, run_bands, sharded
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
    """The 4-rank spawn -> {case: [each rank's (frames, overflow)]}, {case:
    [each rank's composited planes]}, the dry run's and mesh_lines's
    per-rank results, and the JAX states."""
    states = {k: _scene(c[1], c[0]) for k, c in CASES4.items()}
    planes = [(tp.arrays_from_state(states[k]), _tcfg(CASES4[k][0]), *PLANES[k]) for k in PLANES]
    calls4 = [(mesh_frames, (_items(CASES4, states),)), (tri_planes, (planes,)), (dryrun_job, ()),
              (mesh_lines, ((2, 2), ("tri", "rows")))]
    r4 = run_bands(4, run_calls, (calls4,), device="cpu", timeout_s=TIMEOUT_S)
    return dict(frames={k: [r[0][i] for r in r4] for i, k in enumerate(CASES4)},
                planes={k: [r[1][i] for r in r4] for i, k in enumerate(PLANES)},
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


def test_dryrun_steps_pass_in_every_rank(runs):
    assert runs["dryrun"] == [["staged", "kernels", "three_axis"]] * 4


def test_make_mesh_lays_ranks_out_row_major(runs):
    """make_mesh((2, 2), ("tri", "rows")): rank r at (r // 2, r % 2); the
    "tri" group of a rank holds the ranks of its column, "rows" of its row."""
    for rank, (coords, lines) in enumerate(runs["lines"]):
        assert coords == (rank // 2, rank % 2)
        assert lines == {"tri": [rank % 2, 2 + rank % 2], "rows": [2 * (rank // 2), 2 * (rank // 2) + 1]}
    assert mesh.axis_lines((2, 3, 2), 1).tolist() == [[0, 2, 4], [1, 3, 5], [6, 8, 10], [7, 9, 11]]


def test_dryrun_helpers_follow_jax():
    from d3d12_deferred_renderer_tpu.parallel import dryrun as jax_dryrun

    for n in (1, 2, 4, 8, 12):
        assert dryrun.factor_axes(n) == jax_dryrun.factor_axes(n)
    for ours, theirs in ((dryrun.staged_config(), jax_dryrun.staged_config()),
                         (dryrun.kernel_config(), jax_dryrun.kernel_config())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
