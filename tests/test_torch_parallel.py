"""PyTorch port: render_sharded, the screen-row band path over a
torch.distributed group, against the JAX package's render_sharded and the
port's own single-device frame.

The port's ranks run as spawned processes in gloo groups of 4 and 2 on the
CPU (parallel.run_bands, every wait with a deadline); JAX's render_sharded
runs on the 8 virtual CPU devices of tests/conftest.py.  Both take the same
scene arrays.  Contracts (tests/test_parallel.py, tests/test_band_raster.py):

* Lambert and Lambert + FXAA: every rank's frame equal to the port's
  single-device frame and to JAX's sharded frame, bit for bit (with FXAA
  but for JAX's row 0: its band 0 takes the last row of the frame as the
  row above it, see test_sharded_matches_jax_and_single_device);
* PBR, and bloom + FXAA + bump: within 1 u8 on fewer than 0.2% of pixels of
  both (band-local light culls), but for bloom + FXAA + bump against JAX:
  fewer than 3% (JAX runs jitted, given the records of its setup run op by
  op; XLA contracts the bump and GGX, and bloom spreads the differences);
* the overflow count summed over the bands, equal to JAX's, > 0 where a
  light cap is too small and 0 otherwise;
* through the kernels' plain versions (cfg.use_pallas): the fused band
  (in-kernel cull), the unsplit config-4 fused band (depth prepass, lists,
  dense PCF, bump, bloom, FXAA), the staged band on 20-row bands that are
  no multiple of tile_h (the fused config falls to the staged branch) and
  the staged config-4 band (the bump kernel on the band's raster planes,
  shadows, bloom), within the PBR contract of the port's single-device
  frame;
* a failing rank failing run_bands, and run_bands without a device
  refusing to start where there is no card.  The CPU ranks here pass
  device="cpu".

Every refusal of _check_band_safe and the height check are in
tests/test_torch_band_refusals.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup
from d3d12_deferred_renderer_tpu.parallel import make_mesh
from d3d12_deferred_renderer_tpu.parallel import render_sharded as jax_render_sharded
from d3d12_deferred_renderer_tpu.parallel import sharded as jax_sharded

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.parallel import run_bands, sharded
from d3d12_deferred_renderer_tpu_torch.parallel.launch import sharded_frames

TIMEOUT_S = 240.0
SMALL = dict(width=128, height=32, use_pallas=False)
# name -> (config, point lights (count, radius), bands); cfg.use_pallas
# False is JAX's CPU chain on both sides.
JAX_CASES = {
    "lambert": (dxr.RendererConfig(**SMALL), None, 4),
    "lambert_fxaa": (dxr.RendererConfig(**SMALL, fxaa=True), None, 4),
    "pbr": (dxr.RendererConfig(**SMALL, shading="pbr"), (8, None), 4),
    "bloom_fxaa_bump": (dxr.RendererConfig(width=256, height=128, use_pallas=False, shading="pbr", bloom=True,
                                           fxaa=True, normal_mapping=True), (8, None), 4),
    "light_overflow": (dxr.RendererConfig(**SMALL, shading="pbr", max_lights_per_tile=1), (16, 50.0), 4),
}
# The kernels' plain versions (use_pallas), against the port's own frame.
KERNEL_CASES = {
    "fused": (dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=128, height=32, fused=True), (8, None), 2),
    "config4_fused_unsplit": (dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=128, height=32, fused=True, shadows=True, shadow_map_size=64,
        normal_mapping=True, bloom=True, fxaa=True, inkernel_light_cull=False), (8, None), 2),
    # 20-row bands: no multiple of tile_h, so the staged branch.
    "staged_unaligned": (dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=128, height=40, fused=True),
                         (8, None), 2),
    # The staged config 4: the bump kernel on each band's raster planes.
    "config4_staged": (dataclasses.replace(
        dxr.FLAGSHIP_CONFIG, width=128, height=32, fused=False, shadows=True, shadow_map_size=64,
        normal_mapping=True, bloom=True), (8, None), 2),
}


def _scene(cfg, lights):
    """The small benchmark scene (4 meshes on the grid: most of the frame
    covered), numpy-seeded lights and materials."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    kw = {}
    if lights is not None:
        n, radius = lights
        kw["lights"] = dxr.random_point_lights(n, cfg=cfg, **({} if radius is None else {"radius": radius}))
    state = dxr.make_scene(geo, cfg, placement="grid", materials=dxr.Materials.varied(geo.num_meshes), **kw)
    return dxr.animate(state, 0.5, cfg)


def _tcfg(cfg):
    return tp.RendererConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def runs():
    """name -> (JAX state, the port's ranks' [(frame, overflow)] or None,
    JAX's (frame, overflow) or None), two spawns in all: 4 ranks, 2 ranks."""
    cases = {**JAX_CASES, **KERNEL_CASES}
    states = {name: _scene(cfg, lights) for name, (cfg, lights, _) in cases.items()}
    out = {}
    for n in (4, 2):
        names = [name for name, c in cases.items() if c[2] == n]
        jobs = [(tp.arrays_from_state(states[name]), _tcfg(cases[name][0])) for name in names]
        ranks = run_bands(n, sharded_frames, (jobs,), device="cpu", timeout_s=TIMEOUT_S)
        for k, name in enumerate(names):
            out[name] = [r[k] for r in ranks]
    res = {}
    for name, (cfg, _, n) in cases.items():
        jax_out = None
        if name in JAX_CASES:
            mesh = make_mesh((1, n), devices=jax.devices()[:n])
            # Jitted, one program (an eager shard_map dispatches op by op on
            # every device: about a minute a frame here), with the records
            # of the setup run op by op, to which the port is pinned
            # (jitted XLA contracts the setup's products into fused
            # multiply-adds and moves silhouette pixels).
            setup = jax_setup(states[name], cfg)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_sharded, "setup_frame_triangles", lambda st, c: setup)
                jf, stats = jax.jit(lambda st: jax_render_sharded(st, cfg, mesh, return_stats=True))(
                    states[name])
            jax_out = (np.asarray(jf), int(stats["overflow"]))
        res[name] = (states[name], out[name], jax_out)
    return res


def _single(state, cfg):
    frame, stats = tp.render_stats(tp.scene_from_arrays(tp.arrays_from_state(state), device="cpu"), _tcfg(cfg))
    return frame.numpy(), int(stats["overflow"])


def _within(a, b, exact, frac=2e-3):
    d = np.abs(a.astype(int) - b.astype(int))
    if exact:
        assert d.max() == 0, f"max u8 diff {d.max()} on {(d > 0).mean():.4%} of pixels"
    else:
        assert d.max() <= 1 and (d > 0).mean() < frac, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_sharded_matches_jax_and_single_device(runs, case):
    cfg, _, n = JAX_CASES[case]
    state, ranks, (jf, jov) = runs[case]
    frame, ovf = ranks[0]
    assert frame.shape == (cfg.height, cfg.width, 3) and frame.dtype == np.uint8
    assert all(np.array_equal(f, frame) and o == ovf for f, o in ranks)  # every rank holds the frame
    exact = cfg.shading == "lambert"
    # JAX's _fxaa_band slices its top halo row at index 2 * band - 1, which
    # the installed JAX wraps to the last band's last row for band 0
    # (dynamic_slice takes a negative start from the end), so JAX's sharded
    # FXAA differs from its own single-device frame in row 0.  The port
    # clamps there, as post.fxaa does: row 0 is held by the single-device
    # comparison below.
    skip = 1 if cfg.fxaa else 0
    # Jitted XLA also contracts the bump's and GGX's arithmetic, and bloom
    # spreads each 1-LSB difference over its blur: against JAX that frame
    # keeps the 1-LSB bound on fewer than 3% of pixels (op by op,
    # test_torch_config4.py holds config 4 to 2%).
    _within(frame[skip:], jf[skip:], exact, frac=3e-2 if cfg.normal_mapping else 2e-3)
    single, single_ovf = _single(state, cfg)
    _within(frame, single, exact)
    assert ovf == jov
    assert (ovf > 0) == (case == "light_overflow")
    if case != "light_overflow":
        assert single_ovf == 0
    assert (frame.max(-1) > 0).mean() > 0.2


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_sharded_kernel_paths_match_single_device(runs, case):
    cfg, _, n = KERNEL_CASES[case]
    state, ranks, _ = runs[case]
    frame, ovf = ranks[0]
    assert all(np.array_equal(f, frame) and o == ovf for f, o in ranks)
    single, single_ovf = _single(state, cfg)
    _within(frame, single, exact=False)
    assert ovf == single_ovf == 0
    assert (frame.max(-1) > 0).mean() > 0.2


def test_sharded_branches_follow_jax():
    """The fused band needs frame._fused_eligible and whole tiles; the
    kernels run with use_pallas (JAX's on_mosaic)."""
    fused = tp.RendererConfig(width=128, height=40, use_pallas=True, fused=True, shading="pbr")
    calls = []

    def stop(name):
        def record(*args, **kwargs):
            calls.append(name)
            raise StopIteration
        return record

    with pytest.MonkeyPatch.context() as mp:
        for attr, name in (("render_fused", "fused"), ("rasterize_binned", "tiles"),
                           ("rasterize_packed", "reference")):
            mp.setattr(sharded, attr, stop(name))
        state = tp.make_scene(tp.build_scene_geometry([tp.procedural.cube(1.0)]), fused, device="cpu")
        g = sharded.BandGroup(None, 0, 2, False)
        for cfg, band in ((fused, 16), (fused, 20), (dataclasses.replace(fused, fused=False), 16),
                          (dataclasses.replace(fused, use_pallas=False), 16)):
            with pytest.raises(StopIteration):
                sharded._render_band(state, cfg, 0, band, g)
    assert calls == ["fused", "tiles", "tiles", "reference"]


def test_run_bands_needs_a_card_by_default(monkeypatch):
    """run_bands without a device runs its ranks on the card: where there
    is none it raises RuntimeError before it spawns a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda *a: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bands(2, sharded_frames, ([],))
    assert spawned == []


def test_failing_rank_fails_run_bands():
    """Every rank refuses a height of 31 in 2 bands: run_bands raises with
    the ranks' error, within its deadline."""
    cfg = tp.RendererConfig(width=128, height=31, use_pallas=False)
    state = tp.make_scene(tp.build_scene_geometry([tp.procedural.cube(1.0)]), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not divisible"):
        run_bands(2, sharded_frames, ([(tp.arrays_from_state(state), cfg)],), device="cpu", timeout_s=TIMEOUT_S)
