"""PyTorch port: the shadow map's PCF visibility against the JAX package.

At 256x64 with a 128^2 shadow map on the small benchmark scene (JAX's
camera setup run op by op, as the port's setup is pinned to it):

* dense, sparse and sparse + lit PCF visibility bit-equal (given JAX's
  inverse view-projection), with equal overflow, also where the tile cap
  overflows;
* the window-gather PCF (shadow_window_gather): the sparse, lit, tile-cap
  and bad-quad-cap cases bit-equal to JAX's, the pixels past the bad-quad
  cap included, with equal overflow; the bad-quad count with the unused
  tile slots' quads, flipping the overflow at the same cap as JAX's.

(Split from tests/test_torch_shadows.py.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import shadows as jsh
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import shadows

JCFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, shadows=True, shadow_map_size=128,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The JAX scene, its camera depth and view-projection (JAX's setup op
    by op, its reference raster jitted) and the shadow map, each computed
    once.  The shadow map is the port's: tests/test_torch_shadows.py holds
    it bit-equal to JAX's render_shadow_map."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    jstate = dxr.animate(dxr.make_scene(geo, JCFG, lights=dxr.random_point_lights(16, cfg=JCFG),
                                        placement="grid", materials=dxr.Materials.varied(geo.num_meshes)),
                         0.5, JCFG)
    tstate = tp.scene_from_arrays(tp.arrays_from_state(jstate), device="cpu")
    sd, lvp = shadows.render_shadow_map(tstate, TCFG)
    tris, vp = jax_setup(jstate, JCFG)
    depth = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, 64, 256).depth
    return dict(lvp=lvp.numpy(), sd=sd.numpy(), vp=vp, depth=depth, inv_vp=jnp.linalg.inv(vp))

# case -> (config changes, lit mask, overflow).  The window cases take the
# window-gather PCF (sparse path): bit-equal to the quad path while the
# bad-quad cap holds; past the cap (8, and the automatic cap of 3 tile
# slots: overflow 2, the tile cap's and the bad-quad cap's) its zero-tap
# pixels too are JAX's.
VIS_CASES = {
    "dense": (dict(shadow_tiles_cap=0), False, 0),
    "sparse": (dict(), False, 0),
    "sparse_lit": (dict(), True, 0),
    "cap_overflow": (dict(shadow_tiles_cap=3, shadow_tiles_cap_lit=0), False, 1),
    "window": (dict(shadow_window_gather=True), False, 0),
    "window_lit": (dict(shadow_window_gather=True), True, 0),
    "window_cap_overflow": (dict(shadow_window_gather=True, shadow_tiles_cap=3, shadow_tiles_cap_lit=0),
                            False, 2),
    "window_bad_quads_cap_8": (dict(shadow_window_gather=True, shadow_bad_quads_cap=8), False, 1),
}


def _lit_mask(lit):
    return np.random.default_rng(9).uniform(0, 1, (64, 256)) < 0.5 if lit else None


def _port_vis(scene, jcfg, lit_mask, depth=None, **kw):
    """The port's shadow_visibility on the scene's JAX inputs -> (vis, overflow)."""
    return shadows.shadow_visibility(
        t(scene["depth"] if depth is None else depth), t(scene["vp"]), t(scene["sd"]), t(scene["lvp"]),
        tp.RendererConfig(**dataclasses.asdict(jcfg)), return_overflow=True,
        lit_mask=None if lit_mask is None else t(lit_mask), inv_vp=t(scene["inv_vp"]), **kw,
    )


@pytest.mark.parametrize("case", sorted(VIS_CASES))
def test_visibility_matches_jax(scene, case):
    change, lit, expect_overflow = VIS_CASES[case]
    jcfg = dataclasses.replace(JCFG, **change)
    lit_mask = _lit_mask(lit)
    ref, jov = jsh.shadow_visibility(scene["depth"], scene["vp"], scene["sd"], scene["lvp"], jcfg,
                                     return_overflow=True, lit_mask=lit_mask)
    got, tov = _port_vis(scene, jcfg, lit_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(tov) == int(jov) == expect_overflow
    assert 0.0 < float((got < 1.0).double().mean()) < 0.9  # some pixels in shadow
    if jcfg.shadow_window_gather:
        quad, qov = _port_vis(scene, dataclasses.replace(jcfg, shadow_window_gather=False), lit_mask)
        # Equal to the quad path exactly where the bad-quad cap holds.
        assert torch.equal(got, quad) == (int(tov) == int(qov))


@pytest.mark.parametrize("roll", [0, 24], ids=["as_rendered", "rolled_24_rows"])
def test_window_bad_quad_count_matches_jax(scene, roll, monkeypatch):
    """The bad-quad count, the unused tile slots' quads included (they
    repeat the last tile, as JAX's do): the overflow flips from 1 to 0 at
    the same cap in both packages.  n_bad is the port's count; JAX's
    overflow at n_bad - 1 and n_bad shows it is JAX's too.  10 of the 16
    slots hold covered tiles; rolled down 24 rows, the depth puts bad quads
    in the last tile, which the 6 unused slots repeat."""
    depth = np.roll(np.asarray(scene["depth"]), roll, axis=0)
    jcfg = dataclasses.replace(JCFG, shadow_window_gather=True)
    rows = []
    window_rows = shadows._pcf_window_rows
    monkeypatch.setattr(shadows, "_pcf_window_rows", lambda sd, uv, z, *a, **k: (
        rows.append(uv), window_rows(sd, uv, z, *a, **k))[1])
    _port_vis(scene, jcfg, None, depth=depth)
    bad = shadows.window_quads(t(scene["sd"]), rows[0])[-1]
    n_cov = int((t(depth).reshape(8, 8, 2, 128).transpose(1, 2).reshape(16, 1024).amin(1) < 1.0).sum())
    n_bad = int(bad.sum())
    assert n_cov == 10 and bad.shape[0] == 16  # unused tile slots
    assert int(bad[n_cov:].sum()) == (6 * 103 if roll else 0)
    for cap, overflow in ((n_bad - 1, 1), (n_bad, 0)):
        ccfg = dataclasses.replace(jcfg, shadow_bad_quads_cap=cap)
        ref, jov = jsh.shadow_visibility(depth, scene["vp"], scene["sd"], scene["lvp"], ccfg,
                                         return_overflow=True)
        got, tov = _port_vis(scene, ccfg, None, depth=depth)
        assert int(tov) == int(jov) == overflow
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
