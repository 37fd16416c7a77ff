"""PyTorch port: the PCF visibility's band, dense and downsampled paths
against the JAX package.

At 256x64 with a 128^2 shadow map on the small benchmark scene, on inputs
the port computes (camera depth, view-projection, shadow map), both
packages' shadow_visibility given the same arrays:

* the window-gather flag on a band of a taller frame and on the dense path,
  which ignore it, as JAX's do: bit-equal to JAX's and to the flag off;
* downsampled visibility (shadow_vis_downsample 2 and 3, on a 61 x 253
  grid that neither divides) within 1e-6: the comparisons at the sampled
  pixels are the dense path's, and the bilinear upsampling weights round
  apart in float32 (jax.image.resize against F.interpolate).

(Split from tests/test_torch_shadows.py.)
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import shadows as jsh

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import shadows
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

JCFG = dataclasses.replace(
    dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, shadows=True, shadow_map_size=128,
)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The visibility inputs, each computed once by the port on the CPU: the
    small benchmark scene (the port's numpy builders, which
    tests/test_torch_frame.py holds identical to JAX's), its camera depth
    (the reference raster), view-projection and shadow map; the inverse
    view-projection is JAX's, as both packages' PCF must read one."""
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.animate(tp.make_scene(geo, TCFG, lights=tp.random_point_lights(16, cfg=TCFG, device="cpu"),
                                     placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"),
                                     device="cpu"), 0.5, TCFG)
    sd, lvp = shadows.render_shadow_map(state, TCFG)
    tris, vp = setup_frame_triangles(state, TCFG)
    depth = rasterize_packed(tris.packed, TCFG.height, TCFG.width).depth
    return dict(lvp=lvp.numpy(), sd=sd.numpy(), vp=vp.numpy(), depth=depth.numpy(),
                inv_vp=jnp.linalg.inv(jnp.asarray(vp.numpy())))


def _port_vis(scene, jcfg, lit_mask, depth=None, **kw):
    """The port's shadow_visibility on the scene's inputs -> (vis, overflow)."""
    return shadows.shadow_visibility(
        t(scene["depth"] if depth is None else depth), t(scene["vp"]), t(scene["sd"]), t(scene["lvp"]),
        tp.RendererConfig(**dataclasses.asdict(jcfg)), return_overflow=True,
        lit_mask=None if lit_mask is None else t(lit_mask), inv_vp=t(scene["inv_vp"]), **kw,
    )


@pytest.mark.parametrize("change, rows", [
    (dict(), dict(y_offset=8, full_height=128)), (dict(shadow_tiles_cap=0), dict()),
], ids=["band", "dense"])
def test_window_flag_off_the_sparse_path_changes_nothing(scene, change, rows):
    """A band of a taller frame and the dense path sample per pixel with
    the flag or without it, as JAX's do."""
    jcfg = dataclasses.replace(JCFG, shadow_window_gather=True, **change)
    ref = jsh.shadow_visibility(scene["depth"], scene["vp"], scene["sd"], scene["lvp"], jcfg, **rows)
    got, ovf = _port_vis(scene, jcfg, None, **rows)
    off, _ = _port_vis(scene, dataclasses.replace(jcfg, shadow_window_gather=False), None, **rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, off) and int(ovf) == 0


@pytest.mark.parametrize("d", [2, 3])
def test_downsampled_visibility_matches_jax(scene, d):
    jcfg = dataclasses.replace(JCFG, shadow_vis_downsample=d)
    depth = np.asarray(scene["depth"])[:61, :253]
    ref = jsh.shadow_visibility(depth, scene["vp"], scene["sd"], scene["lvp"], jcfg)
    got, ovf = shadows.shadow_visibility(
        t(depth), t(scene["vp"]), t(scene["sd"]), t(scene["lvp"]), tp.RendererConfig(**dataclasses.asdict(jcfg)),
        return_overflow=True, inv_vp=t(scene["inv_vp"]),
    )
    assert got.shape == (61, 253) and int(ovf) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert 0.0 < float((got < 1.0).double().mean()) < 0.9  # some pixels in shadow
