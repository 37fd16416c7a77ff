"""PyTorch port: the light cull and the G-buffer lighting kernel's plain
version against the JAX package.

Both packages take the same inputs: the port's G-buffer of the small
benchmark scene (its setup and reference raster on the CPU; the scene from
the numpy builders that tests/test_torch_frame.py holds identical to
JAX's) and a random one, as tests/test_lighting.py builds, its
view-projection, and numpy-made lights.  Contracts:

* cull_lights_to_tiles ids, counts and overflow exactly equal, on square and
  8 x 128 tiles, including a case whose tiles overflow their cap;
* the lighting kernel's plain version (shade_tiles_reference, through
  shade_pbr_tiled_kernel on CPU tensors) against JAX shade_pbr_tiled_pallas
  (interpret=True), with and without a visibility plane, at the tolerance of
  test_lighting.py's kernel test (rtol 2e-4, atol 2e-5), equal overflow.

(Split from tests/test_torch_lighting.py.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import gbuffer as jgb
from d3d12_deferred_renderer_tpu.ops import lighting as jl
from d3d12_deferred_renderer_tpu.ops.lighting_pallas import shade_pbr_tiled_pallas

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import gbuffer as tgb
from d3d12_deferred_renderer_tpu_torch.ops import lighting as tl
from d3d12_deferred_renderer_tpu_torch.ops import lighting_cuda
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize_packed
from d3d12_deferred_renderer_tpu_torch.ops.transform import setup_frame_triangles

CFG = dxr.RendererConfig(width=256, height=64, shading="pbr", tile_h=8, tile_w=128,
                         max_live_lights_per_tile=32)
TCFG = tp.RendererConfig(**dataclasses.asdict(CFG))
TOL = dict(rtol=2e-4, atol=2e-5)


_jax_cull = jax.jit(
    lambda depth, li, cfg, vp, tile, cap: jl.cull_lights_to_tiles(depth, li, cfg, vp, tile,
                                                                  max_per_tile=cap),
    static_argnums=(2, 4, 5),
)


_jax_lighting_kernel = jax.jit(
    lambda gb, li, cfg, vp, eye, vis: shade_pbr_tiled_pallas(
        gb, li, cfg, vp, eye, shadow_visibility=vis, interpret=True, return_overflow=True),
    static_argnums=(2,),
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lights(n=24, seed=3, radius=3.0):
    """numpy light arrays -> (JAX Lights, port Lights)."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        direction=np.asarray([-0.3, -0.2, -1.0], np.float32),
        color=np.ones(3, np.float32),
        point_position=rng.uniform(-6, 6, (n, 3)).astype(np.float32),
        point_color=rng.uniform(0.2, 1, (n, 3)).astype(np.float32),
        point_radius=np.full(n, radius, np.float32),
        point_intensity=np.full(n, 1.5, np.float32),
    )
    return (dxr.Lights(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            tp.Lights(**{k: torch.from_numpy(v) for k, v in arrs.items()}))


@pytest.fixture(scope="module")
def scene():
    """The port's G-buffer of the small benchmark scene (its setup and
    reference raster on the CPU) as both packages' tensors, the
    view-projection and the eye."""
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, TCFG, placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"),
                          device="cpu")
    state = tp.animate(state, 0.3, TCFG)
    tris, vp = setup_frame_triangles(state, TCFG)
    tg = tgb.encode_gbuffer(rasterize_packed(tris.packed, TCFG.height, TCFG.width), state.materials, TCFG)
    jg = jgb.GBuffer(*(jnp.asarray(a.numpy()) for a in tg))
    eye = state.camera.eye
    return dict(jg=jg, tg=tg, vp=jnp.asarray(vp.numpy()), tvp=vp, eye=jnp.asarray(eye.numpy()), teye=eye)


def _random_gb(h=64, w=256, seed=0):
    """A G-buffer with varied depth and normals (tests/test_lighting.py's)."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rng.uniform(0.9, 0.999, (h, w)).astype(np.float32)
    depth[: h // 4] = 1.0
    gb0 = np.concatenate([rng.uniform(0.1, 1, (h, w, 3)), rng.uniform(0, 1, (h, w, 1))], -1)
    gb1 = np.concatenate([n * 0.5 + 0.5, rng.uniform(0.1, 1, (h, w, 1))], -1)
    arrs = (gb0.astype(np.float32), gb1.astype(np.float32), depth)
    return jgb.GBuffer(*(jnp.asarray(a) for a in arrs)), tgb.GBuffer(*(torch.from_numpy(a) for a in arrs))


def _gbuffers(scene, which):
    if which == "scene":
        return scene["jg"], scene["tg"]
    return _random_gb()


@pytest.mark.parametrize("tile,cap,radius", [
    (32, 64, 3.0), ((8, 128), 32, 3.0), ((8, 128), 4, 6.0),
], ids=["square32", "8x128", "overflow"])
@pytest.mark.parametrize("which", ["scene", "random"])
def test_cull_lights_to_tiles_exact(scene, which, tile, cap, radius):
    jg, tg = _gbuffers(scene, which)
    jli, tli = _lights(radius=radius)
    ref = _jax_cull(jg.depth, jli, CFG, scene["vp"], tile, cap)
    got = tl.cull_lights_to_tiles(tg.depth, tli, TCFG, scene["tvp"], tile, max_per_tile=cap)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert int(got.overflow) == int(ref.overflow)
    assert (int(got.overflow) > 0) == (cap == 4)
    assert int(got.counts.sum()) > 0


@pytest.mark.parametrize("vis", [False, True], ids=["no_vis", "vis"])
@pytest.mark.parametrize("which", ["scene", "random"])
def test_lighting_kernel_plain_matches_jax_kernel(scene, which, vis):
    jg, tg = _gbuffers(scene, which)
    jli, tli = _lights()
    v = np.random.default_rng(11).uniform(0, 1, (64, 256)).astype(np.float32) if vis else None
    ref, jov = _jax_lighting_kernel(jg, jli, CFG, scene["vp"], scene["eye"],
                                    None if v is None else jnp.asarray(v))
    before = lighting_cuda.shade_tiles.launches
    got, tov = lighting_cuda.shade_pbr_tiled_kernel(
        tg, tli, TCFG, scene["tvp"], scene["teye"], return_overflow=True,
        shadow_visibility=None if v is None else torch.from_numpy(v),
    )
    assert lighting_cuda.shade_tiles.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert int(tov) == int(jov) == 0
    assert float(got.max()) > 0.0
