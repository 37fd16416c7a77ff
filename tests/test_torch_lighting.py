"""PyTorch port: G-buffer, lighting, light cull, the G-buffer lighting kernel's
plain version and post, against the JAX package.

Both packages take the same inputs: a G-buffer rasterized by JAX from the
small benchmark scene (and a random one, as tests/test_lighting.py builds),
its view-projection, and numpy-made lights.  Contracts:

* encode_gbuffer / decode_gbuffer bit-equal;
* shade_lambert within 1e-6, shade_pbr_tiled within rtol 2e-4, atol 2e-5;
* cull_lights_to_tiles ids, counts and overflow exactly equal, on square and
  8 x 128 tiles, including a case whose tiles overflow their cap;
* the lighting kernel's plain version (shade_tiles_reference, through
  shade_pbr_tiled_kernel on CPU tensors) against JAX shade_pbr_tiled_pallas
  (interpret=True), with and without a visibility plane, at the tolerance of
  test_lighting.py's kernel test (rtol 2e-4, atol 2e-5), equal overflow;
* post (Reinhard, gamma, uint8) within float32 rounding, uint8 equal.
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
from d3d12_deferred_renderer_tpu.ops import post as jpost
from d3d12_deferred_renderer_tpu.ops.lighting_pallas import shade_pbr_tiled_pallas
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import gbuffer as tgb
from d3d12_deferred_renderer_tpu_torch.ops import lighting as tl
from d3d12_deferred_renderer_tpu_torch.ops import lighting_cuda
from d3d12_deferred_renderer_tpu_torch.ops import post as tpost
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import FragmentPlanes

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
_jax_shade_pbr_tiled = jax.jit(
    lambda gb, li, cfg, vp, eye: jl.shade_pbr_tiled(gb, li, cfg, vp, eye, tile=32,
                                                    return_overflow=True),
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
    """JAX fragments of the small benchmark scene, both packages' G-buffers,
    the view-projection, the materials."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.make_scene(geo, CFG, placement="grid", materials=dxr.Materials.varied(geo.num_meshes))
    state = dxr.animate(state, 0.3, CFG)
    tris, vp = jax.jit(jax_setup, static_argnums=(1,))(state, CFG)
    frags = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, CFG.height, CFG.width)
    mats = state.materials
    jg = jgb.encode_gbuffer(frags, mats, CFG)
    tfrags = FragmentPlanes(*(_t(a) for a in frags))
    tmats = tp.Materials(albedo=_t(mats.albedo), metalness=_t(mats.metalness),
                         roughness=_t(mats.roughness))
    tg = tgb.encode_gbuffer(tfrags, tmats, TCFG)
    return dict(jg=jg, tg=tg, vp=vp, tvp=_t(vp), eye=state.camera.eye, teye=_t(state.camera.eye))


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


def test_encode_gbuffer_bit_equal(scene):
    for j, t in zip(scene["jg"], scene["tg"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (scene["tg"].depth < 1.0).float().mean() > 0.2


@pytest.mark.parametrize("which", ["scene", "random"])
def test_decode_gbuffer_bit_equal(scene, which):
    """Bit-equal on the encoded G-buffer.  The random one is not quantized,
    and on such albedo values XLA's float32 pow differs from a correctly
    rounded one in the last bit now and then (0.07% of values)."""
    jg, tg = _gbuffers(scene, which)
    for j, t in zip(jgb.decode_gbuffer(jg, CFG), tgb.decode_gbuffer(tg, TCFG)):
        if which == "scene":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7, atol=0)


def test_shade_lambert_matches_jax(scene):
    jli, tli = _lights()
    ref = np.asarray(jl.shade_lambert(scene["jg"], jli, CFG))
    got = tl.shade_lambert(scene["tg"], tli, TCFG).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["scene", "random"])
def test_shade_pbr_tiled_matches_jax(scene, which):
    jg, tg = _gbuffers(scene, which)
    jli, tli = _lights()
    ref, jov = _jax_shade_pbr_tiled(jg, jli, CFG, scene["vp"], scene["eye"])
    got, tov = tl.shade_pbr_tiled(tg, tli, TCFG, scene["tvp"], scene["teye"], tile=32,
                                  return_overflow=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert int(tov) == int(jov)


def test_tiled_equals_unculled(scene):
    """The cull is exact: the windowed falloff is zero at the radius."""
    _, tli = _lights()
    args = (scene["tg"], tli, TCFG, scene["tvp"], scene["teye"])
    np.testing.assert_allclose(tl.shade_pbr_tiled(*args, tile=16).numpy(),
                               tl.shade_pbr(*args).numpy(), rtol=1e-4, atol=1e-5)


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


def test_post_matches_jax():
    rng = np.random.default_rng(5)
    hdr = rng.uniform(-0.5, 4.0, (16, 32, 3)).astype(np.float32)
    jh, th = jnp.asarray(hdr), torch.from_numpy(hdr)
    np.testing.assert_allclose(tpost.reinhard(th).numpy(), np.asarray(jpost.reinhard(jh)), rtol=1e-7)
    np.testing.assert_allclose(tpost.gamma_encode(th, 2.2).numpy(),
                               np.asarray(jpost.gamma_encode(jh, 2.2)), rtol=2e-7)
    jc, tc = jpost.apply_post(jh, CFG), tpost.apply_post(th, TCFG)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-7)
    np.testing.assert_array_equal(tpost.to_uint8(tc).numpy(), np.asarray(jpost.to_uint8(jc)))
    # Bloom and FXAA are ported too: the same values as the JAX package's.
    cfg4 = dataclasses.replace(CFG, bloom=True, fxaa=True)
    jc, tc = jpost.apply_post(jh, cfg4), tpost.apply_post(th, tp.RendererConfig(**dataclasses.asdict(cfg4)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-7)
