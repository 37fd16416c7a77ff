"""PyTorch port: procedural normal mapping and the post chain (config 4)
against the JAX package.

* bump_planar on random planes, and the block form of apply_normal_mapping
  on the small benchmark scene's fragments (JAX raster, JAX world
  positions): within 2.4e-7 (2 float32 ULP at 1.0), most values bit-equal.
  Not all: the port takes sin and rsqrt in float64 and rounds once, XLA's
  float32 sin and rsqrt are within 1 ULP of that.
* The plain version of the bump kernel against JAX
  _apply_normal_mapping_pallas (interpret mode), given JAX's inverse
  view-projection: within 5e-4, fewer than 1% of values beyond 1e-4.  The
  interpret-mode kernel is one jitted program in which XLA contracts the
  world-from-depth and tangent sums into fused multiply-adds; the port
  rounds every operation (as the JAX package's op-by-op staged path does),
  and the tangent solve divides world-position differences by uv
  differences of ~1e-3, which scales the last-bit world differences up.
* bloom, bloom_chw and FXAA bit-equal; apply_post within rtol 5e-7: the
  gamma pow's 1-ULP differences (tests/test_torch_lighting.py), carried
  through FXAA's blend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.ops import bump as jbump
from d3d12_deferred_renderer_tpu.ops import post as jpost
from d3d12_deferred_renderer_tpu.ops.lighting import reconstruct_world_positions
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize_packed as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.ops import bump, post
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import FragmentPlanes

JCFG = dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=False, normal_mapping=True,
                           bloom=True, fxaa=True)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))
STRENGTH, FREQ = JCFG.bump_strength, JCFG.bump_frequency


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frags():
    """JAX fragments, world positions and inverse view-projection of the
    small benchmark scene (setup op by op)."""
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.animate(dxr.make_scene(geo, JCFG, placement="grid"), 0.5, JCFG)
    tris, vp = jax_setup(state, JCFG)
    fr = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, 64, 256)
    return fr, reconstruct_world_positions(fr.depth, vp, JCFG), vp


def _port_frags(fr):
    return FragmentPlanes(depth=t(fr.depth), normal=t(fr.normal), uv=t(fr.uv), mesh_id=t(fr.mesh_id))


def _close(got, ref, atol, frac_exact=None, frac_over=None, over=None):
    got, ref = np.asarray(got), np.asarray(ref)
    d = np.abs(got - ref)
    assert d.max() <= atol, d.max()
    if frac_exact is not None:
        assert (d == 0).mean() >= frac_exact, (d == 0).mean()
    if frac_over is not None:
        assert (d > over).mean() < frac_over, (d > over).mean()


def test_bump_planar_matches_jax():
    rng = np.random.default_rng(4)
    shape = (3, 8, 16)
    world = [rng.uniform(-2, 2, shape).astype(np.float32) for _ in range(3)]
    uv = [(rng.uniform(0, 1, (3, 1, 1)) + np.arange(16) * 1e-3 + np.arange(8)[:, None] * 7e-4)
          .astype(np.float32) for _ in range(2)]
    n = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(3)]
    # Four meshes side by side (a background strip among them).
    mid = np.broadcast_to(np.repeat(rng.integers(-1, 3, (3, 1, 4)), 4, axis=-1), shape).astype(np.float32)
    ref = jbump.bump_planar(tuple(world), tuple(uv), tuple(n), mid, STRENGTH, FREQ)
    got = bump.bump_planar([t(a) for a in world], [t(a) for a in uv], [t(a) for a in n], t(mid), STRENGTH, FREQ)
    for g, r, n0 in zip(got, ref, n):
        _close(g, r, 2.4e-7, frac_exact=0.8)
        assert (np.asarray(g) != n0).mean() > 0.15  # pixels were perturbed


def test_block_normal_mapping_matches_jax(frags):
    fr, world, _ = frags
    ref = jbump.apply_normal_mapping(fr, world, JCFG, STRENGTH, FREQ)
    got = bump.apply_normal_mapping(_port_frags(fr), t(world), dataclasses.replace(TCFG, use_pallas=False),
                                    STRENGTH, FREQ)
    _close(got.normal, ref.normal, 2.4e-7, frac_exact=0.8)
    assert (np.asarray(ref.normal) != np.asarray(fr.normal)).any(-1).mean() > 0.2


def test_bump_kernel_plain_matches_jax(frags):
    """The bump kernel's plain version (through its wrapper, on the CPU)."""
    fr, _, vp = frags
    ref = jax.jit(lambda f, v: jbump._apply_normal_mapping_pallas(f, JCFG, STRENGTH, FREQ, v, interpret=True))(fr, vp)
    before = bump.bump_tiles.launches
    got = bump.apply_normal_mapping(_port_frags(fr), None, TCFG, STRENGTH, FREQ, inv_vp=t(jnp.linalg.inv(vp)))
    assert bump.bump_tiles.launches == before  # CPU: the plain version
    _close(got.normal, ref.normal, 5e-4, frac_over=0.01, over=1e-4)


def test_bloom_matches_jax():
    hdr = np.random.default_rng(6).uniform(-0.2, 3.0, (64, 200, 3)).astype(np.float32)
    ref = jpost.bloom(hdr, 1.0, 0.15)
    np.testing.assert_array_equal(post.bloom(t(hdr), 1.0, 0.15).numpy(), np.asarray(ref))
    chw = np.ascontiguousarray(hdr.transpose(2, 0, 1))
    np.testing.assert_array_equal(post.bloom_chw(t(chw), 1.0, 0.15).numpy(), np.asarray(jpost.bloom_chw(chw, 1.0, 0.15)))
    assert float(np.abs(np.asarray(ref) - hdr).max()) > 0.01


def test_fxaa_and_apply_post_match_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (40, 72, 3)).astype(np.float32)
    img[:, 36:] = 0.1  # a hard edge
    np.testing.assert_array_equal(post.fxaa(t(img)).numpy(), np.asarray(jpost.fxaa(img)))
    hdr = rng.uniform(-0.2, 3.0, (64, 256, 3)).astype(np.float32)
    for change in (dict(), dict(bloom=False), dict(fxaa=False), dict(tonemap="none")):
        jc = dataclasses.replace(JCFG, **change)
        ref = jpost.apply_post(hdr, jc)
        got = post.apply_post(t(hdr), tp.RendererConfig(**dataclasses.asdict(jc)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-7, atol=0)
