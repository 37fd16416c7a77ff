"""PyTorch port: procedural normal mapping and the post chain (config 4)
against the JAX package.

* bump_planar on random planes, and the block form of apply_normal_mapping
  on the small benchmark scene's fragments (JAX raster, JAX world
  positions): within 2.4e-7 (2 float32 ULP at 1.0), most values bit-equal.
  Not all: the port takes sin and rsqrt in float64 and rounds once, XLA's
  float32 sin and rsqrt are within 1 ULP of that.
* The plain version of the bump kernel, on the tile raster's planes of
  JAX's fragments, against JAX _apply_normal_mapping_pallas (interpret
  mode), given JAX's inverse view-projection: within 5e-4, fewer than 1% of
  values beyond 1e-4.  At 200x60 (padded to whole tiles) on the port's own
  raster planes, whose padding holds geometry: bit-equal on the frame's
  pixels to the cropped fragments restacked with background padding; and
  within the same contract of JAX's block form (there JAX's
  interpret-mode kernel differs from its own block form by 5.2e-4).  The
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


def _raster_planes(fr, tile_h=8, tile_w=128):
    """Fragments [H, W] as the tile raster's planes [8, Hp, Wp], padded to
    whole tiles with the raster's clear values (depth 1, mesh id -1, the
    rest 0)."""
    H, W = fr.depth.shape
    planes = torch.zeros((8, -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w))
    planes[0], planes[6] = 1.0, -1.0
    planes[0, :H, :W], planes[6, :H, :W] = t(fr.depth), t(fr.mesh_id).float()
    planes[1:4, :H, :W] = t(fr.normal).permute(2, 0, 1)
    planes[4:6, :H, :W] = t(fr.uv).permute(2, 0, 1)
    return planes


def _bump_kernel_plain(planes, inv_vp, cfg):
    """The bump kernel through its wrapper on CPU planes (its plain version):
    the normals [H, W, 3] of the frame's pixels."""
    before = bump.bump_tiles.launches
    bump.bump_tiles(planes, inv_vp, width=cfg.width, height=cfg.height, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                    strength=STRENGTH, freq=FREQ)
    assert bump.bump_tiles.launches == before  # CPU: the plain version
    return planes[1:4, : cfg.height, : cfg.width].permute(1, 2, 0)


def test_bump_kernel_plain_matches_jax(frags):
    """The bump kernel's plain version (through its wrapper, on the CPU), on
    the raster's planes of JAX's fragments."""
    fr, _, vp = frags
    ref = jax.jit(lambda f, v: jbump._apply_normal_mapping_pallas(f, JCFG, STRENGTH, FREQ, v, interpret=True))(fr, vp)
    got = _bump_kernel_plain(_raster_planes(fr), t(jnp.linalg.inv(vp)), TCFG)
    _close(got, ref.normal, 5e-4, frac_over=0.01, over=1e-4)


def test_bump_kernel_plain_on_padded_raster_planes():
    """A 200x60 frame (padded to 256x64): the plain bump kernel on the tile
    raster's own planes, whose padding holds geometry, equals on the frame's
    pixels, bit for bit, the route that restacked the cropped fragments
    with background padding; and on the raster planes of JAX's fragments
    it keeps test_bump_kernel_plain_matches_jax's contract against JAX's
    block form."""
    from d3d12_deferred_renderer_tpu_torch.ops import binning, raster_tiles

    jcfg = dataclasses.replace(JCFG, width=200, height=60)
    tcfg = tp.RendererConfig(**dataclasses.asdict(jcfg))
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.animate(dxr.make_scene(geo, jcfg, placement="grid"), 0.5, jcfg)
    tris, vp = jax_setup(state, jcfg)
    inv_vp = t(jnp.linalg.inv(vp))
    b = binning.bin_triangles(t(tris.packed), t(tris.aabb), t(tris.valid), tcfg)
    planes = raster_tiles.raster_tiles(b.counts, b.offs, b.stream, nty=8, ntx=2, tile_h=8, tile_w=128)
    assert bool((planes[6, 60:] >= 0).any() | (planes[6, :, 200:] >= 0).any())  # geometry in the padding
    frags = raster_tiles.fragments_from_planes(planes, 60, 200)
    restacked = _raster_planes(type(frags)(*(a.numpy() for a in frags)))
    want = _bump_kernel_plain(restacked, inv_vp, tcfg)
    got = _bump_kernel_plain(planes.clone(), inv_vp, tcfg)
    assert torch.equal(got.contiguous().view(torch.int32), want.contiguous().view(torch.int32))
    assert (got != frags.normal).any(-1).double().mean() > 0.2

    # Against JAX's block form on JAX's fragments (its CPU path and its band
    # path's bump).  JAX's interpret-mode kernel is not the reference here:
    # on this frame it differs from JAX's own block form by 5.2e-4.
    fr = jax.jit(jax_rasterize, static_argnums=(1, 2))(tris.packed, 60, 200)
    ref = jbump.apply_normal_mapping(fr, reconstruct_world_positions(fr.depth, vp, jcfg), jcfg, STRENGTH, FREQ)
    _close(_bump_kernel_plain(_raster_planes(fr), inv_vp, tcfg), ref.normal, 5e-4, frac_over=0.01, over=1e-4)


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
