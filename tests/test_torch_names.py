"""PyTorch port: public names of the JAX package that the port carries
besides its pipeline, against the JAX package on the same inputs.

* xmath.normalize, bit for bit (the port rounds the length as XLA's norm
  does: fused multiply-adds in order, a correctly rounded square root);
  transform_points and transform_vectors bit for bit on batched matrices
  (XLA's batched dot: a first product, then fused multiply-adds in order)
  and within 4 float32 roundings of each sum's magnitude on one matrix
  (XLA's unbatched dot sums in pairs);
* scene.default_transforms (the reference's placement), equal;
* ops/raster_ref.rasterize(tris, cfg): the whole frame's planes from the
  same records, depth and mesh id bit for bit, normal and uv within 4.8e-7
  (XLA contracts the scan's perspective interpolation into fused
  multiply-adds; the port's staged frames are pinned through the Pallas
  raster's interpret mode, tests/test_torch_raster.py).

And the guard of the test schedule's list, HEAVIEST_FIRST in the
repository's root conftest.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu import xmath as jxm
from d3d12_deferred_renderer_tpu.ops.raster_ref import rasterize as jax_rasterize
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles as jax_setup

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch import xmath as txm
from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import rasterize
from d3d12_deferred_renderer_tpu_torch.ops.transform import TriSetup


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)
    m = np.stack([
        np.asarray(jxm.look_at_lh((3.0, -2.0, 5.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
        np.asarray(jxm.model_matrix(jnp.asarray([0.5, -1.0, 2.0]), jnp.asarray([0.3, 1.1, -0.7]),
                                    jnp.asarray([1.5, 0.5, 2.0]))),
        rng.uniform(-2, 2, (4, 4)).astype(np.float32),
    ]).astype(np.float32)
    return dict(points=rng.uniform(-10, 10, (3, 50, 3)).astype(np.float32), m=m)


@pytest.mark.parametrize("kind", ["points", "vectors"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "one_matrix"])
def test_transforms_match_jax(arrays, kind, batched):
    v, m = arrays["points"], arrays["m"]
    if batched:
        m = np.ascontiguousarray(np.broadcast_to(m[:, None], (3, 50, 4, 4)))
    else:
        v, m = v[0], m[1]
    jfn, tfn = (jxm.transform_points, txm.transform_points) if kind == "points" else (
        jxm.transform_vectors, txm.transform_vectors)
    ref = np.asarray(jfn(jnp.asarray(v), jnp.asarray(m)))
    got = tfn(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    assert got.shape == ref.shape == v.shape[:-1] + ((4,) if kind == "points" else (3,))
    if batched:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        h = np.concatenate([v, np.ones_like(v[..., :1])], -1) if kind == "points" else v
        mag = np.abs(h) @ np.abs(m[: h.shape[-1], : got.shape[-1]])
        assert (np.abs(got.astype(np.float64) - ref) <= 4 * 2.0**-24 * mag).all()


@pytest.mark.parametrize("axis,eps", [(-1, 0.0), (0, 0.0), (-1, 4.0)], ids=["last", "first", "eps"])
def test_normalize_matches_jax(arrays, axis, eps):
    v = arrays["points"][0]  # [50, 3]
    if axis == 0:
        v = np.ascontiguousarray(v.T)  # [3, 50]
    ref = jxm.normalize(jnp.asarray(v), axis=axis, eps=eps)
    got = txm.normalize(torch.from_numpy(v), axis=axis, eps=eps)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_default_transforms_match_jax():
    for ours, theirs in zip(tp.scene.default_transforms(5), dxr.scene.default_transforms(5)):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    cfg = tp.RendererConfig(width=64, height=32)
    state = tp.make_scene(tp.build_scene_geometry([tp.procedural.cube(1.0)] * 3), cfg, device="cpu")
    np.testing.assert_array_equal(state.position.numpy(), tp.scene.default_transforms(3)[0])


def test_rasterize_matches_jax():
    cfg = dxr.RendererConfig(width=128, height=64, use_pallas=False)
    geo = dxr.build_scene_geometry(dxr.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = dxr.animate(dxr.make_scene(geo, cfg, placement="grid"), 0.5, cfg)
    tris, _ = jax_setup(state, cfg)
    ref = jax_rasterize(tris, cfg)
    got = rasterize(TriSetup(*(torch.from_numpy(np.array(a)) for a in tris)),
                    tp.RendererConfig(**dataclasses.asdict(cfg)))
    for name, g, r in zip(ref._fields, got, ref):
        if name in ("depth", "mesh_id"):
            np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(r).view(np.int32))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=4.8e-7)
    assert (got.mesh_id.numpy() >= 0).mean() > 0.3


def test_heaviest_files_come_first(request):
    """Every entry of HEAVIEST_FIRST names a file under tests/ and, for an
    entry "file::test", a test defined in that file, so a renamed or moved
    test fails here.  The second half, that the session's listed work units
    come first and in the list's order, holds trivially when only some files
    run; it shows only that the sort ran, not that the list holds every heavy
    unit."""
    root = request.config.rootpath
    schedule = request.config.pluginmanager.get_plugin(str(root / "conftest.py"))
    missing = []
    for entry in schedule.HEAVIEST_FIRST:
        file, _, test = entry.partition("::")
        path = root / schedule.TESTS / file
        if not path.is_file() or (test and f"def {test}(" not in path.read_text()):
            missing.append(entry)
    assert not missing, f"HEAVIEST_FIRST lists what is not under tests/: {missing}"
    rank = {entry: i for i, entry in enumerate(schedule.HEAVIEST_FIRST)}
    ranks = [rank.get(schedule.work_unit(item.nodeid), len(rank)) for item in request.session.items]
    assert ranks == sorted(ranks), "the listed work units are not first, in the list's order"
