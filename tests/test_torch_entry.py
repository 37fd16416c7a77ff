"""PyTorch port: the entry points' shared contracts on the CPU.

* Every entry point takes the shadow window gather (shadow_window_gather)
  and renders with it the frames it renders without it.
* Instancing (the JAX contract of tests/test_instancing.py): the port
  builds the columns of an instanced geometry as JAX does, and renders it
  as the duplicated geometry.
* The overflow warning of render: JAX's message on a frame that overflows
  a capacity cap, none on a frame that does not.

(Split from tests/test_torch_frame.py.)
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu as dxr

import d3d12_deferred_renderer_tpu_torch as tp

JCFG = dataclasses.replace(dxr.FLAGSHIP_CONFIG, width=256, height=64, fused=True)
TCFG = tp.RendererConfig(**dataclasses.asdict(JCFG))


def _port_scene():
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    return tp.make_scene(
        geo, TCFG, lights=tp.random_point_lights(24, cfg=TCFG, radius=1.2, device="cpu"),
        placement="grid", materials=tp.Materials.varied(geo.num_meshes, device="cpu"),
        device="cpu",
    )


def _one_rank_mesh(*names):
    """A mesh of one rank on every axis: the collectives of a one-rank
    axis return their input, so no process group is needed."""
    from d3d12_deferred_renderer_tpu_torch.parallel.mesh import Mesh

    return Mesh(names, (1,) * len(names), (0,) * len(names), (None,) * len(names), False)


# entry point -> (call(state, cfg) -> uint8 frames, whether it takes the
# sparse PCF path: whole frames do; bands and triangle shards are dense, as
# in the JAX package).
WINDOW_ENTRY_POINTS = {
    "render": (lambda s, c: tp.render(s, c), True),
    "step_frame": (lambda s, c: tp.step_frame(s, c)[1], True),
    "render_batch": (lambda s, c: tp.render_batch(s, c, 1)[1], True),
    "render_sharded": (lambda s, c: tp.parallel.render_sharded(s, c), False),
    "render_tri_sharded": (lambda s, c: tp.parallel.render_tri_sharded(s, c, _one_rank_mesh("tri")), False),
    "render_frames_batch_sharded": (lambda s, c: tp.parallel.render_frames_batch_sharded(
        s, torch.tensor([0.25]), c, _one_rank_mesh("frame", "rows")), False),
    "render_frames_batch_tri_sharded": (lambda s, c: tp.parallel.render_frames_batch_tri_sharded(
        s, torch.tensor([0.25]), c, _one_rank_mesh("frame", "tri")), False),
}


@pytest.mark.parametrize("entry", list(WINDOW_ENTRY_POINTS))
def test_entry_points_take_the_window_gather(entry, monkeypatch):
    """Every entry point renders with shadow_window_gather (the window-gather
    PCF, the last branch the port lacked) the frames it renders without it:
    through the window rows on whole frames, per pixel on bands and
    triangle shards."""
    from d3d12_deferred_renderer_tpu_torch.ops import shadows
    from d3d12_deferred_renderer_tpu_torch.parallel import sharded

    call, sparse = WINDOW_ENTRY_POINTS[entry]
    monkeypatch.setattr(sharded.BandGroup, "of", staticmethod(lambda group=None: sharded.BandGroup(None, 0, 1, False)))
    window_calls = []
    window_rows = shadows._pcf_window_rows
    monkeypatch.setattr(shadows, "_pcf_window_rows", lambda *a, **k: (window_calls.append(1), window_rows(*a, **k))[1])
    cfg = dataclasses.replace(TCFG, shadows=True, shadow_map_size=128)
    state = tp.animate(_port_scene(), 0.5, cfg)
    window = call(state, dataclasses.replace(cfg, shadow_window_gather=True))
    assert bool(window_calls) == sparse
    assert torch.equal(window, call(state, cfg))
    assert float((window.amax(-1) > 0).double().mean()) > 0.2


ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
INSTANCE_OF = [[1, 0], [0, 1, 0, 1, 0]]


def _pools():
    """The cube + pyramid pool, loaded by each package's Python OBJ loader."""
    names = ("cube", "pyramid")
    return ([dxr.load_obj(os.path.join(ASSETS, f"{m}.obj"), prefer_native=False) for m in names],
            [tp.load_obj(os.path.join(ASSETS, f"{m}.obj")) for m in names])


@pytest.mark.parametrize("instance_of", INSTANCE_OF, ids=["1_0", "0_1_0_1_0"])
def test_instanced_geometry_identical(instance_of):
    """build_instanced_geometry gives JAX's arrays, and from_host the
    columns of JAX's GeometryBuffers.from_host (each logical vertex resolved
    through vertex_source)."""
    jpool, ppool = _pools()
    jg, pg = dxr.build_instanced_geometry(jpool, instance_of), tp.build_instanced_geometry(ppool, instance_of)
    for f in dataclasses.fields(pg):
        np.testing.assert_array_equal(getattr(pg, f.name), getattr(jg, f.name), err_msg=f.name)
    assert pg.num_vertices == jg.num_vertices and pg.num_triangles == jg.num_triangles
    jb, pb = dxr.scene.GeometryBuffers.from_host(jg), tp.GeometryBuffers.from_host(pg, device="cpu")
    for name in ("fv_pos_cols", "fv_nrm_cols", "fv_uv_cols", "tri_mesh_id"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)


def test_instanced_frame_matches_duplicated():
    """Five instances of a two-mesh pool render exactly as five duplicated
    meshes (the port's CPU frame, whole-frame reference raster)."""
    cfg = tp.RendererConfig(width=160, height=90, use_pallas=False)
    _, pool = _pools()
    instance_of = INSTANCE_OF[1]
    states = [tp.make_scene(g, cfg, device="cpu") for g in (
        tp.build_instanced_geometry(pool, instance_of), tp.build_scene_geometry([pool[k] for k in instance_of]))]
    frames = [tp.render(s, cfg) for s in states]
    assert torch.equal(frames[0], frames[1])
    assert (frames[0].amax(-1) > 0).double().mean() > 0.05


@pytest.mark.parametrize("cap", [1, 256], ids=["tiny_cap", "default_cap"])
def test_render_warns_on_overflow(cap, capsys):
    """With a tile cap of one triangle the frame overflows and render prints
    JAX's message with the count; at the default cap it prints nothing."""
    cfg = dataclasses.replace(tp.REFERENCE_CONFIG, width=256, height=64, max_tris_per_tile=cap)
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=8, segments=16))
    state = tp.make_scene(geo, cfg, placement="grid", device="cpu")
    overflow = int(tp.render_stats(state, cfg)[1]["overflow"])
    capsys.readouterr()
    tp.render(state, cfg)
    out = capsys.readouterr().out
    if cap == 1:
        assert overflow > 0
        assert out == tp.frame.OVERFLOW_WARNING.format(n=overflow) + "\n"
        assert f"capacity overflow on {overflow} tiles" in out
        tp.render(state, dataclasses.replace(cfg, overflow_warn=False))
        assert capsys.readouterr().out == ""
    else:
        assert overflow == 0 and out == ""
