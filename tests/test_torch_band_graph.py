"""PyTorch port: each rank's multi-device frame as one program
(parallel/program.py), on the CPU, ranks simulated by threads.

On the card the four multi-device entry points capture each rank's work
between two collectives as CUDA graphs and replay them with each recorded
collective run between two replays (held bit-equal to the eager bodies in
tests/test_torch_cuda.py and chip_smoke.py).  Here, with no graph:

* each path's plan: the order of its recorded collectives (band handle,
  operation) and the static shapes and dtypes of their buffers, the same
  on every rank;
* the program's run (each collective through Collective.run, as a replay
  runs it, into its static buffer) and the entry point on CPU tensors
  (which runs the eager body) bit-equal to the eager body;
* the refusals of the four entry points, raised before any collective:
  the axes' divisibility, the band heights a filter cannot take, and
  use_pallas=False on the card (ROADMAP.md Queue 1 item 7).

No JAX reference, no spawn.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import d3d12_deferred_renderer_tpu_torch as tp
from d3d12_deferred_renderer_tpu_torch.parallel import mesh, program, sharded

U8, F32, I32 = torch.uint8, torch.float32, torch.int32
BASE = tp.RendererConfig(width=128, height=32, shading="pbr", use_pallas=True)
TIMES = [0.25, 0.5]


class _ThreadGroup(sharded.BandGroup):
    """One axis of ranks simulated by threads: `group` is the shared
    (barrier, slots) pair of the axis's line of ranks.  Sums add in turn, as
    the backends do."""

    def _exchange(self, x):
        barrier, slots = self.group
        slots[self.index] = x.clone()
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def gather_stacked(self, x):
        return torch.stack(self._exchange(x))

    def sum(self, x):
        if self.total == 1:
            return x
        vals = self._exchange(x)
        return sum(vals[1:], vals[0])

    def min(self, x):
        return torch.stack(self._exchange(x)).amin(0) if self.total > 1 else x

    def sum_scatter(self, x):
        vals = self._exchange(x)
        return sum(vals[1:], vals[0]).chunk(self.total)[self.index] if self.total > 1 else x


def _thread_mesh(sizes, names, rank, lines):
    coords = mesh.mesh_coords(rank, sizes)
    return mesh.Mesh(tuple(names), tuple(sizes), coords, tuple(lines[(ax, rank)] for ax in range(len(sizes))), False)


def _run_ranks(sizes, names, fn):
    """fn(this rank's Mesh, whose groups are the shared exchanges of its
    axis lines) in a thread per rank -> results in rank order."""
    lines = {}
    for ax, size in enumerate(sizes):
        for line in mesh.axis_lines(sizes, ax):
            shared = (threading.Barrier(size, timeout=60), [None] * size)
            for r in line:
                lines[(ax, int(r))] = shared
    n = int(np.prod(sizes))
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(_thread_mesh(sizes, names, r, lines))
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)
            for shared in lines.values():
                shared[0].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a simulated rank is still waiting"
    if errors:
        raise errors[0]
    return out


@pytest.fixture
def thread_axes(monkeypatch):
    """BandGroup.of and BandGroup.of_axis give the simulated ranks' groups:
    of(group) takes the thread Mesh's only axis, of_axis its named one."""
    def of_axis(m, name):
        ax = m.axis(name)
        return _ThreadGroup(m.groups[ax], m.coords[ax], m.sizes[ax], m.staged)

    monkeypatch.setattr(sharded.BandGroup, "of_axis", staticmethod(of_axis))
    monkeypatch.setattr(sharded.BandGroup, "of", staticmethod(lambda m=None: of_axis(m, m.names[0])))


def _scene(cfg):
    geo = tp.build_scene_geometry(tp.procedural.benchmark_meshes(n=4, rings=6, segments=10))
    state = tp.make_scene(geo, cfg, lights=tp.random_point_lights(8, cfg=cfg, device="cpu"), placement="grid",
                          materials=tp.Materials.varied(geo.num_meshes, device="cpu"), device="cpu")
    return tp.animate(state, 0.5, cfg)


# Each path: (config changes, axis sizes, axis names, entry, keywords, the
# plan: (handle slot, op, input shape, result shape, dtype) in order).  The
# handle slots: render_sharded (rows); render_tri_sharded (tri, rows); the
# batches (frame, rows) and (frame, tri, rows).  A 32-row frame in bands of
# 16 (two 8-row tile rows) or sub-bands of 8; bloom gathers the
# 4x-downsampled field, FXAA each band's first and last rows; a gather
# lands stacked, one part a rank.
G = "gather_stacked"
PATHS = {
    "fused": (dict(fused=True), (2,), ("rows",), "render_sharded", {}, [
        (0, G, (16, 128, 3), (2, 16, 128, 3), U8),
        (0, "sum", (), (), I32)]),
    "fused_bloom_fxaa": (dict(fused=True, bloom=True, fxaa=True), (2,), ("rows",), "render_sharded", {}, [
        (0, G, (4, 32, 3), (2, 4, 32, 3), F32),
        (0, G, (2, 128, 3), (2, 2, 128, 3), F32),
        (0, G, (16, 128, 3), (2, 16, 128, 3), U8),
        (0, "sum", (), (), I32)]),
    "staged_bump_bloom": (dict(normal_mapping=True, bloom=True), (2,), ("rows",), "render_sharded", {}, [
        (0, G, (4, 32, 3), (2, 4, 32, 3), F32),
        (0, G, (16, 128, 3), (2, 16, 128, 3), U8),
        (0, "sum", (), (), I32)]),
    "tri": (dict(normal_mapping=True), (2,), ("tri",), "render_tri_sharded", dict(tri_axis="tri"), [
        (0, "min", (32, 128), (32, 128), F32),
        (0, "min", (32, 128), (32, 128), I32),
        (0, "sum_scatter", (32, 128, 7), (16, 128, 7), F32),
        (0, G, (16, 128, 3), (2, 16, 128, 3), U8),
        (0, "sum", (), (), I32)]),
    "frames_rows_fxaa": (dict(fxaa=True), (2, 2), ("frame", "rows"), "render_frames_batch_sharded",
                         dict(frame_axis="frame", rows_axis="rows", times=TIMES), [
        (1, G, (2, 128, 3), (2, 2, 128, 3), F32),
        (1, G, (1, 16, 128, 3), (2, 1, 16, 128, 3), U8),  # concatenated along the rows
        (0, G, (1, 32, 128, 3), (2, 1, 32, 128, 3), U8),  # along the frames
        (1, "sum", (), (), I32),
        (0, "sum", (), (), I32)]),
    # Two frames a rank: the program unrolls them, each with its composite.
    "frames_tri_rows": (dict(), (1, 2, 2), ("frame", "tri", "rows"), "render_frames_batch_tri_sharded",
                        dict(frame_axis="frame", tri_axis="tri", rows_axis="rows", times=TIMES), [
        *[(1, "min", (16, 128), (16, 128), F32),
          (1, "min", (16, 128), (16, 128), I32),
          (1, "sum_scatter", (16, 128, 7), (8, 128, 7), F32)] * 2,
        (1, G, (2, 8, 128, 3), (2, 2, 8, 128, 3), U8),  # tri (minor) first
        (2, G, (2, 16, 128, 3), (2, 2, 16, 128, 3), U8),
        (2, "sum", (), (), I32),
        (1, "sum", (), (), I32)]),
}

CALLS = {"render_sharded": sharded._sharded_call, "render_tri_sharded": sharded._tri_call,
         "render_frames_batch_sharded": sharded._frames_call,
         "render_frames_batch_tri_sharded": sharded._frames_tri_call}


def _args(entry, state, cfg, m, kw):
    kw = dict(kw)
    times = kw.pop("times", None)
    if times is None:
        return (state, cfg, m), kw
    return (state, torch.tensor(times, dtype=F32), cfg, m), kw


@pytest.mark.parametrize("path", list(PATHS))
def test_rank_program_plan_and_frames(path, thread_axes):
    """The plan is the same on every rank and pinned; the program's run and
    the entry point equal the eager body bit for bit, overflow 0."""
    changes, sizes, names, entry, kw, want = PATHS[path]
    cfg = dataclasses.replace(BASE, **changes)
    state = _scene(cfg)
    public = getattr(tp.parallel, entry)

    def rank(m):
        args, akw = _args(entry, state, cfg, m, kw)
        call = CALLS[entry](*args, **akw)
        eager = call.body_of_inputs(call.inputs(), call.handles)
        prog = program.RankProgram(call.body_of_inputs, call.inputs(), call.handles, entry)
        got = public(*args, **akw, return_stats=True)
        return eager, prog.outputs, (got[0], got[1]["overflow"]), prog.plan(), prog.graphs

    ranks = _run_ranks(sizes, names, rank)
    first = ranks[0][0]
    for eager, outputs, entry_out, plan, graphs in ranks:
        assert plan == want and graphs == 0
        for got in (eager, outputs, entry_out):
            assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    frames, overflow = first
    assert frames.dtype == U8 and int(overflow) == 0
    assert float((frames.amax(-1) > 0).double().mean()) > 0.1


class _NoCollective(sharded.BandGroup):
    """Rank 0 of `total`, failing the test at any collective."""

    def _fail(self, *a, **k):
        raise AssertionError("a collective ran before the refusal")

    gather_stacked = all_gather_tiled = sum = min = sum_scatter = _fail


# Each entry point: (config changes, axis sizes, keywords, a refusal).
REFUSALS = {
    "render_sharded": (dict(height=30), (4,), {}, "not divisible"),
    "render_tri_sharded": (dict(), (3,), dict(tri_axis="tri"), "triangle shards"),
    "render_frames_batch_sharded": (dict(bloom=True), (1, 16), dict(times=TIMES), "downsample"),
    "render_frames_batch_tri_sharded": (dict(normal_mapping=True, height=16), (1, 2, 2),
                                        dict(times=TIMES, rows_axis="rows"), "tile_h"),
}


@pytest.mark.parametrize("entry", list(REFUSALS))
def test_refusals_come_before_any_collective(entry, monkeypatch):
    """Each entry point raises its refusal, and on the card refuses
    use_pallas=False before warming up or capturing, naming ROADMAP.md
    Queue 1 item 7, both before any collective."""
    changes, sizes, kw, match = REFUSALS[entry]
    names = {1: ("rows",), 2: ("frame", "rows"), 3: ("frame", "tri", "rows")}[len(sizes)]
    if entry == "render_tri_sharded":
        names = ("tri",)
    m = mesh.Mesh(names, sizes, (0,) * len(sizes), (None,) * len(sizes), False)
    monkeypatch.setattr(sharded.BandGroup, "of_axis",
                        staticmethod(lambda m, name: _NoCollective(None, 0, m.sizes[m.axis(name)], False)))
    monkeypatch.setattr(sharded.BandGroup, "of", staticmethod(lambda group=None: _NoCollective(None, 0, sizes[0], False)))
    public = getattr(tp.parallel, entry)
    cfg = dataclasses.replace(BASE, **changes)
    state = tp.make_scene(tp.build_scene_geometry([tp.procedural.cube(1.0)]), BASE, device="cpu")
    args, akw = _args(entry, state, cfg, m, kw)
    with pytest.raises(ValueError, match=match):
        public(*args, **akw)
    # A config every axis divides, on a state taken for one on the card.
    ok = dict(height=32, width=128, bloom=False, normal_mapping=False)
    plain = dataclasses.replace(cfg, use_pallas=False, **ok)
    sizes = tuple(1 if s == 3 else s for s in sizes)
    m = m._replace(sizes=sizes)
    args, akw = _args(entry, state, plain, m, dict(kw, times=TIMES * 2) if "times" in kw else kw)
    monkeypatch.setattr(sharded, "_eager", lambda state: False)
    sharded._programs.clear()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        public(*args, **akw)
    assert not sharded._programs
