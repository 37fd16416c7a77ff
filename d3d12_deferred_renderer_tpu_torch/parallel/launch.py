"""Run N ranks of the multi-device paths on one host.

``run_bands(n, job, args, device)`` spawns n processes (torch.multiprocessing,
spawn method; on the card unless the caller passes device="cpu"), joins
them in one group (mesh.make_rows_group, at a free localhost port) and
runs ``job(device, *args)`` in each, the rank's device first; it returns
each rank's result in rank order.  A job that needs more axes than the row
bands lays the group out with mesh.make_mesh itself.  A job returns host
objects (numpy arrays, numbers): results come back pickled.  A spawned
rank imports the module that defines its job, so a job lives in a module
that imports no JAX (this one, parallel/dryrun.py, or the script that runs
the ranks).

Every wait has a deadline: a rank that raises, dies or is still running
when ``timeout_s`` has passed fails the call, and every rank still alive
is killed before it returns.

The jobs the tests run, each on scenes carried as convert.py's arrays:
``sharded_frames`` (render_sharded), ``mesh_frames`` (render_tri_sharded and
the two batch entry points on a mesh of the job's axes) and ``tri_planes``
(the triangle shards' composited fragment planes); on the card
``captured_and_eager`` holds the entry points' rank programs to their eager
bodies and ``refusal`` reports what render_sharded refuses; ``mesh_lines``
reports a mesh's axis groups, ``run_calls`` runs several jobs in one group
and ``counted`` a job with the kernels' launch counts.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import make_rows_group, rank_device


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, kind, job, args, results, timeout_s):
    try:
        device = rank_device(kind, rank, n)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:  # ranks on the CPU share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        make_rows_group(rank, n, f"tcp://localhost:{port}", device, timeout_s)
        try:
            results.put((rank, True, job(device, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: report to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_bands(n: int, job, args=(), device: str = "cuda", timeout_s: float = 300.0) -> list:
    """job(device, *args) in each of n band ranks -> [result of rank 0, ...].
    device "cuda", the default (a card per rank and NCCL when there are
    enough cards, else every rank on card 0 and gloo), or "cpu" (gloo).
    Raises RuntimeError, before it spawns a rank, where the card is asked
    for and there is none (it never falls back to the CPU); RuntimeError
    when a rank fails or dies, TimeoutError past timeout_s."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the band ranks run on the GPU by default; "
            "pass device=\"cpu\" to run them on the CPU"
        )
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, device, job, tuple(args), results, timeout_s),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failed = {}, []
    try:
        while len(got) < n and not failed:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failed.append(f"band ranks {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"band ranks {sorted(set(range(n)) - set(got))} still running "
                                       f"after {timeout_s} s")
                continue
            if ok:
                got[rank] = value
            else:
                failed.append(f"band rank {rank} of {n} raised:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if not failed else 1.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [got[r] for r in range(n)]


def sharded_frames(device, scenes):
    """The band job of the tests: render_sharded of each (arrays, cfg) in
    turn, the scene carried as convert.py's arrays -> [(uint8 frame [H, W,
    3] as numpy, summed overflow), ...]."""
    from ..convert import scene_from_arrays
    from .sharded import render_sharded

    out = []
    for arrays, cfg in scenes:
        frame, stats = render_sharded(scene_from_arrays(arrays, device), cfg, return_stats=True)
        out.append((frame.cpu().numpy(), int(stats["overflow"])))
    return out


def mesh_frames(device, items):
    """The mesh job of the tests: each (arrays, cfg, axis sizes, axis names,
    entry, keywords) in turn on a mesh of those axes, entry "tri"
    (render_tri_sharded), "frames" (render_frames_batch_sharded) or
    "tri_frames" (render_frames_batch_tri_sharded); a batch entry's clocks
    come as keywords["times"], a list of floats -> [(uint8 frame [H, W, 3]
    or batch [B, H, W, 3] as numpy, summed overflow), ...]."""
    from ..convert import scene_from_arrays
    from . import sharded
    from .mesh import make_mesh

    entries = {"tri": sharded.render_tri_sharded, "frames": sharded.render_frames_batch_sharded,
               "tri_frames": sharded.render_frames_batch_tri_sharded}
    out = []
    for arrays, cfg, sizes, names, entry, kw in items:
        mesh = make_mesh(sizes, names)
        state = scene_from_arrays(arrays, device)
        kw = dict(kw)
        times = kw.pop("times", None)
        args = (state, cfg, mesh) if times is None else (
            state, torch.tensor(times, dtype=torch.float32, device=device), cfg, mesh)
        frames, stats = entries[entry](*args, return_stats=True, **kw)
        out.append((frames.cpu().numpy(), int(stats["overflow"])))
    return out


def _entry_call(state, cfg, entry, mesh, kw, start, eager=False):
    """One call of multi-device entry `entry` ("sharded", "tri", "frames" or
    "tri_frames"; on `mesh` but "sharded"), captured on the card or eager,
    at clock `start` (a batch entry: keywords["frames"] clocks of
    animation_times from it) -> (uint8 frames, int32 overflow)."""
    from . import sharded

    fns = {"sharded": (sharded.render_sharded, sharded._render_sharded_eager),
           "tri": (sharded.render_tri_sharded, sharded._render_tri_sharded_eager),
           "frames": (sharded.render_frames_batch_sharded, sharded._render_frames_batch_sharded_eager),
           "tri_frames": (sharded.render_frames_batch_tri_sharded, sharded._render_frames_batch_tri_sharded_eager)}
    fn = fns[entry][int(eager)]
    kw = dict(kw)
    n_frames = kw.pop("frames", None)
    if entry == "sharded":
        out, stats = fn(sharded._with_time(state, start), cfg, return_stats=True)
    elif n_frames is None:
        out, stats = fn(sharded._with_time(state, start), cfg, mesh, return_stats=True, **kw)
    else:
        times = sharded.animation_times(start, n_frames, device=state.time.device)
        out, stats = fn(state, times, cfg, mesh, return_stats=True, **kw)
    return out, stats["overflow"]


def captured_and_eager(device, items):
    """The captured entry points against their eager bodies: each (arrays,
    cfg, axis sizes, axis names, entry, keywords, clocks) -> {"equal": at
    each clock the captured frames torch.equal to the eager ones and the
    overflow counts equal, "overflow": the captured counts, "kept": the
    first call's frames unchanged after the later calls, "graphs" and
    "collectives": the program's counts}; the programs are dropped after
    each item."""
    from ..convert import scene_from_arrays
    from . import sharded
    from .mesh import make_mesh

    out = []
    for arrays, cfg, sizes, names, entry, kw, clocks in items:
        state = scene_from_arrays(arrays, device)
        mesh = None if entry == "sharded" else make_mesh(sizes, names)
        sharded._programs.clear()
        equal, overflow, first = [], [], None
        for t in clocks:
            got, g_ovf = _entry_call(state, cfg, entry, mesh, kw, t)
            want, e_ovf = _entry_call(state, cfg, entry, mesh, kw, t, eager=True)
            equal.append(bool(torch.equal(got, want)) and int(g_ovf) == int(e_ovf))
            overflow.append(int(g_ovf))
            if first is None:
                first = (got, got.clone())
        (prog,) = sharded._programs.values()
        out.append({"equal": equal, "overflow": overflow, "kept": bool(torch.equal(*first)),
                    "graphs": prog.graphs, "collectives": len(prog.collectives)})
        sharded._programs.clear()
    return out


def refusal(device, arrays, cfg):
    """render_sharded of the scene on this rank -> the message of the
    NotImplementedError it raises, None where it raises nothing; no rank
    program is made either way."""
    from ..convert import scene_from_arrays
    from . import sharded

    try:
        sharded.render_sharded(scene_from_arrays(arrays, device), cfg)
    except NotImplementedError as e:
        assert not sharded._programs
        return str(e)
    return None


def tri_planes(device, items):
    """The composited fragment planes of the triangle shards: each (arrays,
    cfg, axis sizes, axis names, tri axis, rows axis) -> [H, W, 7] float32
    numpy (depth, normal xyz, u, v, mesh id; sharded._stack_planes), every
    rank's sub-band gathered in band order."""
    from ..convert import scene_from_arrays
    from . import sharded
    from .mesh import make_mesh

    out = []
    for arrays, cfg, sizes, names, tri_axis, rows_axis in items:
        plan = sharded._tri_plan(cfg, *sharded._tri_handles(make_mesh(sizes, names), tri_axis, rows_axis))
        _, _, merged = sharded._render_tri_band(scene_from_arrays(arrays, device), cfg, plan)
        out.append(plan.axes.all_gather_tiled(sharded._stack_planes(merged)).cpu().numpy())
    return out


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port; each counts its kernel's launches
    in its ``launches`` attribute."""
    from ..ops import bump, fused, lighting_cuda, raster_tiles, scatter, setup_cuda

    return (setup_cuda.setup_triangles, fused.fused_tiles, raster_tiles.raster_tiles, lighting_cuda.shade_tiles,
            setup_cuda.setup_depth_triangles, raster_tiles.raster_depth, bump.bump_tiles,
            fused.directional_resolve, scatter.row_scatter)


def counted(device, job, args=()):
    """job(device, *args) with every kernel's launch count set to 0 just
    before it and read just after -> (its result, {wrapper: launches})."""
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    out = job(device, *args)
    return out, {w.__name__: w.launches for w in wrappers}


def run_calls(device, calls):
    """Several jobs in one group of ranks: each (job, args) in turn ->
    [job(device, *args), ...]."""
    return [job(device, *args) for job, args in calls]


def mesh_lines(device, sizes, names):
    """This rank's coordinates on make_mesh(sizes, names) and, for each
    axis, the ranks of its line as the axis group gathers them -> (coords,
    {name: [rank, ...]})."""
    from .mesh import make_mesh
    from .sharded import BandGroup

    mesh = make_mesh(sizes, names)
    me = torch.tensor([dist.get_rank()], device=device)
    return mesh.coords, {n: BandGroup.of_axis(mesh, n).all_gather_tiled(me).tolist() for n in names}
